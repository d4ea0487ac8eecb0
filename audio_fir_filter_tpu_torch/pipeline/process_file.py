"""Per-file pipeline: read -> design -> filter on the device -> normalize
-> write.

Counterpart of ``audio_fir_filter_tpu/pipeline/process_file.py``, with the
same stage order, status lines and metrics keys:

- 16-bit PCM sources under ``fast`` precision without ``-n``, on the
  segment kernel's engine (``pallas``, what ``auto`` resolves to), take the
  16-bit-native route (int16 in and out of the kernel); if the output
  reaches the int16 rails the file is refiltered in float32, so the
  normalize-on-clip rule sees the unclipped peak.
- One common scale normalizes when the filtered peak exceeds full scale,
  or on ``-n``: ``(max_mag > 1.0 or -n) and max_mag > 0``.
- ``opts.mesh_shape`` (``--mesh DxT``): a 1x1 mesh is the single device, so
  it takes exactly the route above and writes the same bytes. A larger
  mesh shards every segment over this process's devices
  (:func:`.stream.sharded_filter_streamed`) in float32, as the JAX package
  does: it never takes the 16-bit-native route, so a 16-bit file's output
  may differ from the single-device output by a rounding tie (the kernel
  rounds its float32 result to int16 itself; the mesh path returns float32
  and the codec rounds).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from .. import audio
from ..audio.file import _scale_common
from ..audio.format import Encoding
from ..models import make_model
from ..ops import overlap_save as osv
from ..parallel.mesh import local_devices, make_mesh
from ..utils import spans
from ..utils.options import FilterOptions, resolve_precision
from ..utils.progress import ProgressBar
from .stream import (filter_array_streamed, filter_array_streamed_i16,
                     sharded_filter_streamed)


@contextlib.contextmanager
def stage(t: dict, name: str):
    """The body in the span ``stage.<name>`` (:func:`spans.timed`, recorded
    when recording is on); its host seconds go to ``t[name]``, which
    ``--json-metrics`` prints."""
    with spans.timed(f"stage.{name}") as s:
        yield
    t[name] = s.seconds


def _use_i16_route(opts, plan, data) -> bool:
    """The 16-bit-native route applies when it is exact: a plan that takes
    it (:func:`..ops.overlap_save.takes_i16`), a 16-bit PCM source (an
    exact int16 round trip) and no explicit normalize."""
    return (osv.takes_i16(plan)
            and not opts.normalize
            and data.fmt.encoding == Encoding.PCM_16)


def design_plan(model, data, opts: FilterOptions, device, show_status):
    """(plan, precision) for one file: ``auto`` precision resolved from the
    file's encoding, the plan from the model's cache."""
    precision = resolve_precision(opts.precision, data.fmt.encoding)
    if precision != opts.precision:
        show_status(f"Precision 'auto' -> '{precision}' for "
                    f"{data.fmt.encoding.bits}-bit output.")
    plan = model.plan(data.fmt.sample_rate, precision=precision,
                      block_size=opts.block_size, device=device,
                      engine=opts.engine)
    return plan, precision


def filter_and_normalize(data, plan, precision: str, opts: FilterOptions,
                         t: dict, show_status, show_progress: bool):
    """Filter one decoded file on the plan's device and apply the normalize
    rule, in the stages ``filter`` and ``normalize`` (:func:`stage`), and
    return ``(samples, peak)``. Shared by :func:`process_file` and the
    batch, so a file's output is the same either way."""
    show_status("Filtering.")
    total = data.num_frames * data.num_channels
    bar = ProgressBar(total, enabled=show_progress and sys.stdout.isatty())
    with stage(t, "filter"):
        filtered = max_mag = None
        if opts.sharded():
            rows, cols = opts.mesh_shape
            mesh = make_mesh((rows, cols),
                             local_devices(plan.device, rows * cols))
            filtered, max_mag = sharded_filter_streamed(
                data.samples, plan, mesh, progress_cb=bar.update)
        elif _use_i16_route(opts, plan, data):
            x16 = np.asarray(data.samples * np.float32(32768.0), np.int16)
            y16, peak16, saturated = filter_array_streamed_i16(
                x16, plan, progress_cb=bar.update)
            if saturated:
                show_status("Clipping detected; refiltering at float "
                            "precision for normalize.")
                bar.clear()
            else:
                filtered = np.asarray(y16, np.float32) / np.float32(32768.0)
                max_mag = peak16 / 32768.0
        if filtered is None:
            filtered, max_mag = filter_array_streamed(
                data.samples, plan, progress_cb=bar.update)
    bar.final()

    with stage(t, "normalize"):
        if (max_mag > 1.0 or opts.normalize) and max_mag > 0.0:
            show_status("Doing audio normalize.")
            filtered = _scale_common(filtered, max_mag)
    return filtered, max_mag


def process_file(input_path, output_path, opts: FilterOptions,
                 show_progress: bool = True, device="cuda") -> dict:
    """Filter one audio file on ``device``. Returns per-stage timing
    metrics (seconds: read, design, filter, normalize, write, the spans of
    :func:`stage`) plus frames, channels, sample_rate, peak and
    precision."""
    t = {}

    def show_status(msg: str) -> None:
        if opts.verbose:
            print(msg)

    show_status("Opening input file.")
    with stage(t, "read"):
        data = audio.read_audio(input_path)

    name = getattr(input_path, "name", None) or str(input_path).rsplit("/", 1)[-1]
    print(f"Processing file: {name}")

    show_status("Creating sinc kernel for this file's sample rate.")
    with stage(t, "design"):
        model = make_model(opts.filter_type, opts.freq, opts.slope,
                           opts.freq_hi)
        plan, precision = design_plan(model, data, opts, device, show_status)

    filtered, max_mag = filter_and_normalize(data, plan, precision, opts, t,
                                             show_status, show_progress)

    show_status("Writing output file.")
    with stage(t, "write"):
        audio.write_audio(output_path, data, samples=filtered)

    show_status("")
    t["frames"] = data.num_frames
    t["channels"] = data.num_channels
    t["sample_rate"] = data.fmt.sample_rate
    t["peak"] = max_mag
    t["precision"] = precision
    return t
