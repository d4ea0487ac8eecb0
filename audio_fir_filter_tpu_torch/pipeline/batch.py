"""Pipelined batch execution: host worker threads around the device loop.

Counterpart of ``audio_fir_filter_tpu/pipeline/batch.py``. The batch
scenario (``lowcut [options] in1 in2 ... outdir``) is a three-stage
pipeline

    reader pool  ->  device filter (main thread, in argument order)  ->  writer pool

so the card never waits on the filesystem: file k+1 is being read and file
k-1 encoded and written while file k streams through the device. Reader
and writer threads handle numpy arrays only; every CUDA call stays on the
main thread.

Semantics kept from the JAX package (and the reference's serial loop):

- files are *filtered* strictly in argument order;
- per-file checks (FileNotFound / FileExists) happen at that file's turn;
- the first error aborts the rest of the batch after in-flight writes have
  drained, so the files before the error stay written; outputs are atomic
  (temp + rename), so an abort never leaves a partial file;
- duplicate output names serialize against the earlier write;
- one plan cache is shared across the batch: files at one sample rate
  reuse the designed kernel and its device spectrum.

Each file goes through the same design and filter steps as
:func:`.process_file.process_file` (the 16-bit-native route included), so
its output equals the single-file output.

A write error surfaces at the next file's turn (or at drain); no further
file is written after the error is seen.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import audio
from ..models import make_model
from ..utils.errors import FileExists
from ..utils.options import FilterOptions
from .process_file import design_plan, filter_and_normalize, stage

# Files decoded ahead of the device. Bounded so a batch of hour-long files
# holds at most PREFETCH + 2 decoded buffers in host memory.
PREFETCH = 3


def run_batch(inputs, dest_dir, opts: FilterOptions, *,
              overwrite: bool = False, manifest=None, metrics_cb=None,
              show_progress: bool = True, device="cuda") -> None:
    """Filter ``inputs`` into ``dest_dir`` on ``device`` through the
    three-stage pipeline.

    ``metrics_cb(metrics_dict, dest_path)`` is invoked per completed file
    (from a writer thread, serialized by an internal lock); the dict holds
    each stage's host seconds (read, design, filter, normalize, write).
    ``manifest`` is an optional :class:`.manifest.BatchManifest`; completed
    files are recorded after their write lands and already-done files are
    skipped.
    """
    inputs = [Path(p) for p in inputs]
    dest_dir = Path(dest_dir)
    workers = opts.resolved_num_threads()

    def show_status(msg: str) -> None:
        if opts.verbose:
            print(msg)

    model = make_model(opts.filter_type, opts.freq, opts.slope,
                       opts.freq_hi)  # shared plan cache across the batch
    read_pool = ThreadPoolExecutor(
        max(1, min(workers, PREFETCH)), thread_name_prefix="lowcut-read")
    write_pool = ThreadPoolExecutor(
        max(1, min(workers, 2)), thread_name_prefix="lowcut-write")
    emit_lock = threading.Lock()
    # dest path -> in-flight write future (duplicate input filenames must
    # serialize against the earlier write before their FileExists check).
    writes: dict[Path, object] = {}

    def write_task(dest_path: Path, data, filtered, input_path: Path,
                   metrics: dict) -> None:
        with stage(metrics, "write"):
            audio.write_audio(dest_path, data, samples=filtered)
        if manifest is not None:
            manifest.mark_done(input_path)
        if metrics_cb is not None:
            with emit_lock:
                metrics_cb(metrics, dest_path)

    def drain(raise_errors: bool) -> None:
        err = None
        for fut in list(writes.values()):
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001 — collect, re-raise first
                err = err or e
        writes.clear()
        if raise_errors and err is not None:
            raise err

    queue = collections.deque()  # (input_path, read_future | None=skipped)
    next_i = 0

    def pump() -> None:
        nonlocal next_i
        while next_i < len(inputs) and len(queue) < PREFETCH:
            ip = inputs[next_i]
            next_i += 1
            dest = dest_dir / ip.name
            if manifest is not None and manifest.is_done(ip) and dest.exists():
                queue.append((ip, None))
                continue
            # audio.read_audio raises the reference's FileNotFound itself;
            # it surfaces at this file's turn via fut.result().
            queue.append((ip, read_pool.submit(audio.read_audio, ip)))

    try:
        pump()
        while queue:
            ip, fut = queue.popleft()
            pump()  # keep the pipeline full while this file filters

            # Surface any completed write's error before starting more work.
            for d, wf in list(writes.items()):
                if wf.done():
                    wf.result()  # raises on write failure -> abort batch
                    del writes[d]

            if fut is None:
                show_status(f"Skipping (already done): {ip.name}")
                continue

            dest = dest_dir / ip.name
            if dest in writes:  # duplicate filename: wait for earlier write
                writes.pop(dest).result()
            if dest.exists() and not (overwrite or manifest is not None):
                raise FileExists(str(dest))

            metrics = {}
            with stage(metrics, "read"):  # ~0 when prefetched
                data = fut.result()  # FileNotFound/parse errors surface here

            print(f"Processing file: {ip.name}")
            show_status("Creating sinc kernel for this file's sample rate.")
            with stage(metrics, "design"):
                plan, precision = design_plan(model, data, opts, device,
                                              show_status)

            filtered, max_mag = filter_and_normalize(
                data, plan, precision, opts, metrics, show_status,
                show_progress)

            metrics.update(frames=data.num_frames, channels=data.num_channels,
                           sample_rate=data.fmt.sample_rate, peak=max_mag,
                           precision=precision)
            show_status("Writing output file.")
            writes[dest] = write_pool.submit(
                write_task, dest, data, filtered, ip, metrics)

        drain(raise_errors=True)
    except BaseException:
        # Abort the rest of the batch, but let in-flight writes land (the
        # files before the error stay written).
        drain(raise_errors=False)
        raise
    finally:
        read_pool.shutdown(wait=False, cancel_futures=True)
        write_pool.shutdown(wait=True)
