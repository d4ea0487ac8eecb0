"""``lowcut`` command line of the PyTorch/CUDA port.

The parser surface, help text, error texts and exit codes of
``audio_fir_filter_tpu/cli.py`` (0 for --help, 1 for any error), for both
scenarios: ``lowcut [options] <input_file> <output_file>`` and the batch
``lowcut [options] <in1> [in2 ...] <output_directory>`` (with
``--resume``). One option is the port's own: ``--device {cuda,cpu}``
(default ``cuda``). With ``cuda`` and no card the run fails with a clear
message; it never falls back to the CPU.

``--engine``: ``auto`` and ``pallas`` run the segment kernel; ``fourstep``,
``pease`` and ``stockham`` run the generic block path, one block kernel
for all three.

``--profile DIR``: a ``torch.profiler`` trace of the whole run (CPU
activity, plus CUDA activity on the card), written to
``DIR/trace.json`` (Chrome trace format) when the run ends, on the error
path too. The program's spans (``utils/spans``) show in it as
``lowcut.<name>`` beside the kernels they launched: each file's stages
(``lowcut.stage.read`` ... ``lowcut.stage.write``), each filter call and
the segment kernel's wrapper. ``--json-metrics`` prints the stages' host
seconds, read from the same spans.

``--mesh DxT``: shard channels over D and the sample axis over T of this
process's devices (on ``--device cuda`` its cards, on ``--device cpu`` D*T
CPU cells). ``1x1`` is the single device and takes the same route as no
``--mesh`` at all; a larger mesh filters in float32 and runs a batch as a
serial per-file loop (the mesh owns the parallelism), as the JAX package
does. More cells than devices is an error.

``--coordinator HOST:PORT --num-processes N --process-id I``: join a
``torch.distributed`` group before any device work; a batch's files are
then dealt round-robin to the processes. A join that fails exits 1 before
any file is touched.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

from .utils.errors import (DiskerrorError, FileExists, FileNotFound,
                           StopNoError, UsageError)
from .utils.options import FilterOptions

HELP_TEXT = """\
Applies low-cut (high-pass) FIR filter to WAVE or AIFF file.
Usage:
  lowcut [options] <input_file> <output_file>
  lowcut [options] <input_file1> [input_file2 ...] <output_directory>
"""


class _Parser(argparse.ArgumentParser):
    """argparse that raises UsageError (exit 1) instead of exiting with 2."""

    def error(self, message):
        raise UsageError(message)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog="lowcut",
        description=HELP_TEXT,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-f", "--frequency", type=float, default=15.0, metavar="Hz",
                   help="Filter cutoff frequency in Hz. (default: 15)")
    p.add_argument("-s", "--slope", type=float, default=10.0, metavar="Hz",
                   help="Filter slope width in Hz. (default: 10)")
    p.add_argument("-n", "--normalize", action="store_true",
                   help="Normalize output to maximum level.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose output.")
    p.add_argument("-t", "--threads", type=int, default=0, metavar="N",
                   help="Number of host worker threads "
                        "(default is 2/3 of the processors available).")
    p.add_argument("-O", "--overwrite", action="store_true",
                   help="Overwrite existing files.")
    p.add_argument("--filter", dest="filter_type", default="lowcut",
                   choices=["lowcut", "highpass", "lowpass", "bandpass",
                            "bandreject"],
                   help="Filter family (windowed-sinc). 'lowcut' is the "
                        "reference behavior; band filters take -f as the "
                        "low edge and --frequency-high as the high edge. "
                        "(default: lowcut)")
    p.add_argument("-F", "--frequency-high", type=float, default=None,
                   metavar="Hz",
                   help="Band high edge in Hz (bandpass/bandreject only).")
    p.add_argument("--precision", choices=["auto", "high", "fast"],
                   default="auto",
                   help="Convolution precision: 'high' = float64 FFT "
                        "(matches float64 reference within 1 LSB @ 24-bit), "
                        "'fast' = float32 FFT (within 1 LSB @ 16-bit), "
                        "'auto' = 'fast' for <= 16-bit PCM outputs, 'high' "
                        "otherwise. (default: auto)")
    p.add_argument("--block-size", type=int, default=0, metavar="B",
                   help="Overlap-save FFT size (power of two; 0 = auto).")
    p.add_argument("--engine",
                   choices=["auto", "pallas", "fourstep", "pease", "stockham"],
                   default="auto",
                   help="Convolution engine: 'pallas' = the whole-segment "
                        "kernel; 'fourstep', 'pease' and 'stockham' = the "
                        "generic block path (one block-convolution kernel "
                        "for all three). Each runs its CUDA kernel on the "
                        "card and its plain PyTorch version on the CPU. "
                        "'auto' = pallas. (default: auto)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device to filter on: 'cuda' = the CUDA card (an "
                        "error if none is available), 'cpu' = the CPU. "
                        "(default: cuda)")
    p.add_argument("--mesh", type=str, default=None, metavar="DxT",
                   help="Device mesh shape data x time, e.g. 1x8: shard the "
                        "sample axis across T devices (halo exchange) and "
                        "channels across D devices. Default: single device.")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="Multi-host: coordinator address (process 0's host).")
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="Multi-host: total number of processes.")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="Multi-host: this process's index (0-based).")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Write a torch.profiler trace of the run to "
                        "DIR/trace.json (Chrome trace format).")
    p.add_argument("--json-metrics", action="store_true",
                   help="Print per-stage timing metrics as JSON to stderr.")
    p.add_argument("--resume", action="store_true",
                   help="Batch mode: keep a manifest in the destination "
                        "directory and skip files already completed by a "
                        "previous (possibly failed) run with the same "
                        "filter settings.")
    p.add_argument("paths", nargs="*", help=argparse.SUPPRESS)
    return p


def _parse_mesh(spec: str | None):
    if spec is None:
        return None
    try:
        d, t = spec.lower().split("x")
        shape = (int(d), int(t))
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError
        return shape
    except ValueError:
        raise UsageError(f"--mesh expects DxT (e.g. 1x8), got {spec!r}") from None


TRACE_NAME = "trace.json"


@contextlib.contextmanager
def _profiled(directory: str, device: str):
    """A ``torch.profiler`` trace of the body: CPU activity always, CUDA
    activity when the device is the card. Exported to
    ``directory/trace.json`` when the body ends, whether or not it
    raised."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(str(out / TRACE_NAME))


def _options_from_args(args) -> FilterOptions:
    return FilterOptions(
        freq=args.frequency,
        slope=args.slope,
        filter_type=args.filter_type,
        freq_hi=args.frequency_high,
        normalize=args.normalize,
        verbose=args.verbose,
        num_threads=args.threads,
        precision=args.precision,
        engine=args.engine,
        block_size=args.block_size,
        mesh_shape=_parse_mesh(args.mesh),
        json_metrics=args.json_metrics,
    )


def _emit_metrics(metrics: dict, path, args) -> None:
    if args.json_metrics:
        import json

        payload = {"file": str(path), "device": args.device, **metrics}
        fr, fs = metrics.get("frames", 0), metrics.get("filter", 0.0)
        if fs > 0:
            payload["samples_per_sec"] = fr * metrics.get("channels", 1) / fs
        print(json.dumps(payload), file=sys.stderr)


def run(argv=None) -> None:
    """Scenario logic (raises typed exceptions; `main` maps to exit codes)."""
    args = build_parser().parse_args(argv)

    if args.filter_type in ("bandpass", "bandreject"):
        if args.frequency_high is None:
            raise UsageError(
                f"--filter {args.filter_type} requires --frequency-high.")
        if args.frequency_high <= args.frequency:
            raise UsageError(
                "--frequency-high must exceed --frequency "
                f"({args.frequency_high} <= {args.frequency}).")
    elif args.frequency_high is not None:
        raise UsageError(
            "--frequency-high only applies to --filter bandpass/bandreject.")

    opts = _options_from_args(args)
    if opts.verbose:
        print(f"Using {opts.resolved_num_threads()} threads.")

    if (args.coordinator is None and args.num_processes is None
            and args.process_id is None):
        return _run_profiled(args, opts)
    # Multi-process launch: join the group before any device work. A join
    # that fails raises here, before any file is touched.
    from .parallel import distributed

    try:
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id,
                               backend="gloo" if args.device == "cpu" else None)
        if opts.verbose:
            pi, pc = distributed.process_info()
            print(f"Joined distributed runtime: process {pi}/{pc}.")
        _run_profiled(args, opts)
    finally:
        distributed.shutdown()


def _run_profiled(args, opts: FilterOptions) -> None:
    if not args.profile:
        return _run_scenario(args, opts)
    with _profiled(args.profile, args.device):
        if opts.verbose:
            print(f"Profiling to {args.profile} (torch.profiler trace).")
        _run_scenario(args, opts)


def _run_scenario(args, opts: FilterOptions) -> None:
    paths = [Path(s) for s in args.paths]
    # The pipeline is imported in each branch, after its usage checks, so
    # --help and usage errors pay no torch start-up.
    if len(paths) == 2:
        # Scenario 1: input file -> output file.
        input_path, output_path = paths
        if not input_path.is_file():
            raise FileNotFound(str(input_path))
        if output_path.exists() and output_path.is_dir():
            raise UsageError(
                "With two parameters the second parameter must be a file path, "
                "not a directory.")
        if input_path.suffix != output_path.suffix:
            raise UsageError(
                "Input and output file types (WAVE or AIFF) must be the same "
                "(extensions must match).")
        if output_path.exists() and not args.overwrite:
            raise FileExists(str(output_path))

        from .pipeline import process_file
        from .utils.device import resolve_device

        device = resolve_device(args.device)
        if output_path.exists():
            os.remove(output_path)
        metrics = process_file(input_path, output_path, opts, device=device)
        _emit_metrics(metrics, output_path, args)

    elif len(paths) > 2:
        # Scenario 2: input files -> output directory.
        dest_dir = paths[-1]
        if dest_dir.exists():
            if not dest_dir.is_dir():
                raise UsageError(
                    f"Destination exists but is not a directory: {dest_dir}")
        elif dest_dir.suffix:
            raise UsageError(
                f"Destination directory '{dest_dir}' does not exist and "
                f"has a suffix. Undefined scenario.")

        from .parallel.distributed import shard_files
        from .pipeline import process_file
        from .pipeline.batch import run_batch
        from .pipeline.manifest import BatchManifest, options_fingerprint
        from .utils.device import resolve_device

        device = resolve_device(args.device)
        if not dest_dir.exists():
            if opts.verbose:
                print(f"Creating directory: {dest_dir}")
            dest_dir.mkdir(parents=True, exist_ok=True)  # processes race
        manifest = (BatchManifest(dest_dir, options_fingerprint(opts, device))
                    if args.resume else None)
        # A multi-process batch deals the files round-robin: each process
        # filters its own, with no traffic between them.
        inputs = shard_files(paths[:-1])
        if not opts.sharded():
            # Pipelined batch: host reader/writer threads (the -t pool)
            # overlap file I/O with the device loop.
            run_batch(inputs, dest_dir, opts, overwrite=args.overwrite,
                      manifest=manifest, device=device,
                      metrics_cb=(lambda m, d: _emit_metrics(m, d, args))
                      if args.json_metrics else None)
            return
        # Sharded filtering keeps the serial per-file loop (the mesh owns
        # the parallelism; no point pipelining around it).
        for input_path in inputs:
            if not input_path.is_file():
                raise FileNotFound(str(input_path))
            dest_path = dest_dir / input_path.name
            if (manifest is not None and manifest.is_done(input_path)
                    and dest_path.exists()):
                if opts.verbose:
                    print(f"Skipping (already done): {input_path.name}")
                continue
            if dest_path.exists() and not (args.overwrite or args.resume):
                raise FileExists(str(dest_path))
            if dest_path.exists():
                os.remove(dest_path)
            metrics = process_file(input_path, dest_path, opts, device=device)
            _emit_metrics(metrics, dest_path, args)
            if manifest is not None:
                manifest.mark_done(input_path)

    else:
        raise UsageError("Invalid number of parameters. Need at least 2.")


def main(argv=None) -> int:
    """Entry point: exceptions map to exit codes as in the JAX package."""
    try:
        run(argv)
    except StopNoError as e:
        msg = str(e)
        if msg:
            print(msg)
        return 0
    except SystemExit as e:  # argparse --help exits 0
        return int(e.code or 0)
    except DiskerrorError as e:
        print(e, file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — every error is exit code 1
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
