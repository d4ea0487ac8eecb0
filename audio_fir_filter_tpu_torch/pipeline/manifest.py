"""Resumable batch manifest.

Counterpart of ``audio_fir_filter_tpu/pipeline/manifest.py``, with the
same file name and format: outputs are written atomically (temp + rename),
and each finished input is recorded in ``.lowcut_manifest.json`` in the
destination directory, so a rerun with ``--resume`` skips completed files.
The manifest is the checkpoint; there is no other state.

Its fingerprint is the port's own (:func:`options_fingerprint`): a manifest
written by the JAX package, or by the port with other output-relevant
settings, never makes the port skip a file.

Several processes of one batch (``--num-processes``) share the manifest, so
a write merges: under an exclusive ``flock`` on ``.lowcut_manifest.json.lock``
beside it, it reads the file again, takes the union of its ``done`` entries
with the same fingerprint and its own, and replaces the file with the
union. The JAX package rewrites the file from its own entries, and the last
of several writers drops the others' (a rerun then filters those files
again); the port does not copy that.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile
import threading
from pathlib import Path

import torch

from ..ops.overlap_save import resolve_engine

MANIFEST_NAME = ".lowcut_manifest.json"
# First entry of every fingerprint of this package.
FINGERPRINT_TAG = "audio_fir_filter_tpu_torch"


class BatchManifest:
    """Thread-safe: ``mark_done`` is called from the batch pipeline's
    writer threads (pipeline/batch.py)."""

    def __init__(self, dest_dir: Path, options_fingerprint: str):
        self.path = Path(dest_dir) / MANIFEST_NAME
        self.fingerprint = options_fingerprint
        self._lock = threading.Lock()
        self.done: dict[str, bool] = self._read()

    def _read(self) -> dict[str, bool]:
        """The ``done`` entries on disk under this fingerprint; none if the
        file is missing, corrupt or of other settings."""
        try:
            data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}  # no manifest yet, or a corrupt one: start fresh
        if data.get("options") != self.fingerprint:
            return {}
        return dict(data.get("done", {}))

    def is_done(self, input_path) -> bool:
        with self._lock:
            return self.done.get(str(input_path), False)

    def mark_done(self, input_path) -> None:
        with self._lock:
            self.done[str(input_path)] = True
            self._flush()

    def _flush(self) -> None:
        # Merge with what other processes wrote, then a unique temp name +
        # atomic replace, all under the lock file (the thread lock is held
        # by callers).
        lock = self.path.with_name(MANIFEST_NAME + ".lock")
        with open(lock, "a") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            self.done = {**self._read(), **self.done}
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=".lowcut_manifest_")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump({"options": self.fingerprint, "done": self.done},
                              f, indent=1)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise


def options_fingerprint(opts, device) -> str:
    """Stable fingerprint of everything that changes the output's bits:
    filter type, frequencies, slope, normalize, precision, block size, the
    resolved engine (``auto`` and ``pallas`` are one kernel), and the
    device type — the CPU's plain version and the card's kernels round
    differently. A resume that changes any of them must not mix outputs in
    one directory. The port has no environment knobs, so none appear.

    A mesh larger than 1x1 is carried too, by its shape: it filters in
    float32 whatever the source (no 16-bit-native route) and aligns its
    blocks per shard, so its bits may differ from the single device's and
    from another mesh's. ``--mesh 1x1`` is the single device, byte for
    byte, and shares the fingerprint of a run without ``--mesh``."""
    return json.dumps(
        [FINGERPRINT_TAG, opts.filter_type, opts.freq, opts.freq_hi,
         opts.slope, opts.normalize, opts.precision, opts.block_size,
         resolve_engine(opts.engine), torch.device(device).type]
        + ([list(opts.mesh_shape)] if opts.sharded() else [])
    )
