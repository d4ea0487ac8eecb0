"""audio_fir_filter_tpu_torch — the PyTorch/CUDA port of ``lowcut``.

A second package beside :mod:`audio_fir_filter_tpu` (the JAX reference,
unchanged). Module layout mirrors it so each module's counterpart is easy
to find:

- ``ops/``: float64 kernel design, the overlap-save plan, its engines
  and filters; the segment filter and the block convolution, whose CUDA
  kernels (``csrc/segment_filter.cu``, ``csrc/conv_blocks.cu``) replace the
  JAX package's Pallas ``pallas_segment_filter`` and
  ``pallas_conv_real_blocks``.
- ``models/``: the five windowed-sinc filter families and their plans.
- ``pipeline/``: segment streaming, the per-file pipeline, the pipelined
  batch and its resume manifest.
- ``parallel/``: the ("data", "time") mesh of ``(rank, device)`` cells,
  halo-exchange sharded filtering over ``torch.distributed``, the
  multi-process runtime helpers and the scaling harness.
- ``audio/``, ``native/``, ``utils/``: the host layer (containers, the PCM
  codec and its native build, synthesis; errors, options, progress), the
  port's own copies of the JAX package's modules of the same names;
  ``ops/oracle.py`` likewise.
- ``cli.py``: the ``lowcut`` command line (both scenarios, ``--mesh`` and
  the multi-process flags), plus ``--device`` and ``--profile``.
- ``bench.py``: the bench contract (``python3 -m
  audio_fir_filter_tpu_torch.bench``), one JSON result line.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package.
"""

__version__ = "0.1.0"

from .utils.errors import (  # noqa: F401
    DiskerrorError,
    FileExists,
    FileNotFound,
    StopNoError,
    UsageError,
)
from .utils.options import FilterOptions  # noqa: F401

from .utils.device import resolve_device  # noqa: F401
