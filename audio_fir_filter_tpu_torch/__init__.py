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
- ``cli.py``: the ``lowcut`` command line (both scenarios), plus
  ``--device``.

The port imports ``torch`` and never ``jax``. It reuses the JAX package's
host-only modules that never import JAX: ``audio`` (containers, codec,
synthesis), ``native.pcm_codec`` and ``utils.errors`` / ``.options`` /
``.progress``.
"""

__version__ = "0.1.0"

from audio_fir_filter_tpu.utils.errors import (  # noqa: F401
    DiskerrorError,
    FileExists,
    FileNotFound,
    StopNoError,
    UsageError,
)
from audio_fir_filter_tpu.utils.options import FilterOptions  # noqa: F401

from .utils.device import resolve_device  # noqa: F401
