"""Card counterparts of the TPU probes and scripts in the repository's
``experiments/``.

One module per JAX script, under the same file name. The probes
(``dispatch_floor_probe``, ``dma_bw_micro``, ``copy_floor_probe``,
``fused_phase_decomp``, ``pallas_micro``, ``mosaic_stages``,
``mosaic_stages2``, ``fast_decomp_r05``) each hold a wrapper that launches
its CUDA probe kernel (``csrc/probe_floors.cu``, ``probe_phases.cu``,
``probe_stages.cu``, ``probe_segment.cu``), the kernel's plain PyTorch
version, a ``launches`` counter, ``verify`` (the kernel against its plain
version on the card), ``run`` (the sweep) and ``main``:

    python -m audio_fir_filter_tpu_torch.experiments.fused_phase_decomp

Importing any of them needs no card and no ``nvcc``; a probe asked to run
on ``cuda`` without a card raises, and never falls back to the CPU. The
scripts (``segment_decomp``, ``chunk_sweep``, ``batch_cfg4``) time the
program's own kernels and CLI, and take ``--device cpu`` for a small run of
the plain versions whose host-clock times say that they are not card
times.
"""
