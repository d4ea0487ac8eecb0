"""cardbench: the benchmark of ``audio_fir_filter_tpu_torch`` on one card.

``python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; see README.md."""
