"""Per-layer metric readers: ``cardbench/layer_metrics/<metric>.py``, the
metric's name with ``.`` and ``-`` written ``_``."""
