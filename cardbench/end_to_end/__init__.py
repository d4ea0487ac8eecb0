"""End-to-end metric readers: ``cardbench/end_to_end/<metric>.py``."""
