"""Traffic kinds: ``cardbench/traffic/<kind>.py``, named by a cell's file."""
