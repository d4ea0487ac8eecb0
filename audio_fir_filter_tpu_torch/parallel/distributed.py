"""Multi-process runtime helpers.

Counterpart of ``audio_fir_filter_tpu/parallel/distributed.py`` over
``torch.distributed``:

- :func:`initialize`: joins the default process group, one process per
  host or per card. Collectives run over NCCL between cards and over gloo
  between CPU processes (or processes that share a card: NCCL takes one
  rank per card).
- :func:`shard_files`: batch mode shards *files* across processes: each
  process filters its own subset, with no traffic between them.
- Failure model: fail fast. A join that fails raises, and nothing here
  answers an error with "one process": a process that went on alone would
  filter every file of a shared batch. Re-running with the batch manifest
  (``pipeline/manifest.py``) resumes the remaining files.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# Seconds a join waits for the other processes before it fails.
JOIN_TIMEOUT_S = 300.0

# Whether this process asked to join a group (see :func:`process_info`).
_state = {"requested": False}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the default process group.

    ``coordinator_address`` is ``HOST:PORT`` of process 0 (or a full
    ``init_method`` URL such as ``file:///path``); with none, the standard
    ``env://`` variables are read. ``backend`` defaults to ``nccl`` when
    this process has a card and ``gloo`` otherwise; processes that share a
    card pass ``"gloo"``. A group that is already initialised is left as it
    is; every failure raises.
    """
    _state["requested"] = True
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["requested"] = False


def process_info() -> tuple[int, int]:
    """``(rank, world size)``: of the group when one is initialised,
    ``(0, 1)`` when this process never asked for one. After a request
    without a group (a failed join that the caller caught) it raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if _state["requested"]:
        raise RuntimeError("a process group was asked for but is not "
                           "initialised: the join failed or the group was "
                           "destroyed")
    return 0, 1


def shard_files(paths, process_index: int | None = None,
                process_count: int | None = None):
    """Deterministic round-robin assignment of files to this process."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    return [p for i, p in enumerate(paths) if i % process_count == process_index]
