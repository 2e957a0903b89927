"""Multi-process scaling: a TCPStore rendezvous + the ordered sink.

The reference's parallelism is a pthread pool feeding one ordered writer
(Concurrency/SequenceProcessFramework.h:183-195: results are buffered and
written strictly in input order).  The multi-process equivalent here (the
JAX package's parallel/distributed.py with jax.distributed replaced by a
torch.distributed.TCPStore):

* each process joins the store that rank 0 hosts at host:port, takes a
  deterministic contiguous shard of the input reads, and runs the
  correction on its own device (several processes may share one card;
  the index is replicated per process, no cross-process traffic on the
  hot path);
* per-process outputs are written to rank-tagged part files;
* `merge_ordered_parts` concatenates them in rank order, which equals
  input order because the shards are contiguous -- the ordered sink;
* correction counters are summed through the store (`kv_counter_sum`) or
  with an all-reduce over a process group made on it
  (`global_counter_sum`: NCCL on CUDA, gloo on the CPU).

The store is the process's one rendezvous, as torch.distributed's default
process group (parallel.mesh.make_group, made on the store) is its one
group: `init` records it here.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

TIMEOUT_MS = 1_200_000

_runtime: dict = {}


def init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the TCPStore at coordinator (host:port); rank 0 hosts it."""
    host, port = coordinator.rsplit(":", 1)
    store = torch.distributed.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0,
        timeout=timedelta(milliseconds=TIMEOUT_MS), wait_for_workers=False)
    _runtime.update(store=store, num_processes=num_processes, process_id=process_id)


def joined() -> tuple[torch.distributed.Store, int, int]:
    """(store, num_processes, process_id) of init."""
    if "store" not in _runtime:
        raise RuntimeError("parallel.distributed.init was not called")
    return _runtime["store"], _runtime["num_processes"], _runtime["process_id"]


def shutdown() -> None:
    """Leave the process group and the store (rank 0's store closes)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _runtime.clear()


def rank_device(process_id: int, device: str) -> torch.device:
    """Rank r's device: cuda:{r % device_count()}, made current so that the
    kernels launch on its stream (several ranks may share a card), or the
    CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {process_id}: device {device!r} asked for, but there is "
                           "no CUDA card")
    dev = torch.device("cuda", process_id % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def shard_bounds(n_items: int, num_processes: int, process_id: int):
    """Contiguous per-host shard [lo, hi) — contiguity keeps rank-order
    concatenation equal to input order."""
    per = -(-n_items // num_processes)
    lo = min(process_id * per, n_items)
    return lo, min(lo + per, n_items)


def part_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.part{process_id:04d}"


def merge_ordered_parts(out_path: str, num_processes: int,
                        cleanup: bool = True) -> None:
    """Rank-0 ordered merge of part files (the multi-host ordered sink)."""
    with open(out_path, "wb") as out:
        for r in range(num_processes):
            p = part_path(out_path, r)
            with open(p, "rb") as fh:
                out.write(fh.read())
            if cleanup:
                os.remove(p)


def rank0_first(fn, name: str):
    """fn() on rank 0, then on the other ranks once rank 0's call has
    returned: first-use files (an index's pack, its walk tables) are
    written by one process.  A rank-0 failure fails every rank."""
    st, _, rank = joined()
    key = f"lrsc/first/{name}"
    if rank == 0:
        ok = False
        try:
            out = fn()
            ok = True
        finally:
            st.set(key, "ok" if ok else "failed")
        return out
    st.wait([key], timedelta(milliseconds=TIMEOUT_MS))
    if st.get(key) != b"ok":
        raise RuntimeError(f"rank 0 failed in {name}")
    return fn()


def kv_counter_sum(counters: np.ndarray, num_processes: int, process_id: int,
                   timeout_ms: int = TIMEOUT_MS) -> np.ndarray:
    """Sum per-process counter vectors through the store (no device
    collectives).

    The CLI uses this instead of an all-reduce because ranks finish their
    shards minutes apart (a cold kernel build, an uneven shard) and a
    collective's peer timeout is short; metrics reduction is not a hot
    path, so the store exchange (which also acts as the completion barrier
    for the ordered merge) is the robust choice.  Rank 0 hosts the store,
    so it returns only after every rank has read the sums."""
    st = joined()[0]
    timeout = timedelta(milliseconds=timeout_ms)
    payload = ",".join(repr(float(x)) for x in np.asarray(counters).ravel())
    st.set(f"lrsc/counters/{process_id}", payload)
    keys = [f"lrsc/counters/{r}" for r in range(num_processes)]
    st.wait(keys, timeout)
    total = np.zeros(len(counters), np.float64)
    for k in keys:
        total += np.array([float(x) for x in st.get(k).decode().split(",")])
    st.set(f"lrsc/summed/{process_id}", "1")
    if process_id == 0:
        st.wait([f"lrsc/summed/{r}" for r in range(num_processes)], timeout)
    return total


def global_counter_sum(counters: np.ndarray, device="cuda") -> np.ndarray:
    """Sum a per-process counter vector across every process (the metrics
    reduction of the reference's PostProcess sink): an all-reduce over
    mesh.make_group's group, on this rank's card (rank_device: NCCL) unless
    device is "cpu" (gloo)."""
    from .mesh import make_group  # mesh imports this module

    dev = rank_device(joined()[2], device)
    group = make_group(dev)
    t = torch.as_tensor(np.asarray(counters, np.float64), device=dev).clone()
    torch.distributed.all_reduce(t, group=group)
    return t.cpu().numpy()
