"""Multi-GPU scaling: data-parallel sharding of the walk's gap lanes.

The reference's only parallel axis is reads over a pthread pool
(Concurrency/SequenceProcessFramework.h:90-230).  The JAX package shards
the gap-lane axis G of the walk frontier across a device mesh under GSPMD,
with the FM-index replicated on every chip.  Here each rank of a process
group drives one GPU: it holds the whole index and its contiguous share of
the G lanes, walks them with walk.walk_steps (the CUDA kernel on the card,
its plain version on the CPU), and the per-lane reductions are gathered
back to all G lanes.  Lanes are independent and the index is replicated,
so a superstep needs no collective; only the result gather and the metric
reductions touch the interconnect (NCCL, or gloo on the CPU).
"""
from __future__ import annotations

from dataclasses import replace
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops import walk
from . import distributed


def make_group(device) -> dist.ProcessGroup:
    """The default process group over the ranks that joined the store
    (parallel.distributed.init), made on it at first use: NCCL, one GPU a
    rank, when device is a CUDA device; gloo when it is the CPU."""
    if not dist.is_initialized():
        st, world, rank = distributed.joined()
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo",
            store=st, rank=rank, world_size=world,
            timeout=timedelta(milliseconds=distributed.TIMEOUT_MS))
    return dist.group.WORLD


def _shard_rows(x: torch.Tensor, G: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of x [G, ...], past G repeating the last row."""
    if hi > G:
        x = torch.cat([x, x[-1:].expand(hi - G, *x.shape[1:])])
    return x[lo:hi].contiguous()


def shard_lanes(consts: walk.WalkConsts, state: walk.WalkState, world: int,
                rank: int):
    """Rank's contiguous share of a walk batch split over world ranks: every
    per-lane field of consts and state (first dimension G), G padded to a
    multiple of world with inactive lanes; the shared constants as they
    are.  Returns (consts, state) of ceil(G / world) lanes; a field the
    padding does not reach is a view of the caller's rows."""
    G = state.code.shape[0]
    per = -(-G // world)
    lo, hi = rank * per, (rank + 1) * per
    consts = replace(consts, **{f: _shard_rows(getattr(consts, f), G, lo, hi)
                                for f in walk.CONST_FIELDS})
    state = replace(state, **{f: _shard_rows(getattr(state, f), G, lo, hi)
                              for f in walk.STATE_FIELDS})
    pad = torch.arange(lo, hi, device=state.active.device) >= G
    state.active = state.active & ~pad
    return consts, state


def shard_walk_batch(group, consts: walk.WalkConsts, state: walk.WalkState):
    """This rank's share of a walk batch over the group (shard_lanes)."""
    return shard_lanes(consts, state, dist.get_world_size(group), dist.get_rank(group))


def sharded_multistep(wx: walk.WalkIndex, consts: walk.WalkConsts,
                      state: walk.WalkState, cfg: walk.WalkConfig, n: int,
                      group: dist.ProcessGroup, G: int) -> walk.Reduced:
    """Up to n supersteps of the rank's lanes (walk.walk_steps, in place on
    its shard), then the per-lane reductions of every rank gathered and cut
    to the G lanes of the unpadded batch: equal to the unsharded walk's."""
    local = state.code.shape[0]
    red = walk.walk_steps(wx, consts, state, replace(cfg, G=local), n)
    world = dist.get_world_size(group)
    out = {}
    for f in walk.REDUCED_FIELDS:
        x = getattr(red, f)
        # bool travels as uint8: gloo's all_gather takes no bool
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(parts, y.contiguous(), group=group)
        full = torch.cat(parts)[:G]
        out[f] = full.to(torch.bool) if x.dtype == torch.bool else full
    return walk.Reduced(**out)


def all_reduce_counters(group, per_rank: torch.Tensor) -> torch.Tensor:
    """Sum per-rank correction counters across ranks (the metrics reduction
    of the PostProcess sink).  per_rank: this rank's block [m, K] of the
    [world * m, K] counter matrix; returns the elementwise sum over the
    ranks' blocks, as the JAX psum over the mesh axis does."""
    out = per_rank.clone()
    dist.all_reduce(out, group=group)
    return out
