"""The collectives of the sharded modules, as plain functions on tensors.

The JAX package has no such module: its strategies call `lax` collectives
inside `shard_map` over the mesh axis "dev". Here each rank is one process
and each function is one `torch.distributed` call over the env's group, or
over one of its subgroups (`group=`, from `ShardingEnv.subgroups()`, JAX's
`axis_index_groups`), with the semantics of JAX's form on the axis JAX
names:

    all_gather(env, x, axis)          lax.all_gather(x, axis=axis, tiled=True)
    all_gather(env, x, axis,          lax.all_gather(x, axis=axis,
               tiled=False)               tiled=False): a new axis
    reduce_scatter(env, x, axis)      lax.psum_scatter(x, scatter_dimension=
                                          axis, tiled=True)
    all_to_all(env, x, split, concat) lax.all_to_all(x, split_axis=split,
                                          concat_axis=concat, tiled=True)
    all_reduce_mean(env, tensors)     the mean over ranks, in place (the
                                      dense gradients JAX's jit averages)
    all_reduce_sum(env, tensors)      lax.psum, in place (the tower
                                      interactions' gradients)
    broadcast_host(env, x, shape,     the owner's host array on every rank
                   dtype, src)        (a UVM table in the DMP's state
                                      dict; JAX's single controller holds
                                      it already)

Block j of a gathered or split axis is the group's j-th rank's, as a JAX
group's blocks follow their position in the group's list (ascending in
both packages). Each function is the identity when the env has no group,
and a real call when it has one, even of one rank, so that an NCCL group
of one rank runs the card's collective path. NCCL's gather, reduce-scatter
and all_to_all work on dim 0, so the axis moves to the front and the
tensor is made contiguous first; bool tensors travel as uint8. The calls
are `all_gather_into_tensor`, `reduce_scatter_tensor`, `all_to_all_single`
and `all_reduce`, which every torch 2.x has (later versions deprecate the
first two's names but keep them).

A float tensor that requires grad, with grad mode on, goes through a
differentiable form (a `torch.autograd.Function`) of the same call: the
backward of all_gather is reduce_scatter of the gradient, of
reduce_scatter all_gather, of all_to_all the all_to_all with split and
concat swapped, JAX's transposes. The feature-processed EBC's lookup at
world size n runs through them. The calls made to torch.distributed are
counted per function, forward and backward alike, as the kernel wrappers
count their launches: `comm.<function>` in utils/tracing.py's registry.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from torchrec_tpu_torch.utils import tracing


def _front(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x with `axis` moved to dim 0, contiguous, bool as uint8."""
    x = x.movedim(axis, 0)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous()


def _back(y: torch.Tensor, axis: int, dtype: torch.dtype) -> torch.Tensor:
    return y.movedim(0, axis).to(dtype)


def _group(env, group: Optional[dist.ProcessGroup]):
    """(the process group, its size): `group`, else the env's."""
    if group is None:
        return env.group, env.world_size
    return group, group.size()


def _differentiable(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def _all_gather(pg, n: int, x: torch.Tensor, axis: int) -> torch.Tensor:
    xs = _front(x, axis)
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    dist.all_gather_into_tensor(out, xs, group=pg)
    tracing.count("comm.all_gather")
    return _back(out, axis, x.dtype)


def _reduce_scatter(pg, n: int, x: torch.Tensor, axis: int) -> torch.Tensor:
    xs = _front(x, axis)
    if xs.shape[0] % n:
        raise ValueError(f"axis {axis} of size {xs.shape[0]} does not split "
                         f"over {n} ranks")
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM, group=pg)
    tracing.count("comm.reduce_scatter")
    return _back(out, axis, x.dtype)


def _all_to_all(pg, n: int, x: torch.Tensor, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    xs = _front(x, split_axis)
    if xs.shape[0] % n:
        raise ValueError(f"axis {split_axis} of size {xs.shape[0]} does not "
                         f"split over {n} ranks")
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=pg)
    tracing.count("comm.all_to_all")
    blocks = out.reshape(n, xs.shape[0] // n, *xs.shape[1:]).unbind(0)
    return torch.cat([_back(b, split_axis, x.dtype) for b in blocks],
                     dim=concat_axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, axis):
        ctx.pg, ctx.n, ctx.axis = pg, n, axis
        return _all_gather(pg, n, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.pg, ctx.n, g, ctx.axis), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, axis):
        ctx.pg, ctx.n, ctx.axis = pg, n, axis
        return _reduce_scatter(pg, n, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.pg, ctx.n, g, ctx.axis), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, split_axis, concat_axis):
        ctx.args = (pg, n, concat_axis, split_axis)
        return _all_to_all(pg, n, x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(*ctx.args[:2], g, *ctx.args[2:]), None, None, \
            None, None


def all_gather(env, x: torch.Tensor, axis: int, tiled: bool = True,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's x concatenated along `axis` in rank order; with
    tiled=False stacked along a new axis `axis` instead."""
    if not tiled:
        x = x.unsqueeze(axis)
    if env.group is None:
        return x
    pg, n = _group(env, group)
    if _differentiable(x):
        return _AllGather.apply(x, pg, n, axis)
    return _all_gather(pg, n, x, axis)


def reduce_scatter(env, x: torch.Tensor, axis: int,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """The sum of every rank's x, of which this rank keeps block `rank`
    of `axis` (its size / n)."""
    if env.group is None:
        return x
    pg, n = _group(env, group)
    if _differentiable(x):
        return _ReduceScatter.apply(x, pg, n, axis)
    return _reduce_scatter(pg, n, x, axis)


def all_to_all(env, x: torch.Tensor, split_axis: int, concat_axis: int,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """x split into n blocks along `split_axis`, block j sent to rank j;
    the blocks received concatenated along `concat_axis` in rank order."""
    if env.group is None:
        return x
    pg, n = _group(env, group)
    if _differentiable(x):
        return _AllToAll.apply(x, pg, n, split_axis, concat_axis)
    return _all_to_all(pg, n, x, split_axis, concat_axis)


def _all_reduce(env, tensors: Sequence[torch.Tensor],
                group: Optional[dist.ProcessGroup], mean: bool) -> None:
    if env.group is None or not tensors:
        return
    pg, n = _group(env, group)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=pg)
    tracing.count("comm.all_reduce_mean" if mean
                  else "comm.all_reduce_sum")
    if mean:
        flat /= n
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def all_reduce_mean(env, tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each tensor by its mean over the ranks, in place, in one
    call: the tensors travel flattened in one f32 buffer, summed, divided
    by n."""
    _all_reduce(env, tensors, group, mean=True)


def all_reduce_sum(env, tensors: Sequence[torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each tensor by its sum over the ranks, in place, in one
    call (one flattened f32 buffer)."""
    _all_reduce(env, tensors, group, mean=False)


# bytes a host array crosses the device in, per broadcast call
BROADCAST_CHUNK_BYTES = 1 << 28


def broadcast_host(env, x, shape, dtype, src: int):
    """Rank `src`'s host array `x` (None on the other ranks) as a numpy
    array of `shape` and `dtype` on every rank: in chunks of at most
    BROADCAST_CHUNK_BYTES through the env's device, one call each (one
    call for an empty or 0-d array)."""
    import numpy as np

    out = np.asarray(x) if env.rank == src else np.empty(shape, dtype)
    out = np.ascontiguousarray(out).copy()
    if env.group is None:
        return out
    flat = out.reshape(-1).view(np.uint8)
    step = BROADCAST_CHUNK_BYTES
    for lo in range(0, max(flat.size, 1), step):
        part = torch.from_numpy(flat[lo:lo + step]).to(env.device)
        dist.broadcast(part, src=src, group=env.group)
        tracing.count("comm.broadcast")
        flat[lo:lo + step] = part.cpu().numpy()
    return out
