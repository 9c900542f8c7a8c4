"""The SPMD steps' collectives over a ``ProcessMesh`` axis, each a
``torch.autograd.Function`` with the backward it needs.

The reference writes its collectives inside ``shard_map`` bodies and lets
JAX transpose them. Here each process holds its local shards and calls
these functions; their backward passes follow one rule: the gradient a
rank holds for a tensor sharded over a token axis (batch, seq) is the
gradient of its shard, and a weight's gradient is summed over the token
axes it is not sharded on (``distributed.steps``). The pairs:

- ``all_gather`` (tiled, along a dim) <-> a reduce-scatter of the
  gradient: every rank's downstream work is its own, so the gathered
  tensor's gradients add up across the group;
- ``all_gather_replicated`` <-> this rank's chunk of the gradient: what
  follows is replicated over the group (it shards no tokens there), so
  each rank already holds the whole gradient and a sum would count it
  once a rank;
- ``reduce_scatter`` <-> ``all_gather`` of the gradient;
- ``all_to_all`` (tiled: split one dim, concatenate another, the
  reference's ``all_to_all(..., tiled=True)``) <-> the reverse
  all-to-all;
- ``psum`` over an axis that does not shard tokens (the MoE's
  compute-time ff shards) <-> identity: what follows is replicated over
  that axis and each rank already holds the whole gradient;
- ``sum_grad`` (identity) <-> an all-reduce of the gradient: the entry of
  a region sharded over such an axis (the MoE rows before ff-sharded
  experts), each of whose ranks gives a part of the gradient.

``all_reduce`` without autograd serves what needs no gradient (the
losses, counts, the decode's combine). A group of None is one rank: each
function is then the identity. Tensors are made contiguous where NCCL
needs it; gloo and NCCL both take f32, bf16 and int32.

This file is the only place the port issues collectives: each one reports
its kind and result to the active work counters (``OBSERVERS``,
``analysis.counter``)."""
from __future__ import annotations

import torch
import torch.distributed as dist


# the newer names of the tiled gather and reduce-scatter, where this torch
# has them (the older ones warn that they are deprecated)
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# active work counters (``analysis.counter.count``)
OBSERVERS: list = []


def _seen(kind: str, out):
    for o in OBSERVERS:
        o.collective(kind, out)
    return out


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x, group, dim: int):
    n = group_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0],) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    _gather_into(out, xs, group=group)
    _seen("all-gather", out)
    return out.movedim(0, dim).contiguous()    # the kernels take no strides


def _scatter_sum(x, group, dim: int):
    n = group_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({xs.shape[0]}) over "
                         f"{n} ranks")
    out = torch.empty((xs.shape[0] // n,) + xs.shape[1:], dtype=x.dtype,
                      device=x.device)
    _scatter_from(out, xs, op=dist.ReduceOp.SUM, group=group)
    _seen("reduce-scatter", out)
    return out.movedim(0, dim).contiguous()


def _a2a(x, group, split: int, concat: int):
    """Tiled all-to-all: ``x`` cut into n equal chunks along ``split``,
    chunk i sent to group rank i; the chunks received concatenated along
    ``concat`` in group-rank order."""
    n = group_size(group)
    xs = x.movedim(split, 0)
    if xs.shape[0] % n:
        raise ValueError(f"all-to-all of dim {split} ({xs.shape[0]}) over "
                         f"{n} ranks")
    xs = xs.reshape((n, xs.shape[0] // n) + xs.shape[1:]).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    _seen("all-to-all", out)
    return torch.cat([c.movedim(0, split) for c in out.unbind(0)],
                     dim=concat)


def all_reduce(x, group, op: str = "sum"):
    """``x`` summed (or maxed, ``op="max"``) over the group, a new tensor
    (``x`` itself, detached, for a group of one); no gradient."""
    if group is None:
        return x.detach()
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return _seen("all-reduce", out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _AllGatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _a2a(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.concat, ctx.split), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return _seen("all-reduce", out)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return _seen("all-reduce", out), None


def all_gather(x, group, dim: int):
    """The group's shards of ``x`` concatenated along ``dim`` in group-rank
    order (the reference's tiled ``all_gather``); the gradient is
    reduce-scattered back."""
    return x if group is None else _AllGather.apply(x, group, dim)


def all_gather_replicated(x, group, dim: int):
    """``all_gather`` where what follows is replicated over the group:
    the gradient keeps this rank's chunk, unsummed."""
    return x if group is None else _AllGatherReplicated.apply(x, group, dim)


def reduce_scatter(x, group, dim: int):
    """``x`` summed over the group, this rank's chunk of ``dim`` kept (the
    reference's tiled ``psum_scatter``); the gradient is all-gathered."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_to_all(x, group, split: int, concat: int):
    """The reference's tiled ``all_to_all``; the gradient goes back by the
    reverse one."""
    return x if group is None else _AllToAll.apply(x, group, split, concat)


def psum(x, group):
    """``x`` summed over a group that does not shard tokens; the gradient
    passes unchanged."""
    return x if group is None else _Psum.apply(x, group)


def sum_grad(x, group):
    """``x`` unchanged; its gradient summed over the group."""
    return x if group is None else _SumGrad.apply(x, group)
