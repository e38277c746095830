"""The port's collectives over mesh axes: the groups of each set of axes,
and all-gather, reduce-scatter, all-reduce and all-to-all along a dim,
with the autograd pairs the reference gets from JAX's transposes
(all-gather <-> reduce-scatter, all-to-all <-> the inverse all-to-all).

A gloo group runs a card's tensors through the host here, not in gloo:
every collective of a gloo group on CUDA tensors copies its input into a
pinned host buffer, runs there and copies the result back. The choice is
made by the group's backend (``staged``), so a NCCL group keeps its
tensors on the card. A collective over one rank is the identity and touches no group.

Tensor and sequence parallelism over 'model' (``tp_in``, ``tp_out``,
``seq_shard``; a decode cache's pieces over ``cache_group``): every rank's backward starts from its own share of the
loss, so each collective's gradient is its transpose (all-gather <->
reduce-scatter, all-reduce <-> all-reduce) and the gradient a rank leaves
on a replicated tensor is its share of the sum over the replicas.

``axis_groups(mesh)`` builds one process group for every set of axes and
every coordinate of the other axes, in the same order on every rank (a
``new_group`` call takes the whole world, members or not), so a mesh's
groups exist before any rank leaves it (``launch.elastic.shrink_mesh``).
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from . import sharding as shd
from .sharding import coordinate, mesh_shape

#: (mesh ranks, shape, axis names) -> {axes: {coordinate of the other axes: group}}
_GROUPS: dict = {}
#: bytes this rank has handed to each kind of collective (its input
#: tensors), since the last ``reset_bytes``
BYTES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0, "all_to_all": 0}
#: (kind, group size) -> [calls, bytes handed in] since the last
#: ``reset_bytes``: what each kind of collective was handed, by the size of
#: the group it ran over (a wire model's ring factors depend on it;
#: ``launch.dryrun.wire_bytes``). Kept as sums, not a list of calls, so that
#: a long run holds no more than a handful of entries.
CALLS: dict = {}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0
    CALLS.clear()


def _count(kind: str, t: torch.Tensor, ag) -> None:
    """One call of ``kind`` handed ``t`` over ``ag``'s group."""
    n = t.numel() * t.element_size()
    BYTES[kind] += n
    rec = CALLS.setdefault((kind, ag.size), [0, 0])
    rec[0] += 1
    rec[1] += n


def _mesh_key(mesh):
    ranks = torch.as_tensor(mesh.mesh)
    return (tuple(ranks.flatten().tolist()), tuple(ranks.shape), tuple(mesh.mesh_dim_names))


def axis_groups(mesh) -> dict:
    """{axes (a tuple of axis names in mesh order): {coordinate of the other
    axes: (ProcessGroup or None where this rank is not a member, ranks)}}
    for every non-empty set of ``mesh``'s axes of more than one rank;
    made once per mesh, collectively."""
    key = _mesh_key(mesh)
    if key in _GROUPS:
        return _GROUPS[key]
    names = tuple(mesh.mesh_dim_names)
    ranks = torch.as_tensor(mesh.mesh)
    me = dist.get_rank()
    out = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if math.prod(ranks.shape[names.index(a)] for a in axes) == 1:
                continue
            others = [a for a in names if a not in axes]
            table = {}
            for rest in itertools.product(*(range(ranks.shape[names.index(a)]) for a in others)):
                # the member ranks in the order of the axes' linear index
                order = [names.index(a) for a in others] + [names.index(a) for a in axes]
                sub = ranks.permute(order)[rest].flatten().tolist()
                g = dist.new_group(sub)
                table[rest] = (g if me in sub else None, sub)
            out[axes] = table
    _GROUPS[key] = out
    return out


def clear_groups() -> None:
    """Forget every mesh's groups (after the world they were made in is
    destroyed)."""
    _GROUPS.clear()
    _AXIS_GROUPS.clear()


class AxisGroup:
    """This rank's group over ``axes`` of ``mesh`` (in the mesh's order; a
    spec's tuple names the major axis first, as the mesh does): ``group``
    (None for one rank), ``size``, ``index`` (the rank's linear index over
    the axes, the first axis major) and ``ranks``."""

    def __init__(self, mesh, axes):
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(axes)
        if axes != tuple(a for a in names if a in axes):
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        sizes = mesh_shape(mesh)
        coord = coordinate(mesh)
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        self.axes, self.size, self.index = axes, 1, 0
        for a in axes:
            self.index = self.index * sizes[a] + coord[a]
            self.size *= sizes[a]
        self.group, self.ranks = None, [dist.get_rank()]
        if self.size > 1:
            rest = tuple(coord[a] for a in names if a not in axes)
            self.group, self.ranks = axis_groups(mesh)[axes][rest]


# ---------------------------------------------------------------------------
# host staging
# ---------------------------------------------------------------------------

def staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``group`` on ``t`` runs through the host:
    a gloo group and a tensor on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


#: pinned host buffers the staged collectives reuse ("in", "out"), grown
#: to the largest tensor staged so far: fresh pageable host tensors a call
#: cost a page fault a page and a pageable copy each way
_STAGE: dict = {}


def reserve_staging(nbytes: int) -> None:
    """Pin both staging buffers at ``nbytes`` at once (the largest tensor a
    caller will stage): growing them call by call pins every size on the
    way, and page-locking is slow."""
    for slot in ("in", "out"):
        buf = _STAGE.get(slot)
        if buf is None or buf.numel() < nbytes:
            _STAGE[slot] = None
            _STAGE[slot] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _host_view(slot: str, like: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor shaped like ``like`` in the reused pinned
    buffer ``slot``."""
    n = like.numel() * like.element_size()
    buf = _STAGE.get(slot)
    if buf is None or buf.numel() < n:
        _STAGE[slot] = buf = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
    return buf[:n].view(like.dtype).view(like.shape)


def _run(group, fn, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """``fn(out, inp)`` on ``group``, through the host when ``staged``."""
    if not staged(group, out):
        fn(out, inp)
        return out
    host_in = _host_view("in", inp)
    host_in.copy_(inp)
    host_out = _host_view("out", out)
    fn(host_out, host_in)
    return out.copy_(host_out)


_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_base = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


#: dtypes summed in f32 and rounded once, never hop by hop
_NARROW = (torch.bfloat16, torch.float16)


def all_reduce_(t: torch.Tensor, ag: AxisGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group, in place (a bf16 or f16 tensor in
    f32, rounded once)."""
    if ag.size == 1:
        return t
    if t.dtype in _NARROW:
        return t.copy_(all_reduce_(t.to(torch.float32), ag, op))
    _count("all_reduce", t, ag)
    if staged(ag.group, t):
        host = _host_view("in", t)
        host.copy_(t)
        dist.all_reduce(host, op=op, group=ag.group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=ag.group)
    return t


def _gather(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    t = t.contiguous()
    _count("all_gather", t, ag)
    flat = t.reshape((1,) + tuple(t.shape))
    out = torch.empty((ag.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    # the collective takes the ranks' blocks concatenated on dim 0
    _run(ag.group, lambda o, i: _gather_base(o.flatten(0, 1), i.flatten(0, 1),
                                             group=ag.group), out, flat)
    # (n, ..., s, ...) -> (..., n * s, ...)
    out = out.movedim(0, dim)
    shape = list(t.shape)
    shape[dim] *= ag.size
    return out.reshape(shape)


def _scatter(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    shape = list(t.shape)
    n = shape[dim] // ag.size
    parts = t.reshape(shape[:dim] + [ag.size, n] + shape[dim + 1:]).movedim(dim, 0).contiguous()
    _count("reduce_scatter", t, ag)
    if t.dtype in _NARROW:
        # the blocks to their owners in the narrow dtype, summed there in
        # f32 and rounded once (the reference's reduce-scatter of a bf16
        # tensor): the wire of a reduce-scatter, no rounding a hop
        recv = _a2a(parts, ag, count=False)
        return recv.to(torch.float32).sum(0).to(t.dtype)
    out = torch.empty((1,) + tuple(parts.shape[1:]), dtype=t.dtype, device=t.device)
    _run(ag.group, lambda o, i: _scatter_base(o.flatten(0, 1), i.flatten(0, 1),
                                              group=ag.group), out, parts)
    return out[0]


def gather(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """The tiled all-gather of ``t`` along ``dim`` (no gradient)."""
    return t if ag.size == 1 else _gather(t, ag, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _gather(t, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.ag, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _scatter(t, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ag, ctx.dim), None, None


def reduce_scatter(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """The tiled reduce-scatter (sum) of ``t`` along ``dim`` (a bf16 or f16
    tensor summed in f32 and rounded once); its gradient is the all-gather
    of the output's (the reference's transpose of ``psum_scatter``)."""
    return t if ag.size == 1 else _ReduceScatter.apply(t, ag, dim)


def all_gather(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """The tiled all-gather of ``t`` along ``dim``; its gradient is the
    reduce-scatter (sum) of the output's, in the output's dtype (the
    reference's transpose of ``all_gather``)."""
    return t if ag.size == 1 else _AllGather.apply(t, ag, dim)


def _a2a(t: torch.Tensor, ag: AxisGroup, count: bool = True) -> torch.Tensor:
    t = t.contiguous()
    if count:
        _count("all_to_all", t, ag)
    out = torch.empty_like(t)
    return _run(ag.group, lambda o, i: dist.all_to_all_single(o, i, group=ag.group), out, t)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        ctx.ag = ag
        return _a2a(t, ag)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.ag), None


def all_to_all(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``all_to_all_single`` of ``t`` (its dim 0 split evenly over the
    group: block j goes to rank j, and block j of the result came from rank
    j); its gradient is the same exchange of the output's gradient."""
    return t if ag.size == 1 else _AllToAll.apply(t, ag)


_AXIS_GROUPS: dict = {}


def group_for(mesh, axes) -> AxisGroup:
    """This rank's ``AxisGroup`` over ``axes`` of ``mesh`` (kept per mesh)."""
    key = (_mesh_key(mesh), tuple(axes))
    if key not in _AXIS_GROUPS:
        _AXIS_GROUPS[key] = AxisGroup(mesh, axes)
    return _AXIS_GROUPS[key]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        ctx.ag = ag
        return all_reduce_(t.clone(), ag)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.ag), None


def all_reduce_sum(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The sum of ``t`` over the group (the reference's ``psum``); its
    gradient is the sum of the output's gradients over the group: every
    rank's share of the loss reaches every rank's ``t``."""
    return t if ag.size == 1 else _AllReduce.apply(t, ag)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        ctx.ag = ag
        return all_reduce_(t.clone(), ag) / ag.size

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.ag) / ctx.ag.size, None


def all_reduce_mean(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """The mean of ``t`` over the group (the reference's ``pmean``). Its
    gradient is the mean of the output's gradients over the group: the sum
    of every rank's loss differentiates each rank's ``t`` once."""
    return t if ag.size == 1 else _AllReduceMean.apply(t, ag)


# ---------------------------------------------------------------------------
# tensor and sequence parallelism over 'model'
# ---------------------------------------------------------------------------

def tp_group():
    """This rank's group over the active mesh's 'model' axis, or None (no
    mesh, no such axis, or one rank on it). A weight that stays sharded at
    use is this rank's slice over it, the slice's index its ``index``."""
    mesh = shd.active_mesh()
    if mesh is None or mesh_shape(mesh).get("model", 1) == 1:
        return None
    return group_for(mesh, ("model",))


def cache_group():
    """This rank's group over the mesh axes the active rules give the
    decode cache's length (``"cache"``: 'model' under ``decode``, 'data'
    under ``decode_b1``), or None (no mesh, no such axis, or one rank on
    it). A cache piece is the ring's ``index``-th of ``size`` equal
    pieces."""
    mesh = shd.active_mesh()
    if mesh is None:
        return None
    axes = shd.axes_for("cache")
    if not axes or math.prod(mesh_shape(mesh)[a] for a in axes) == 1:
        return None
    return group_for(mesh, axes)


def tp_slice(full: int, local: int) -> int:
    """The first index of this rank's slice of a dim of ``full`` of which
    it holds ``local`` (0 when it holds the whole)."""
    return 0 if local == full else tp_group().index * local


def tp_in(x: torch.Tensor) -> torch.Tensor:
    """A block's input from the residual stream (B, S_local, ...): under
    sequence parallelism the whole sequence, all-gathered over 'model' on
    dim 1 (its gradient reduce-scattered back); else ``x``."""
    return all_gather(x, tp_group(), 1) if shd.seq_parallel() else x


def tp_out(y: torch.Tensor, partial: bool) -> torch.Tensor:
    """A block's output (B, S, ...) back into the residual stream's layout.
    ``partial``: a row-parallel partial sum over 'model' (this rank's heads,
    ``mlp``, ``rnn`` or expert slice), reduce-scattered along the sequence
    under sequence parallelism and all-reduced without; a complete output
    is cut to this rank's piece of the sequence (``seq_shard``)."""
    ag = tp_group()
    if ag is None:
        return y
    if partial:
        return reduce_scatter(y, ag, 1) if shd.seq_parallel() else all_reduce_sum(y, ag)
    return seq_shard(y)


def seq_shard(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's piece of a whole sequence on ``dim`` under sequence
    parallelism (a view; its gradient lands in that piece only), else
    ``x``."""
    if not shd.seq_parallel():
        return x
    ag = tp_group()
    n = x.shape[dim] // ag.size
    return x.narrow(dim, ag.index * n, n)
