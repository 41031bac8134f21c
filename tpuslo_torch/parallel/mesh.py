"""Device meshes over ``torch.distributed`` process groups (PyTorch port
of ``tpuslo/parallel/mesh.py``).

:class:`MeshPlan` and :func:`plan_for_devices` are the JAX module's pure
factorization (tp innermost, then fsdp, then dp; a dcn axis factored out
first for multi-slice plans), so a plan means the same thing in both
packages.

:func:`make_mesh` builds a :class:`Mesh`:

* a plan of one device, with no process group initialized: the one-device
  mesh the training path runs on (the card unless the caller passes
  ``devices=["cpu"]``), with no groups and no collectives;
* otherwise a mesh over the calling rank's initialized default group,
  whose world size must equal the plan's device count: one subgroup per
  axis (``dcn`` when the plan has slices, then ``dp``, ``fsdp``, ``tp``),
  the ranks laid out row-major over the axes as JAX lays out its devices.
  Each rank's device is its own (``cuda:<rank % cards>``), or ``cuda:0``
  for every rank when all of them share one card, or the CPU.  A plan of
  more than one device without a group raises and says how to start
  ranks (:func:`run_ranks`); no mesh of one device is built in its place.

:func:`sp_mesh` builds the one-axis ``("sp",)`` mesh of sequence
parallelism (the JAX tests' ``Mesh(devices[:n], ("sp",))``) the same way;
it has no plan.

Where JAX's GSPMD inserts the collectives a sharding implies, the port
calls them: :func:`all_reduce` (a sum, or a max with ``op="max"``: JAX's
``pmax``, counted as ``all_reduce_max``), :func:`all_gather`,
:func:`reduce_scatter`, :func:`shift` (``ppermute`` by one step, as
``batch_isend_irecv``) and :func:`all_to_all`, each over one axis of a
mesh and counted in ``mesh.calls`` (by op).  Over NCCL they take device
tensors.  Gloo takes CUDA tensors for all_reduce (sum and max), all_gather
and reduce_scatter (:data:`GLOO_CUDA_OPS`, measured on the card); its
send/recv of a CUDA tensor ended both ranks (``writev ... Bad address``)
and it has no all_to_all for them, so for those two ops the wrapper
copies a CUDA tensor through host memory explicitly and counts the copy
in ``mesh.host_copies``.  A mesh
whose collectives go through host memory (gloo with CUDA tensors)
cannot be captured in a CUDA graph: :attr:`Mesh.graph_capturable` says
so, and the graphed paths refuse such a mesh.

:func:`ep_mesh` builds the one-axis ``("ep",)`` mesh of expert-parallel
MoE serving and of :func:`tpuslo_torch.ops.moe.moe_mlp_sharded` the same
way.

Under autograd the collectives have their transposes (JAX's rules for
``psum``, ``all_gather``, ``ppermute`` and ``all_to_all``), each a
``torch.autograd.Function`` over the counted wrappers, so the backward's
calls are counted too (and go through host memory where the forward's
would): :func:`all_reduce` (sum) transposes to itself, :func:`all_gather`
to :func:`reduce_scatter` and back, :func:`shift` to the opposite shift
and :func:`all_to_all` to the inverse exchange.  These are the rules of a
*summed* objective, each rank holding its share of the loss (the data
axes).  Over a model axis (tp, ep) every rank holds the whole loss, and
Megatron's pair applies instead: :func:`copy_to` (``f``: identity
forward, gradients summed over the axis) and :func:`reduce_from` (``g``:
the sum forward, the gradient passed through).

The training layouts are tables, as the port writes every layout: leaf
path -> ``{dim: axis}`` (an axis a name, or a tuple of names split
row-major), with ``{}`` for a replicated leaf.  :func:`param_shardings`
is JAX's dp/fsdp/tp layout, :func:`batch_sharding` splits the rows over
the data axes and :func:`optimizer_state_shardings` gives an optimizer
state's leaves the layout of the parameter whose path ends theirs.
:func:`place_leaf` cuts a rank's part of a whole leaf and
:func:`gather_leaf` puts the whole leaf back together.  :func:`pp_mesh`
builds the one-axis ``("pp",)`` mesh of :mod:`.pipeline` and
:func:`dp_ep_mesh` the MoE family's ``("dp", "ep")`` training mesh.
"""

from __future__ import annotations

import collections
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tpuslo_torch.device import resolve_device

AXES = ("dp", "fsdp", "tp")
#: The ops gloo runs on CUDA tensors itself (in f32 and bf16, measured on
#: the card by ``python3 chip_smoke.py probe gloo``, PERF.md); the others go
#: through host memory.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_reduce_max", "all_gather", "reduce_scatter"})

NO_GROUP = (
    "a mesh of {n} devices needs an initialized torch.distributed group of {n} "
    "ranks: start them with tpuslo_torch.parallel.mesh.run_ranks(fn, {n}, backend, "
    "device) or call torch.distributed.init_process_group(backend, "
    "init_method='tcp://localhost:<port>', world_size={n}, rank=<rank>) in each"
)



@dataclass(frozen=True)
class MeshPlan:
    """Device factorization: ``dcn`` slices of ``dp x fsdp x tp``
    devices (the JAX module's plan)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    dcn: int = 1

    @property
    def n_devices(self) -> int:
        return self.dcn * self.dp * self.fsdp * self.tp


def plan_for_devices(n: int, slices: int = 1) -> MeshPlan:
    """The JAX module's default factorization: tp innermost (8, 4 or 2),
    then fsdp (4 or 2), then dp; ``slices > 1`` factors a dcn axis out
    first and gives each slice the single-slice plan of its devices."""
    if slices > 1:
        if n % slices:
            raise ValueError(f"{n} devices not divisible by {slices} slices")
        inner = plan_for_devices(n // slices)
        return MeshPlan(dp=inner.dp, fsdp=inner.fsdp, tp=inner.tp, dcn=slices)
    tp = 1
    for candidate in (8, 4, 2):
        if n % candidate == 0:
            tp = candidate
            break
    rest = n // tp
    fsdp = 1
    for candidate in (4, 2):
        if rest % candidate == 0:
            fsdp = candidate
            break
    return MeshPlan(dp=rest // fsdp, fsdp=fsdp, tp=tp)


def _axes(plan: MeshPlan) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Axis names and sizes, outermost first, as the JAX module orders
    them (the dcn axis only for a multi-slice plan)."""
    if plan.dcn > 1:
        return ("dcn", *AXES), (plan.dcn, plan.dp, plan.fsdp, plan.tp)
    return AXES, (plan.dp, plan.fsdp, plan.tp)


def axis_groups(names: tuple[str, ...], sizes: tuple[int, ...], axis: str) -> list[list[int]]:
    """The rank lists of ``axis``'s groups over ranks laid out row-major:
    each list holds the ranks whose coordinates differ only on ``axis``,
    in the order of that coordinate."""
    a = names.index(axis)
    stride = 1
    for s in sizes[a + 1:]:
        stride *= s
    n = 1
    for s in sizes:
        n *= s
    groups = []
    for r in range(n):
        if (r // stride) % sizes[a] == 0:
            groups.append([r + i * stride for i in range(sizes[a])])
    return groups


class Mesh:
    """A device mesh: the plan, this rank's device and, over a process
    group, one subgroup per axis.

    ``axis_names`` and ``shape`` (axis -> size) read as JAX's mesh does
    (``"tp" in mesh.axis_names``, ``mesh.shape["tp"]``); ``rank(axis)``
    is this rank's coordinate on an axis and ``group(axis)`` its
    subgroup (``None`` on a one-device mesh).  ``calls`` counts the
    collectives called over the mesh by op, ``host_copies`` those that
    went through host memory.  ``axes`` (names, sizes) gives a mesh
    without a plan (``plan`` None) its axes: :func:`sp_mesh`."""

    def __init__(self, plan: MeshPlan | None, device: torch.device, backend: str | None = None,
                 groups: dict | None = None, ranks: dict | None = None,
                 axes: tuple[tuple[str, ...], tuple[int, ...]] | None = None):
        self.plan = plan
        self.device = device
        self.backend = backend
        self.axis_names, sizes = axes or _axes(plan)
        self.shape = dict(zip(self.axis_names, sizes))
        self._groups = groups or {}
        self._ranks = ranks or {name: 0 for name in self.axis_names}
        self.calls: collections.Counter = collections.Counter()
        self.host_copies = 0

    def rank(self, axis: str) -> int:
        return self._ranks[axis]

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def distributed(self) -> bool:
        """Does the mesh run over a process group?"""
        return self.backend is not None

    @property
    def size(self) -> int:
        """The number of ranks (devices) the mesh spans."""
        return math.prod(self.shape.values())

    @property
    def graph_capturable(self) -> bool:
        """Can a CUDA graph capture the mesh's collectives?  Not when they
        go through host memory (gloo with CUDA tensors)."""
        return not (self.backend == "gloo" and self.device.type == "cuda")

    def reset_counts(self) -> None:
        self.calls.clear()
        self.host_copies = 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"backend={self.backend or 'none'})")


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or ``cuda:<rank % cards>`` (every
    rank on ``cuda:0`` when the host has one card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    return resolve_device(f"cuda:{rank % max(1, torch.cuda.device_count())}")


def make_mesh(plan: MeshPlan, devices: list | None = None,
              backend: str | None = None) -> Mesh:
    """A :class:`Mesh` for ``plan`` (see the module docstring).
    ``devices``: a one-device mesh's device list (default the card), or,
    over a group, the device every rank uses (default: each rank's own
    card).  ``backend`` must match the initialized group's when given."""
    return _group_mesh(plan, _axes(plan), devices, backend)


def _group_mesh(plan: MeshPlan | None, axes: tuple[tuple[str, ...], tuple[int, ...]],
                devices: list | None, backend: str | None) -> Mesh:
    """:func:`make_mesh` over the axes ``(names, sizes)``."""
    import torch.distributed as dist

    names, sizes = axes
    n = math.prod(sizes)
    if not (dist.is_available() and dist.is_initialized()):
        if n > 1:
            raise RuntimeError(NO_GROUP.format(n=n))
        devices = list(devices) if devices is not None else ["cuda"]
        if not devices:
            raise ValueError(f"plan needs {n} devices, have 0")
        return Mesh(plan, resolve_device(devices[0]), axes=axes)
    world, me = dist.get_world_size(), dist.get_rank()
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"the default group runs {group_backend}, not {backend}")
    if world != n:
        raise ValueError(f"plan needs {n} devices, the group has {world} ranks")
    if devices:
        device = resolve_device(devices[0])
    else:
        device = rank_device("cuda" if group_backend == "nccl" else "cpu", me)
    groups, ranks = {}, {}
    for axis in names:
        for members in axis_groups(names, sizes, axis):
            # Every rank creates every group, in one order (the rule of
            # new_group); the whole world is the default group itself.
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members))
            if me in members:
                groups[axis], ranks[axis] = g, members.index(me)
    return Mesh(plan, device, group_backend, groups, ranks, axes)


def tp_mesh(tp: int, devices: list | None = None, backend: str | None = None) -> Mesh:
    """A serving mesh of ``tp`` ranks on the tp axis alone (the JAX tests'
    ``Mesh(devices[:tp], ("tp",))``), over the initialized default group."""
    return make_mesh(MeshPlan(tp=tp), devices=devices, backend=backend)


def sp_mesh(n: int, devices: list | None = None, backend: str | None = None) -> Mesh:
    """A sequence-parallel mesh of ``n`` ranks on one axis, ``"sp"`` (the
    JAX tests' ``Mesh(devices[:n], ("sp",))``), over the initialized
    default group; ``n`` 1 with no group is the one-device mesh of
    :func:`make_mesh`.  It has no plan."""
    return _group_mesh(None, (("sp",), (n,)), devices, backend)


def ep_mesh(n: int, devices: list | None = None, backend: str | None = None) -> Mesh:
    """An expert-parallel mesh of ``n`` ranks on one axis, ``"ep"`` (the
    JAX tests' ``Mesh(devices[:n], ("ep",))``), built as :func:`sp_mesh`
    builds its own."""
    return _group_mesh(None, (("ep",), (n,)), devices, backend)


def dp_ep_mesh(dp: int, ep: int, devices: list | None = None,
               backend: str | None = None) -> Mesh:
    """The MoE family's training mesh: ``("dp", "ep")`` of ``dp x ep``
    ranks laid out row-major (the JAX trainer's
    ``Mesh(devices.reshape(dp, ep), ("dp", "ep"))``), built as
    :func:`sp_mesh` builds its own.  It has no plan."""
    return _group_mesh(None, (("dp", "ep"), (dp, ep)), devices, backend)


def pp_mesh(n: int, devices: list | None = None, backend: str | None = None) -> Mesh:
    """A pipeline mesh of ``n`` stages on one axis, ``"pp"`` (the JAX
    tests' ``Mesh(devices[:n], ("pp",))``), built as :func:`sp_mesh`
    builds its own."""
    return _group_mesh(None, (("pp",), (n,)), devices, backend)


# --- collectives over a mesh axis ----------------------------------------


def _host_staged(mesh: Mesh, op: str, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda" and op not in GLOO_CUDA_OPS


def _run(mesh: Mesh, op: str, axis: str, x: torch.Tensor, body: Callable) -> torch.Tensor:
    """Count the call and run ``body(x)`` over the axis group, through host
    memory where the backend does not take ``x``'s device."""
    mesh.calls[op] += 1
    if not mesh.distributed:
        raise ValueError(f"{op} over a one-device mesh has no group")
    if _host_staged(mesh, op, x):
        mesh.host_copies += 1
        return body(x.cpu()).to(x.device)
    return body(x)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = "tp", op: str = "sum") -> torch.Tensor:
    """The sum of ``x`` over the axis (JAX ``psum``), or with ``op="max"``
    its elementwise max (JAX ``pmax``, counted as ``all_reduce_max``), in
    ``x``'s dtype; a new tensor, ``x`` unchanged.  Under autograd the sum's
    gradient is the sum of the ranks' gradients (``psum``'s transpose)."""
    import torch.distributed as dist

    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def body(t):
        t = t.clone()
        dist.all_reduce(t, op=reduce_op, group=mesh.group(axis))
        return t

    if op == "sum" and _recorded(x):
        return _PSum.apply(x, mesh, axis)
    return _run(mesh, "all_reduce" if op == "sum" else f"all_reduce_{op}", axis, x, body)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "tp", dim: int = 0) -> torch.Tensor:
    """The axis's ``x`` concatenated along ``dim`` in rank order (JAX
    ``all_gather(..., tiled=True)``); under autograd its gradient is
    :func:`reduce_scatter`'s of the output's."""
    import torch.distributed as dist

    if _recorded(x):
        return _AllGather.apply(x, mesh, axis, dim)

    n = mesh.shape[axis]

    def body(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=mesh.group(axis))
        return torch.cat(parts, dim=dim)

    return _run(mesh, "all_gather", axis, x, body)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str = "tp", dim: int = 0) -> torch.Tensor:
    """The sum over the axis, split along ``dim`` in rank order, this
    rank's part (JAX ``psum_scatter(..., tiled=True)``); under autograd
    its gradient is :func:`all_gather`'s of the output's."""
    import torch.distributed as dist

    if _recorded(x):
        return _ReduceScatter.apply(x, mesh, axis, dim)

    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {n} parts")

    def body(t):
        parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.group(axis))
        return out

    return _run(mesh, "reduce_scatter", axis, x, body)


def shift(x: torch.Tensor, mesh: Mesh, axis: str = "tp", offset: int = 1) -> torch.Tensor:
    """JAX ``ppermute`` with ``perm = [(i, (i + offset) % n)]``: each rank
    sends ``x`` ``offset`` steps along the axis and returns what it got;
    under autograd the gradient goes back by ``-offset``."""
    import torch.distributed as dist

    if _recorded(x):
        return _Shift.apply(x, mesh, axis, offset)

    n, me = mesh.shape[axis], mesh.rank(axis)
    group = mesh.group(axis)

    def body(t):
        t = t.contiguous()
        if n == 1:
            return t.clone()
        out = torch.empty_like(t)
        to = dist.get_global_rank(group, (me + offset) % n)
        frm = dist.get_global_rank(group, (me - offset) % n)
        ops = [dist.P2POp(dist.isend, t, to, group), dist.P2POp(dist.irecv, out, frm, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    return _run(mesh, "shift", axis, x, body)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str = "tp", split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """JAX ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` split into ``n`` parts along ``split_dim``, part ``i`` sent to
    rank ``i``, the parts received concatenated along ``concat_dim``;
    under autograd the gradient takes the inverse exchange (``split_dim``
    and ``concat_dim`` swapped)."""
    import torch.distributed as dist

    if _recorded(x):
        return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)

    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split into {n} parts")

    def body(t):
        parts = [p.contiguous() for p in t.chunk(n, dim=split_dim)]
        got = [torch.empty_like(p) for p in parts]
        dist.all_to_all(got, parts, group=mesh.group(axis))
        return torch.cat(got, dim=concat_dim)

    return _run(mesh, "all_to_all", axis, x, body)


# --- collectives under autograd ------------------------------------------


def _recorded(x: torch.Tensor) -> bool:
    """Does autograd record an op on ``x``?"""
    return torch.is_grad_enabled() and x.requires_grad


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        with torch.no_grad():
            return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        with torch.no_grad():
            return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        with torch.no_grad():
            return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        with torch.no_grad():
            return shift(x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.mesh, ctx.axis, -ctx.offset), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        with torch.no_grad():
            return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.mesh, ctx.axis, concat_dim, split_dim), None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        with torch.no_grad():
            return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron's ``f`` over a model axis: ``x`` itself, and under autograd
    its gradient summed over the axis (each rank's products read their
    columns of ``x``, so each holds a part of its gradient).  Outside
    autograd: ``x``, no call."""
    return _CopyTo.apply(x, mesh, axis) if _recorded(x) else x


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron's ``g`` over a model axis: the sum of the ranks' partials
    (:func:`all_reduce`), whose gradient, the same on every rank, passes
    through unchanged."""
    return _ReduceFrom.apply(x, mesh, axis) if _recorded(x) else all_reduce(x, mesh, axis)


# --- the training layouts ---------------------------------------------------

#: JAX's ``param_shardings``: column-parallel products split their input
#: over fsdp and their output over tp, row-parallel ones the transpose, the
#: embedding its vocab rows over tp, the head its vocab columns; the norms
#: are replicated.  Layer leaves keep their leading layer axis whole.
PARAM_SHARDINGS = {
    "embed": {0: "tp", 1: "fsdp"},
    "layers/attn_norm": {},
    "layers/wq": {1: "fsdp", 2: "tp"},
    "layers/wk": {1: "fsdp", 2: "tp"},
    "layers/wv": {1: "fsdp", 2: "tp"},
    "layers/wo": {1: "tp", 2: "fsdp"},
    "layers/mlp_norm": {},
    "layers/w1": {1: "fsdp", 2: "tp"},
    "layers/w3": {1: "fsdp", 2: "tp"},
    "layers/w2": {1: "tp", 2: "fsdp"},
    "final_norm": {},
    "output": {0: "fsdp", 1: "tp"},
}
#: The axes a batch's rows split over, outermost first (those the mesh has).
DATA_AXES = ("dcn", "dp", "fsdp")


def param_shardings(mesh: Mesh) -> dict[str, dict]:
    """The dp/fsdp/tp layout of a ``init_params`` tree over ``mesh``
    (:data:`PARAM_SHARDINGS`, a fresh copy)."""
    missing = {"fsdp", "tp"} - set(mesh.axis_names)
    if missing:
        raise ValueError(f"the training layout needs the fsdp and tp axes, "
                         f"the mesh has {mesh.axis_names}")
    return {path: dict(spec) for path, spec in PARAM_SHARDINGS.items()}


def batch_sharding(mesh: Mesh, seq_axis: str | None = None) -> dict:
    """Tokens and targets: the rows over every data axis the mesh carries
    (``dcn``, ``dp``, ``fsdp``, row-major), optionally the sequence over
    ``seq_axis`` (JAX's ``P(data_axes, seq_axis)``)."""
    spec: dict = {0: tuple(a for a in DATA_AXES if a in mesh.axis_names)}
    if seq_axis is not None:
        spec[1] = seq_axis
    return spec


def _tree_map_paths(fn, tree, prefix: tuple = ()):
    """``tree`` (dicts, lists and tuples) with each leaf replaced by
    ``fn(path, leaf)``, ``path`` the tuple of its keys."""
    if isinstance(tree, dict):
        return {k: _tree_map_paths(fn, v, (*prefix, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_paths(fn, v, (*prefix, i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def optimizer_state_shardings(opt_state, p_shard: dict, mesh: Mesh):
    """The layout tree of an optimizer state that mirrors a parameter tree
    (e.g. ``{"count", "mu": params, "nu": params}``): a state leaf whose
    path ends with a parameter's path (``("mu", "layers", "w1")`` ends
    with ``"layers/w1"``) takes that parameter's layout, every other leaf
    is replicated (``{}``).  Matching by path, as JAX's does, tells apart
    two parameters of one shape and different layouts."""
    by_path = {tuple(path.split("/")): spec for path, spec in p_shard.items()}

    def lookup(path, _leaf):
        for i in range(len(path)):
            if path[i:] in by_path:
                return dict(by_path[path[i:]])
        return {}

    return _tree_map_paths(lookup, opt_state)


def axis_index(mesh: Mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes``, a name or a tuple of
    names taken row-major."""
    index, count = 0, 1
    for a in (axes,) if isinstance(axes, str) else axes:
        index, count = index * mesh.shape[a] + mesh.rank(a), count * mesh.shape[a]
    return index, count


def place_leaf(leaf: torch.Tensor, spec: dict, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a whole leaf under ``spec`` ``{dim: axis}``: a
    fresh contiguous tensor (a copy where nothing splits), so that the
    whole leaf can be freed."""
    out = leaf
    for dim, axes in spec.items():
        index, count = axis_index(mesh, axes)
        size = out.shape[dim]
        if size % count:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not split into {count} "
                             f"parts over {axes}")
        out = out.narrow(dim, index * (size // count), size // count)
    return out.clone(memory_format=torch.contiguous_format)


def gather_leaf(part: torch.Tensor, spec: dict, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's :func:`place_leaf` part (every rank
    calls it, in one order; each gets the whole leaf)."""
    out = part
    for dim, axes in spec.items():
        for a in reversed((axes,) if isinstance(axes, str) else axes):
            if mesh.shape[a] > 1:
                out = all_gather(out, mesh, a, dim)
    return out


# --- starting ranks -------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, device: str, store: str,
               results, args: tuple) -> None:
    import torch.distributed as dist

    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=rank, **kwargs)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # By value: the queue's own pickler would pass tensors as shared
        # memory, which dies with this process.
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable[..., Any], world_size: int, backend: str = "gloo",
              device: str = "cpu", timeout_s: float = 300.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``torch.distributed`` group, and return each
    rank's (picklable) result in rank order.

    The group meets through a ``file://`` store in a fresh temporary
    directory, so concurrent callers never race for a port.  Each rank's
    device is :func:`rank_device` of ``device`` (``"cuda"``: its own card,
    or ``cuda:0`` for all when the host has one).  ``fn`` must be
    importable by the spawned processes (a module-level function).  If a
    rank fails, or ``timeout_s`` passes, every rank still running is
    killed at once (they would wait in a collective forever) and
    ``RuntimeError`` names the failure."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tpuslo-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, device, store, results, args),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got: dict[int, Any] = {}
        failure = None
        try:
            while len(got) < world_size and failure is None:
                try:
                    rank, ok, out = results.get(timeout=0.1)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        failure = f"ranks timed out after {timeout_s} s"
                    elif any(p.exitcode not in (None, 0) for p in procs):
                        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                        # A rank that raised reports before it exits:
                        # drain once more before naming the exit.
                        try:
                            rank, ok, out = results.get(timeout=1.0)
                        except queue_mod.Empty:
                            failure = f"rank(s) {dead} exited with no result"
                            continue
                    else:
                        continue
                if failure is None:
                    if ok:
                        got[rank] = pickle.loads(out)
                    else:
                        failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if p.is_alive() and (failure is not None or len(got) < world_size):
                    p.kill()
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world_size)]


