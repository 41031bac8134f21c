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

Where JAX's GSPMD inserts the collectives a sharding implies, the port
calls them: :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`shift` (``ppermute`` by one step, as
``batch_isend_irecv``) and :func:`all_to_all`, each over one axis of a
mesh and counted in ``mesh.calls`` (by op).  Over NCCL they take device
tensors.  Gloo takes CUDA tensors for all_reduce, all_gather and
reduce_scatter (:data:`GLOO_CUDA_OPS`, measured on the card); its
send/recv of a CUDA tensor ended both ranks (``writev ... Bad address``)
and it has no all_to_all for them, so for those two ops the wrapper
copies a CUDA tensor through host memory explicitly and counts the copy
in ``mesh.host_copies``.  A mesh
whose collectives go through host memory (gloo with CUDA tensors)
cannot be captured in a CUDA graph: :attr:`Mesh.graph_capturable` says
so, and the graphed paths refuse such a mesh.

The training shardings (``param_shardings``, ``batch_sharding``,
``optimizer_state_shardings``) belong to the second half of the
multi-device slice (ROADMAP item 13b) and raise.
"""

from __future__ import annotations

import collections
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
#: The ops gloo runs on CUDA tensors itself (on the card, PERF.md); the
#: others go through host memory.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter"})

TRAINING_SHARDINGS_NOT_PORTED = (
    "the training shardings (param_shardings, batch_sharding, "
    "optimizer_state_shardings) belong to the multi-device slice's second half "
    "(ROADMAP item 13b) and are not ported yet"
)
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
    went through host memory."""

    def __init__(self, plan: MeshPlan, device: torch.device, backend: str | None = None,
                 groups: dict | None = None, ranks: dict | None = None):
        self.plan = plan
        self.device = device
        self.backend = backend
        self.axis_names, sizes = _axes(plan)
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
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if plan.n_devices > 1:
            raise RuntimeError(NO_GROUP.format(n=plan.n_devices))
        devices = list(devices) if devices is not None else ["cuda"]
        if not devices:
            raise ValueError(f"plan needs {plan.n_devices} devices, have 0")
        return Mesh(plan, resolve_device(devices[0]))
    world, me = dist.get_world_size(), dist.get_rank()
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"the default group runs {group_backend}, not {backend}")
    if world != plan.n_devices:
        raise ValueError(f"plan needs {plan.n_devices} devices, the group has {world} ranks")
    if devices:
        device = resolve_device(devices[0])
    else:
        device = rank_device("cuda" if group_backend == "nccl" else "cpu", me)
    names, sizes = _axes(plan)
    groups, ranks = {}, {}
    for axis in names:
        for members in axis_groups(names, sizes, axis):
            # Every rank creates every group, in one order (the rule of
            # new_group); the whole world is the default group itself.
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members))
            if me in members:
                groups[axis], ranks[axis] = g, members.index(me)
    return Mesh(plan, device, group_backend, groups, ranks)


def tp_mesh(tp: int, devices: list | None = None, backend: str | None = None) -> Mesh:
    """A serving mesh of ``tp`` ranks on the tp axis alone (the JAX tests'
    ``Mesh(devices[:tp], ("tp",))``), over the initialized default group."""
    return make_mesh(MeshPlan(tp=tp), devices=devices, backend=backend)


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


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """The sum of ``x`` over the axis (JAX ``psum``), in ``x``'s dtype; a
    new tensor, ``x`` unchanged."""
    import torch.distributed as dist

    def body(t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.group(axis))
        return t

    return _run(mesh, "all_reduce", axis, x, body)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "tp", dim: int = 0) -> torch.Tensor:
    """The axis's ``x`` concatenated along ``dim`` in rank order (JAX
    ``all_gather(..., tiled=True)``)."""
    import torch.distributed as dist

    n = mesh.shape[axis]

    def body(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=mesh.group(axis))
        return torch.cat(parts, dim=dim)

    return _run(mesh, "all_gather", axis, x, body)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str = "tp", dim: int = 0) -> torch.Tensor:
    """The sum over the axis, split along ``dim`` in rank order, this
    rank's part (JAX ``psum_scatter(..., tiled=True)``)."""
    import torch.distributed as dist

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
    sends ``x`` ``offset`` steps along the axis and returns what it got."""
    import torch.distributed as dist

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
    rank ``i``, the parts received concatenated along ``concat_dim``."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split into {n} parts")

    def body(t):
        parts = [p.contiguous() for p in t.chunk(n, dim=split_dim)]
        got = [torch.empty_like(p) for p in parts]
        dist.all_to_all(got, parts, group=mesh.group(axis))
        return torch.cat(got, dim=concat_dim)

    return _run(mesh, "all_to_all", axis, x, body)


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


def param_shardings(mesh):
    raise NotImplementedError(TRAINING_SHARDINGS_NOT_PORTED)


def batch_sharding(mesh, seq_axis=None):
    raise NotImplementedError(TRAINING_SHARDINGS_NOT_PORTED)


def optimizer_state_shardings(opt_abstract, p_shard, mesh):
    raise NotImplementedError(TRAINING_SHARDINGS_NOT_PORTED)
