"""Active collective prober: measured collectives over a mesh (PyTorch
port of ``tpuslo/parallel/collectives.py``).

The toolkit's passive sources observe the workload's collectives; this
is the active counterpart: a blackbox prober that launches small
all_reduce / all_gather / reduce_scatter / shift rounds over a mesh axis
and reports their latency as ``ici_collective_latency_ms`` probe events,
so a degrading interconnect shows up even when the serving workload is
idle.

The ops keep the JAX module's names (``psum``, ``all_gather``,
``reduce_scatter``, ``ppermute``) and run through
:mod:`tpuslo_torch.parallel.mesh`'s wrappers over the mesh's group: NCCL
on the card, gloo on the CPU.  The constructor builds the input and runs
each op once (NCCL sets up its communicator at the first call), so
:meth:`CollectiveSuite.measure` only replays them.  A round is timed with
CUDA events on the card and ``perf_counter`` on the CPU.  The probe
records, their quantiles and :func:`probes_to_events` are the JAX
module's field for field.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from datetime import datetime, timezone

import numpy as np
import torch

from tpuslo_torch.parallel import mesh as mesh_mod
from tpuslo_torch.schema import ProbeEventV1, TPURef
from tpuslo_torch.signals.constants import SIGNAL_ICI_COLLECTIVE_MS
from tpuslo_torch.signals.generator import signal_status

DEFAULT_OPS = ("psum", "all_gather", "reduce_scatter", "ppermute")
PROBE_AXIS = "tp"  # the probe mesh's one axis of more than one rank


@dataclass(frozen=True)
class CollectiveProbe:
    """One measured collective: latency quantiles over ``reps`` rounds."""

    op: str
    n_devices: int
    payload_bytes_per_device: int
    reps: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    min_ms: float

    def to_dict(self) -> dict:
        return {
            "op": self.op,
            "n_devices": self.n_devices,
            "payload_bytes_per_device": self.payload_bytes_per_device,
            "reps": self.reps,
            "mean_ms": round(self.mean_ms, 4),
            "p50_ms": round(self.p50_ms, 4),
            "p95_ms": round(self.p95_ms, 4),
            "min_ms": round(self.min_ms, 4),
        }


def _collective_fn(op: str, mesh, axis: str):
    """The op over ``axis`` as a function of this rank's shard."""
    if op == "psum":
        return lambda x: mesh_mod.all_reduce(x, mesh, axis)
    if op == "all_gather":
        return lambda x: mesh_mod.all_gather(x, mesh, axis, dim=0)
    if op == "reduce_scatter":
        return lambda x: mesh_mod.reduce_scatter(x, mesh, axis, dim=0)
    if op == "ppermute":
        return lambda x: mesh_mod.shift(x, mesh, axis, offset=1)
    raise ValueError(f"unknown collective op {op!r}")


def _default_mesh():
    """The probe mesh over the initialized default group: every rank on
    one axis (JAX's ``Mesh(jax.devices(), ("probe",))``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the collective prober needs an initialized torch.distributed group: "
            "start ranks with tpuslo_torch.parallel.mesh.run_ranks, or run "
            "python -m tpuslo_torch icibench (one NCCL rank on the card)"
        )
    return mesh_mod.tp_mesh(dist.get_world_size())


class CollectiveSuite:
    """The ops and this rank's input shard, built once.

    The input and the first call of every op happen in the constructor;
    :meth:`measure` only replays the ops, so periodic probing pays the
    set-up once, not per interval.  ``mesh`` defaults to every rank of the
    initialized group; its ``tp`` axis is the probe axis."""

    def __init__(
        self,
        mesh=None,
        payload_bytes: int = 1 << 20,
        ops: tuple[str, ...] = DEFAULT_OPS,
    ):
        axis = PROBE_AXIS
        mesh = mesh if mesh is not None else _default_mesh()
        self.mesh = mesh
        self.n_devices = mesh.shape[axis]
        n = self.n_devices
        cols = 256
        # Per-device rows rounded to a multiple of n: reduce_scatter splits
        # the shard's leading dim across the axis again.
        rows_per_dev = max(n, (payload_bytes // (4 * cols) // n) * n)
        self.payload_bytes_per_device = rows_per_dev * cols * 4
        self._x = torch.ones((rows_per_dev, cols), dtype=torch.float32, device=mesh.device)
        self._fns = {op: _collective_fn(op, mesh, axis) for op in ops}
        for fn in self._fns.values():
            fn(self._x)  # set-up round
        self._sync()

    def _sync(self) -> None:
        if self._x.device.type == "cuda":
            torch.cuda.synchronize(self._x.device)

    def _time_ms(self, fn) -> float:
        if self._x.device.type != "cuda":
            t0 = time.perf_counter()
            fn(self._x)
            return (time.perf_counter() - t0) * 1000.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(self._x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def measure(self, reps: int = 20) -> list[CollectiveProbe]:
        out: list[CollectiveProbe] = []
        for op, fn in self._fns.items():
            arr = np.asarray([self._time_ms(fn) for _ in range(reps)])
            out.append(
                CollectiveProbe(
                    op=op,
                    n_devices=self.n_devices,
                    payload_bytes_per_device=self.payload_bytes_per_device,
                    reps=reps,
                    mean_ms=float(arr.mean()),
                    p50_ms=float(np.percentile(arr, 50)),
                    p95_ms=float(np.percentile(arr, 95)),
                    min_ms=float(arr.min()),
                )
            )
        return out


def bench_collectives(
    mesh=None,
    payload_bytes: int = 1 << 20,
    reps: int = 20,
    ops: tuple[str, ...] = DEFAULT_OPS,
) -> list[CollectiveProbe]:
    """One-shot convenience: build a :class:`CollectiveSuite`, measure.
    ``payload_bytes`` is the per-device shard size; the set-up round is
    excluded."""
    return CollectiveSuite(mesh=mesh, payload_bytes=payload_bytes, ops=ops).measure(reps)


class ActiveICIProber:
    """Periodic in-agent collective prober.

    :meth:`maybe_probe` runs a probe only when ``interval_s`` has elapsed;
    a failing backend disables the prober after one log line instead of
    failing every cycle, and a probe that hangs past ``timeout_s`` (a
    collective whose peer is gone never returns) disables it too.  The
    suite (a :class:`CollectiveSuite` over the initialized group) is
    built at the first probe and kept."""

    def __init__(
        self,
        interval_s: float,
        node: str = "tpu-vm-0",
        namespace: str = "llm",
        slice_id: str = "",
        host_index: int = -1,
        payload_kb: int = 256,
        reps: int = 5,
        log=None,
        timeout_s: float = 120.0,
    ):
        self.interval_s = interval_s
        self.node = node
        self.namespace = namespace
        self.slice_id = slice_id
        self.host_index = host_index
        self.payload_kb = payload_kb
        self.reps = reps
        self.timeout_s = timeout_s
        self._next_due = 0.0  # first cycle probes immediately
        self._disabled = False
        self._suite: CollectiveSuite | None = None
        self._log = log or (lambda msg: None)

    def _probe_once(self) -> tuple["CollectiveSuite", list[CollectiveProbe]]:
        """Build-or-reuse the suite and measure; returns both without
        publishing to ``self._suite``: the caller publishes only after a
        timed join succeeds."""
        suite = self._suite
        if suite is None:
            suite = CollectiveSuite(payload_bytes=self.payload_kb * 1024)
        return suite, suite.measure(self.reps)

    def maybe_probe(self, now_monotonic: float) -> list[ProbeEventV1]:
        if self._disabled or now_monotonic < self._next_due:
            return []
        self._next_due = now_monotonic + self.interval_s
        # A collective whose peer is gone blocks with no exception, so the
        # build + measure runs in a worker thread with a join timeout: a
        # hang disables the prober instead of stalling the agent loop.
        import threading

        box: dict[str, object] = {}

        def worker():
            try:
                result = self._probe_once()
                if result is not None:
                    box["suite"], box["probes"] = result
            except Exception as exc:  # noqa: BLE001 - backend unavailable
                box["error"] = exc

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        thread.join(timeout=self.timeout_s)
        if thread.is_alive():
            self._disabled = True
            self._suite = None
            self._log(
                f"ici prober disabled: probe exceeded {self.timeout_s}s "
                "(collective hang: a peer gone?)"
            )
            return []
        if "error" in box or "probes" not in box:
            self._disabled = True
            self._log(f"ici prober disabled: {box.get('error', 'no result')}")
            return []
        self._suite = box["suite"]  # type: ignore[assignment]
        return probes_to_events(
            box["probes"],  # type: ignore[arg-type]
            node=self.node,
            namespace=self.namespace,
            slice_id=self.slice_id,
            host_index=self.host_index,
        )


def probes_to_events(
    probes: list[CollectiveProbe],
    node: str = "tpu-vm-0",
    namespace: str = "llm",
    pod: str = "icibench",
    container: str = "icibench",
    slice_id: str = "",
    host_index: int = -1,
    chip: str = "accel0",
    now: datetime | None = None,
) -> list[ProbeEventV1]:
    """One ``ici_collective_latency_ms`` probe event per measured op, its
    p95 as the value; the op rides ``tpu.module_name``
    (``collective:<op>``) so later layers can split by collective kind."""
    import os

    now = now or datetime.now(timezone.utc)
    ts = int(now.timestamp() * 1e9)
    events = []
    for probe in probes:
        value = probe.p95_ms
        events.append(
            ProbeEventV1(
                ts_unix_nano=ts,
                signal=SIGNAL_ICI_COLLECTIVE_MS,
                node=node,
                namespace=namespace,
                pod=pod,
                container=container,
                pid=os.getpid(),
                tid=os.getpid(),
                value=value,
                unit="ms",
                status=signal_status(SIGNAL_ICI_COLLECTIVE_MS, value),
                tpu=TPURef(
                    chip=chip,
                    slice_id=slice_id,
                    host_index=host_index,
                    program_id="icibench",
                    module_name=f"collective:{probe.op}",
                ),
            )
        )
    return events
