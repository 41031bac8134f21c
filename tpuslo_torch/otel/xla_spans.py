"""Device span source for the correlation engine (the port's counterpart
of ``tpuslo/otel/xla_spans.py``).

On a TPU the XLA profiler writes a trace-viewer JSON whose "XLA Modules"
lane carries one span per device execution of a compiled program,
``<module>(<program fingerprint>)`` with a ``run_id``, and whose "XLA
Ops" lane carries the ops inside it.  The port reads the same identity
from a ``torch.profiler`` (Kineto) trace.  Everything downstream of the
parse (:class:`XLASpan`, the per-launch signal folds, the ledger) is the
JAX module's; only two things change:

* **what the parser reads.**  Eager PyTorch has no per-program lane, so
  the port makes one: every dispatch that the JAX engines make as one
  jitted call (a prefill, a decode chunk, a batching step, a speculative
  round, a front-door round) opens a ``record_function`` range named
  ``<module>(<fingerprint>)#<launch>`` through :func:`dispatch_range`
  while a profiler is active.  The fingerprint hashes the module name
  with the shapes and dtypes of the dispatch's inputs (XLA's changes
  with shapes too); the launch number is a per-program run counter kept
  here.  The ops lane is the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events; ``device_pid`` is the CUDA device index
  (Kineto's ``pid`` of a device event).  The module lane comes from the
  range's ``gpu_user_annotation`` event, its extent on the device (see
  :func:`module_lane_source`).  On a TPU a module span is one program
  executing, so the time inside it is device time; an eager dispatch
  queues its kernels one by one from the host, and the extent from its
  first kernel to its last holds the host's queueing gaps.  So in a
  trace of a card (Kineto's ``cuda_runtime`` launch events present) a
  range becomes one module span per run of its own kernels (the ops the
  range holds and no range nested in it holds, merged where they touch
  or overlap), all with the range's identity: the gaps between them are
  idle to the ledger, as they are to the card.  A trace whose extents
  are executions (the seeded captures of
  :mod:`tpuslo_torch.deviceplane.synthetic`, written as XLA writes its
  lane) is read extent by extent; a trace with no device events (the
  CPU) reads the CPU-side ranges.
* **what** :class:`capture` **wraps**: ``torch.profiler.profile`` with
  CUDA activities when a card is present and CPU activities as asked
  (always without a card).  It records ``time.time_ns()`` on entry, as
  the JAX capture does, and writes the Chrome trace into ``log_dir`` in
  the JAX layout (``plugins/profile/<run>/<host>.trace.json``, plain
  JSON: gzipping it cost a capture ~0.1 s on the card; the loaders also
  read ``.trace.json.gz``), where :func:`find_trace_files` finds it.

Timestamps: a Kineto document carries ``baseTimeNanoseconds`` and its
``ts`` are microseconds relative to that base, not absolute
(``base + ts * 1000`` is the wall clock in ns, within a tenth of a
millisecond of ``time.time_ns()``); this holds for torch 2.13 on the
CPU and for torch 2.11 with CUDA 12.8 on an H100, whose traces also
carry the ``gpu_user_annotation`` extents.  Given the capture's anchor,
the parser rebases every span to microseconds after the anchor, the JAX
spans' meaning (microseconds into the capture); a document without a
base (the seeded synthetic captures) is read as it is.  Each
``gpu_user_annotation`` event is the device extent of one range (torch
2.11, CUDA 12.8, H100): the module lane never falls back to joining
kernels to the CPU-side ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import glob
import gzip
import hashlib
import json
import os
import re
import socket
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Callable, Iterator

import torch

# "frontdoor_round(13839021870486437105)" -> module + fingerprint.
_MODULE_RE = re.compile(r"^(?P<module>.+?)\((?P<fingerprint>\d+)\)$")
# "frontdoor_round(1383...)#12" -> program name + launch number.
_LAUNCH_RE = re.compile(r"^(?P<program>.+)#(?P<launch>\d+)$")

MODULES_LANE = "XLA Modules"
OPS_LANE = "XLA Ops"

#: Kineto event categories the parser reads.
CAT_GPU_ANNOTATION = "gpu_user_annotation"
CAT_CPU_ANNOTATION = "user_annotation"
#: The host's launch calls: their presence marks a trace of a card.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
OPS_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: ``device_pid`` of module spans read from CPU-side ranges (a trace
#: with no device events).
CPU_DEVICE_PID = -1


def rfc3339(ts: datetime) -> str:
    """Format a datetime as RFC3339 with a trailing Z (UTC)."""
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=timezone.utc)
    return ts.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


@dataclass
class XLASpan:
    """One device-side execution span recovered from a profiler trace."""

    name: str
    module_name: str = ""
    program_id: str = ""
    launch_id: int = -1
    start_us: float = 0.0
    duration_us: float = 0.0
    device_pid: int = -1
    lane: str = MODULES_LANE
    hlo_category: str = ""
    args: dict[str, Any] = field(default_factory=dict)

    def to_span_ref_dict(
        self,
        anchor_unix_ns: int,
        service: str = "",
        node: str = "",
        slice_id: str = "",
        host_index: int = -1,
    ) -> dict[str, Any]:
        """SpanRef-compatible dict for the correlation matcher."""
        ts_ns = anchor_unix_ns + int(self.start_us * 1_000)
        out: dict[str, Any] = {
            "timestamp": rfc3339(
                datetime.fromtimestamp(ts_ns / 1e9, tz=timezone.utc)
            ),
            "service": service,
            "node": node,
            "program_id": self.program_id,
            "launch_id": self.launch_id,
            "duration_ms": self.duration_us / 1000.0,
            "name": self.module_name or self.name,
        }
        if slice_id:
            out["slice_id"] = slice_id
        if host_index >= 0:
            out["host_index"] = host_index
        return out


# ---- the module lane: one range per dispatch ---------------------------

#: Launches so far per program fingerprint (the ``run_id`` XLA keeps).
_RUNS: dict[str, int] = {}


def _feed(h: "hashlib._Hash", x: Any) -> None:
    if isinstance(x, torch.Tensor):
        h.update(f"|{tuple(x.shape)}:{x.dtype}".encode())
    elif isinstance(x, dict):
        for key in sorted(x):
            h.update(f"|{key}".encode())
            _feed(h, x[key])
    elif isinstance(x, (list, tuple)):
        for item in x:
            _feed(h, item)
    elif isinstance(x, (bool, int, float, str)) or x is None:
        h.update(f"|{x!r}".encode())
    else:
        h.update(f"|{type(x).__name__}".encode())


def program_fingerprint(module: str, *inputs: Any) -> str:
    """Stable decimal fingerprint of a dispatch: the module name, the
    shapes and dtypes of its tensor inputs (nested dicts, lists and
    tuples are walked) and the values of its static arguments (Python
    scalars, such as a chunk length: XLA's fingerprint changes with
    them too).  Callers pass what fixes the program, never a value that
    changes from step to step."""
    h = hashlib.blake2b(module.encode(), digest_size=8)
    for x in inputs:
        _feed(h, x)
    return str(int.from_bytes(h.digest(), "big"))


class _NullRange:
    """Shared no-op range for dispatches made with no profiler active."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_RANGE = _NullRange()


def dispatch_range(module: str, *inputs: Any):
    """Context manager around one dispatch: a ``record_function`` range
    ``<module>(<fingerprint>)#<launch>`` while a profiler is active, else
    a shared no-op (the unprofiled path costs one flag read and queues
    nothing).  Inside :func:`capture_range` it opens nothing."""
    if not torch._C._autograd._profiler_enabled() or _CAPTURING[0]:
        return _NULL_RANGE
    fp = program_fingerprint(module, *inputs)
    run = _RUNS.get(fp, 0) + 1
    _RUNS[fp] = run
    return torch.profiler.record_function(f"{module}({fp})#{run}")


_CAPTURING = [0]  # depth of open capture ranges


@contextlib.contextmanager
def capture_range(module: str, *inputs: Any):
    """Context manager around a CUDA-graph capture of one dispatch, the
    port's counterpart of an XLA compile: while a profiler is active, a
    ``record_function`` range ``<module>(<fingerprint>)`` with no launch
    number, so the work it holds (the capture's warm-up run) is an
    anonymous launch that the ledger's compile tier gives to the compile
    event of the same program id; :func:`dispatch_range` opens nothing
    inside it.  Without a profiler it only marks the depth."""
    _CAPTURING[0] += 1
    try:
        if torch._C._autograd._profiler_enabled():
            fp = program_fingerprint(module, *inputs)
            with torch.profiler.record_function(f"{module}({fp})"):
                yield
        else:
            yield
    finally:
        _CAPTURING[0] -= 1


# ---- the parser ---------------------------------------------------------


def _module_span(
    raw_name: str, start_us: float, dur_us: float, pid: int, args: dict
) -> XLASpan:
    name, launch_id = raw_name, -1
    m = _LAUNCH_RE.match(raw_name)
    if m:
        name, launch_id = m.group("program"), int(m.group("launch"))
    span = XLASpan(
        name=name,
        start_us=start_us,
        duration_us=dur_us,
        device_pid=pid,
        lane=MODULES_LANE,
        launch_id=launch_id,
        args=args,
    )
    m = _MODULE_RE.match(name)
    if m:
        span.module_name = m.group("module")
        span.program_id = m.group("fingerprint")
    else:
        span.module_name = name
    return span


def _launch_owners(
    events: list[dict[str, Any]], ranges: list[dict[str, Any]]
) -> dict[Any, dict[str, Any]]:
    """{correlation id: the device range whose host range launched it}:
    each host launch call (``cuda_runtime``) goes to the innermost
    CPU-side range on its thread that contains its start, and that range
    to the device range of the same name."""
    by_name = {str(r.get("name", "")): r for r in ranges}
    cpu: dict[tuple[Any, Any], list[dict[str, Any]]] = {}
    for e in events:
        if e.get("cat") == CAT_CPU_ANNOTATION and str(e.get("name", "")) in by_name:
            cpu.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    owners: dict[Any, dict[str, Any]] = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATEGORIES:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts = float(e.get("ts", 0.0))
        best = None
        for r in cpu.get((e.get("pid"), e.get("tid")), ()):
            start = float(r.get("ts", 0.0))
            if start <= ts < start + float(r.get("dur", 0.0)) and (
                best is None or start >= float(best.get("ts", 0.0))
            ):
                best = r
        if corr is not None and best is not None:
            owners[corr] = by_name[str(best.get("name", ""))]
    return owners


def _kernel_segments(
    ranges: list[dict[str, Any]], ops: list[dict[str, Any]], shift_us: float,
    events: list[dict[str, Any]],
) -> list[XLASpan]:
    """Module spans of a card's trace: each op goes to the innermost
    range (the latest-starting ``gpu_user_annotation`` extent on its
    device that contains its start), and each range yields one span per
    run of its ops, merged where they touch or overlap.  A range that
    holds no op of its own (all its kernels are in nested ranges)
    yields none.

    Kineto may cut a range's device extent short: the kernels of a CUDA
    graph replay carry no external id, and a large replay's extent can
    end long before its last kernel (seen on an H100 with torch 2.11: 17
    ms of a 116 ms replay).  An op outside every extent therefore goes
    to the range whose host range made the launch call its correlation
    id names (:func:`_launch_owners`), when there is one."""
    by_dev: dict[int, list[dict[str, Any]]] = {}
    for r in ranges:
        by_dev.setdefault(int(r.get("pid", -1)), []).append(r)
    starts: dict[int, list[float]] = {}
    reach: dict[int, list[float]] = {}  # the latest end among ranges [0..i]
    for pid, group in by_dev.items():
        group.sort(key=lambda r: float(r.get("ts", 0.0)))
        starts[pid] = [float(r.get("ts", 0.0)) for r in group]
        far, reach[pid] = float("-inf"), []
        for r in group:
            far = max(far, float(r.get("ts", 0.0)) + float(r.get("dur", 0.0)))
            reach[pid].append(far)
    owned: dict[int, list[tuple[float, float]]] = {}
    launchers = None
    for op in ops:
        pid = int(op.get("pid", -1))
        if pid not in by_dev:
            continue
        group = by_dev[pid]
        ts = float(op.get("ts", 0.0))
        run = (ts, ts + float(op.get("dur", 0.0)))
        i = bisect.bisect_right(starts[pid], ts) - 1
        while i >= 0 and reach[pid][i] > ts:
            r = group[i]
            if ts < float(r.get("ts", 0.0)) + float(r.get("dur", 0.0)):
                owned.setdefault(id(r), []).append(run)
                break
            i -= 1
        else:
            if launchers is None:
                launchers = _launch_owners(events, ranges)
            r = launchers.get((op.get("args") or {}).get("correlation"))
            if r is not None and int(r.get("pid", -1)) == pid:
                owned.setdefault(id(r), []).append(run)
    spans: list[XLASpan] = []
    for pid, group in by_dev.items():
        for r in group:
            runs: list[list[float]] = []
            for lo, hi in sorted(owned.get(id(r), ())):
                if runs and lo <= runs[-1][1]:
                    runs[-1][1] = max(runs[-1][1], hi)
                else:
                    runs.append([lo, hi])
            for lo, hi in runs:
                spans.append(
                    _module_span(
                        str(r.get("name", "")), lo + shift_us, hi - lo, pid,
                        r.get("args", {}) or {},
                    )
                )
    return spans


def module_lane_source(data: dict[str, Any]) -> str:
    """How :func:`parse_trace_events` reads a document's module lane:
    ``"kernel_segments"`` (a card's trace: each range's device extent cut
    to the runs of its own kernels), ``"gpu_user_annotation"`` (extents
    that are executions, as in the seeded captures) or
    ``"cpu_annotation"`` (no device events: the CPU-side ranges).

    Raises ``ValueError`` for a document with device ops and CPU-side
    ranges but no ``gpu_user_annotation`` extents: its module lane cannot
    be read, and no other source stands in for it."""
    cats = {e.get("cat") for e in data.get("traceEvents", []) if e.get("ph") == "X"}
    if CAT_GPU_ANNOTATION in cats:
        if cats & set(LAUNCH_CATEGORIES):
            return "kernel_segments"
        return "gpu_user_annotation"
    if cats & set(OPS_CATEGORIES) and CAT_CPU_ANNOTATION in cats:
        raise ValueError(
            "the trace holds device ops and dispatch ranges but no "
            "gpu_user_annotation events: the ranges' device extents are "
            "missing, so the module lane cannot be read"
        )
    return "cpu_annotation"


def parse_trace_events(
    data: dict[str, Any], include_ops: bool = False, anchor_unix_ns: int = 0
) -> list[XLASpan]:
    """Module (and, with ``include_ops``, device op) spans from one
    Kineto trace document, time-sorted; the module lane is read as
    :func:`module_lane_source` says.  With ``anchor_unix_ns`` and a
    document that carries ``baseTimeNanoseconds``, start times are
    microseconds after the anchor; otherwise the document's own ``ts``."""
    events = data.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    base = data.get("baseTimeNanoseconds")
    shift_us = (
        (int(base) - int(anchor_unix_ns)) / 1000.0
        if anchor_unix_ns and base is not None
        else 0.0
    )
    spans: list[XLASpan] = []
    source = module_lane_source(data)
    gpu_ranges = [e for e in xs if e.get("cat") == CAT_GPU_ANNOTATION]
    if source == "kernel_segments":
        ops = [e for e in xs if e.get("cat") in OPS_CATEGORIES]
        spans.extend(_kernel_segments(gpu_ranges, ops, shift_us, xs))
    elif source == "gpu_user_annotation":
        for e in gpu_ranges:
            spans.append(
                _module_span(
                    str(e.get("name", "")),
                    float(e.get("ts", 0.0)) + shift_us,
                    float(e.get("dur", 0.0)),
                    int(e.get("pid", -1)),
                    e.get("args", {}) or {},
                )
            )
    else:
        for e in xs:
            if e.get("cat") == CAT_CPU_ANNOTATION:
                spans.append(
                    _module_span(
                        str(e.get("name", "")),
                        float(e.get("ts", 0.0)) + shift_us,
                        float(e.get("dur", 0.0)),
                        CPU_DEVICE_PID,
                        e.get("args", {}) or {},
                    )
                )
    if include_ops:
        for e in xs:
            cat = e.get("cat")
            if cat not in OPS_CATEGORIES:
                continue
            spans.append(
                XLASpan(
                    name=str(e.get("name", "")),
                    start_us=float(e.get("ts", 0.0)) + shift_us,
                    duration_us=float(e.get("dur", 0.0)),
                    device_pid=int(e.get("pid", -1)),
                    lane=OPS_LANE,
                    hlo_category=str(cat),
                    args=e.get("args", {}) or {},
                )
            )
    spans.sort(key=lambda s: s.start_us)
    return spans


def find_trace_files(log_dir: str) -> list[str]:
    """All per-host trace files under a profiler log dir, newest
    profile run first, host files sorted within a run."""
    runs = sorted(
        glob.glob(os.path.join(log_dir, "plugins", "profile", "*")),
        key=os.path.basename,
        reverse=True,
    )
    out: list[str] = []
    for run in runs:
        out.extend(sorted(
            glob.glob(os.path.join(run, "*.trace.json.gz"))
            + glob.glob(os.path.join(run, "*.trace.json"))
        ))
    return out


def _host_of(path: str) -> str:
    """A trace file's host: its name without the fixed suffix (dotted
    hostnames stay distinct)."""
    name = os.path.basename(path)
    return name[: -len(".gz")] if name.endswith(".gz") else name


def load_trace_file(
    path: str, include_ops: bool = False, anchor_unix_ns: int = 0
) -> list[XLASpan]:
    """Spans of one trace file, gzipped (``.trace.json.gz``) or plain."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        return parse_trace_events(
            json.load(fh), include_ops=include_ops, anchor_unix_ns=anchor_unix_ns
        )


def load_latest_trace_by_host(
    log_dir: str, include_ops: bool = False, anchor_unix_ns: int = 0
) -> dict[str, list[XLASpan]]:
    """Newest profile run's spans, keyed by host (trace-file stem).

    Per-host grouping matters on multi-host deployments: each host's
    file has its own launch counters, so merging hosts would collide the
    exact-identity (program_id, launch_id) join.
    """
    files = find_trace_files(log_dir)
    if not files:
        return {}
    run_dir = os.path.dirname(files[0])
    out: dict[str, list[XLASpan]] = {}
    for path in files:
        if os.path.dirname(path) != run_dir:
            break
        # Strip the fixed suffix only: dotted hostnames must stay
        # distinct or per-host launch counters would collide.
        host = _host_of(path)[: -len(".trace.json")]
        out.setdefault(host, []).extend(
            load_trace_file(
                path, include_ops=include_ops, anchor_unix_ns=anchor_unix_ns
            )
        )
    for spans in out.values():
        spans.sort(key=lambda s: s.start_us)
    return out


def load_latest_trace(
    log_dir: str, include_ops: bool = False, anchor_unix_ns: int = 0
) -> list[XLASpan]:
    """Spans from the newest profile run, all hosts merged time-sorted.

    Use :func:`load_latest_trace_by_host` across hosts: merged launch
    ids are only unique per host file.
    """
    spans: list[XLASpan] = []
    for host_spans in load_latest_trace_by_host(
        log_dir, include_ops=include_ops, anchor_unix_ns=anchor_unix_ns
    ).values():
        spans.extend(host_spans)
    spans.sort(key=lambda s: s.start_us)
    return spans


#: NCCL's collective kernels, by name prefix (the XLA HLO categories'
#: counterpart: all-reduce, all-gather, reduce-scatter, broadcast and
#: the send/recv pairs of all-to-all and permutes all launch one).
COLLECTIVE_MARKERS = ("ncclKernel_", "ncclDevKernel_")


def is_collective_op(span: XLASpan) -> bool:
    """Does this ops-lane span belong to a cross-device collective?"""
    if span.lane != OPS_LANE:
        return False
    return span.name.startswith(COLLECTIVE_MARKERS)


def _sum_ops_by_launch(
    spans: list[XLASpan], op_filter: Callable[[XLASpan], bool]
) -> tuple[dict[tuple[str, int], float], dict[tuple[str, int], XLASpan]]:
    """Sum filtered ops-lane durations into their enclosing launches.

    Returns ``(totals_ms, anchor_mod)`` keyed by the launch's
    ``(program_id, launch_id)`` identity.  Module launches are grouped
    per device: devices of one host run the same launch concurrently,
    so containment must pair an op with *its own device's* module span
    or op time gets double-counted onto whichever device sorts first.
    """
    mods_by_dev: dict[int, list[XLASpan]] = {}
    for s in spans:
        if s.lane == MODULES_LANE:
            mods_by_dev.setdefault(s.device_pid, []).append(s)
    starts_by_dev: dict[int, list[float]] = {}
    for dev, mods in mods_by_dev.items():
        mods.sort(key=lambda s: s.start_us)
        starts_by_dev[dev] = [m.start_us for m in mods]

    totals: dict[tuple[str, int], float] = {}
    anchor_mod: dict[tuple[str, int], XLASpan] = {}
    for op in spans:
        if op.lane != OPS_LANE or not op_filter(op):
            continue
        mods = mods_by_dev.get(op.device_pid, [])
        idx = bisect.bisect_right(starts_by_dev.get(op.device_pid, []), op.start_us) - 1
        if idx < 0:
            continue
        mod = mods[idx]
        if not op.start_us < mod.start_us + mod.duration_us:
            continue
        if mod.launch_id >= 0:
            key = (mod.program_id, mod.launch_id)
        else:
            # No launch number: key the anonymous launch by its own
            # module span (device + start) so all its ops still sum
            # into one event; it cannot merge across devices.
            key = (
                f"{mod.program_id}#anon@{mod.device_pid}:{mod.start_us}",
                -1,
            )
        totals[key] = totals.get(key, 0.0) + op.duration_us / 1000.0
        prior = anchor_mod.get(key)
        if prior is None or mod.start_us < prior.start_us:
            anchor_mod[key] = mod
    return totals, anchor_mod


def _launch_signal_events(
    totals: dict[tuple[str, int], float],
    anchor_mod: dict[tuple[str, int], XLASpan],
    signal: str,
    anchor_unix_ns: int,
    node: str,
    slice_id: str,
    host_index: int,
    namespace: str,
    pod: str,
    chip: str,
) -> list[dict[str, Any]]:
    """Per-launch probe events from aggregated op totals."""
    from tpuslo_torch.signals.generator import signal_status

    out: list[dict[str, Any]] = []
    for key, total_ms in sorted(
        totals.items(), key=lambda kv: anchor_mod[kv[0]].start_us
    ):
        mod = anchor_mod[key]
        tpu: dict[str, Any] = {"chip": chip}
        if slice_id:
            tpu["slice_id"] = slice_id
        if host_index >= 0:
            tpu["host_index"] = host_index
        if mod.program_id:
            tpu["program_id"] = mod.program_id
        if mod.launch_id >= 0:
            tpu["launch_id"] = mod.launch_id
        if mod.module_name:
            tpu["module_name"] = mod.module_name
        out.append(
            {
                "ts_unix_nano": anchor_unix_ns + int(mod.start_us * 1_000),
                "signal": signal,
                "node": node,
                "namespace": namespace,
                "pod": pod or node,
                "container": "xprof",
                "pid": 0,
                "tid": 0,
                "value": round(total_ms, 4),
                "unit": "ms",
                "status": signal_status(signal, total_ms),
                "tpu": tpu,
            }
        )
    return out


def extract_collective_signals(
    spans: list[XLASpan],
    anchor_unix_ns: int,
    node: str = "",
    slice_id: str = "",
    host_index: int = -1,
    namespace: str = "llm-slo",
    pod: str = "",
    chip: str = "accel0",
) -> list[dict[str, Any]]:
    """``ici_collective_latency_ms`` probe events from one host's trace:
    each collective kernel in the ops lane is assigned to its enclosing
    module launch by time containment and summed per launch into one
    event carrying the launch's ``program_id``/``launch_id`` identity.
    Needs a trace parsed with ``include_ops=True``."""
    totals, anchor_mod = _sum_ops_by_launch(spans, is_collective_op)
    return _launch_signal_events(
        totals,
        anchor_mod,
        "ici_collective_latency_ms",
        anchor_unix_ns,
        node,
        slice_id,
        host_index,
        namespace,
        pod,
        chip,
    )


def extract_device_time_signals(
    spans: list[XLASpan],
    anchor_unix_ns: int,
    node: str = "",
    slice_id: str = "",
    host_index: int = -1,
    namespace: str = "llm-slo",
    pod: str = "",
    chip: str = "accel0",
) -> list[dict[str, Any]]:
    """``xla_device_time_ms`` probe events: per-launch device time, every
    ops-lane event summed into its enclosing module launch (the
    single-device analog of :func:`extract_collective_signals`).  Needs a
    trace parsed with ``include_ops=True``."""
    totals, anchor_mod = _sum_ops_by_launch(spans, lambda _op: True)
    return _launch_signal_events(
        totals,
        anchor_mod,
        "xla_device_time_ms",
        anchor_unix_ns,
        node,
        slice_id,
        host_index,
        namespace,
        pod,
        chip,
    )


def extract_collective_signals_by_host(
    spans_by_host: dict[str, list[XLASpan]],
    anchor_unix_ns: int,
    identities: dict[str, dict[str, Any]] | None = None,
    slice_id: str = "",
    namespace: str = "llm-slo",
) -> list[dict[str, Any]]:
    """Flat event list over every host.  ``identities`` maps trace-file
    stem → ``{"node": .., "host_index": ..}``; hosts default to their
    stem and list position."""
    identities = identities or {}
    out: list[dict[str, Any]] = []
    for pos, (host, spans) in enumerate(sorted(spans_by_host.items())):
        ident = identities.get(host, {})
        out.extend(
            extract_collective_signals(
                spans,
                anchor_unix_ns,
                node=ident.get("node", host),
                slice_id=slice_id,
                host_index=int(ident.get("host_index", pos)),
                namespace=namespace,
            )
        )
    return out


def launch_match_breakdown(
    spans: list[XLASpan],
    compile_events: list[Any] | None = None,
    ledger: Any | None = None,
) -> dict[str, Any]:
    """Explain every module-lane launch that produced no device-time
    signal, from the device-plane ledger
    (:func:`tpuslo_torch.deviceplane.ledger.build_ledger`), the one
    source of both the raw and the substantive join rates.  Reason
    classes: ``no_ops_lane`` (no ops events on that device),
    ``no_contained_ops`` (a dispatch that queued no device work inside
    its window), ``ops_assigned_to_overlapping_launch``,
    ``ops_on_split_lane`` and ``anonymous_launch`` (no launch number).
    ``reasons`` counts only launches that did NOT end up joined.  Every
    count is of dispatches, each read through the record that stands for
    it (:func:`~tpuslo_torch.deviceplane.ledger.dispatch_records`).  Pass a
    prebuilt ``ledger`` (from the same spans and compile events) to
    avoid folding twice."""
    from tpuslo_torch.deviceplane.ledger import (
        BUCKET_JOINED,
        BUCKET_UNEXPLAINED,
        build_ledger,
        dispatch_records,
    )

    if ledger is None:
        ledger = build_ledger(spans, compile_events or ())
    reasons: dict[str, int] = {}
    unmatched: list[dict[str, Any]] = []
    dispatches = dispatch_records(ledger.launches)
    for rec in dispatches:
        if rec.tier == "identity":
            continue  # the exact join serves these
        if rec.reason and rec.bucket != BUCKET_JOINED:
            reasons[rec.reason] = reasons.get(rec.reason, 0) + 1
        if rec.ops_source != "own" and (
            rec.bucket == BUCKET_UNEXPLAINED or rec.ops_source == ""
        ):
            unmatched.append(
                {
                    "module": rec.module_name or rec.name,
                    "program_id": rec.program_id,
                    "launch_id": rec.launch_id,
                    "duration_us": round(rec.duration_us, 1),
                    "reason": rec.reason,
                    "tier": rec.tier,
                    "bucket": rec.bucket,
                }
            )
    return {
        "launches": len(dispatches),
        "launches_with_ops": ledger.launches_with_ops,
        "unmatched_count": len(unmatched),
        "reasons": reasons,
        "unmatched": unmatched[:24],
        "substantive_join_rate": round(
            ledger.exact_substantive_join_rate, 4
        ),
        "ledger_substantive_join_rate": round(
            ledger.substantive_join_rate, 4
        ),
        "raw_join_rate": round(ledger.raw_join_rate, 4),
        "ledger": ledger.to_dict(),
    }


_RUN_SEQ = [0]


def _run_dir_name() -> str:
    """A profile-run directory name that sorts by time, unique within
    the process (several captures can land in one second)."""
    _RUN_SEQ[0] += 1
    ns = time.time_ns()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime(ns / 1e9))
    return f"{stamp}_{ns % 1_000_000_000:09d}_{_RUN_SEQ[0]:06d}"


def _category(e) -> str:
    """A Kineto event's Chrome-trace category.  torch 2.13 names it
    (``activity_type``); torch 2.11 does not, and it is told from the
    device, the user-annotation flag and the name: on the device a
    range's extent, a copy (``Memcpy ...``), a fill (``Memset ...``) or
    a kernel; on the host a range, a CUDA runtime or driver call
    (``cuda...``/``cu...``) or an operator."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if e.is_user_annotation():
            return CAT_GPU_ANNOTATION
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return CAT_CPU_ANNOTATION
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("cu"):
        return "cuda_driver"
    return "cpu_op"


def _doc_from_events(profile, anchor_unix_ns: int) -> dict[str, Any]:
    """The fields :func:`parse_trace_events` reads, from a finished
    ``torch.profiler`` run's in-memory Kineto events (no re-read of the
    exported trace): each event's category, name, ``pid`` (device index;
    the process on the host), ``tid`` (stream; thread on the host) and
    correlation id as the Chrome export writes them, its times in
    microseconds after ``anchor_unix_ns`` (the document's base)."""
    events = []
    for e in profile.profiler.kineto_results.events():
        events.append({
            "ph": "X", "cat": _category(e), "name": e.name(),
            "pid": e.device_index(), "tid": e.device_resource_id(),
            "ts": (e.start_ns() - anchor_unix_ns) / 1000.0,
            "dur": e.duration_ns() / 1000.0,
            "args": {"correlation": e.correlation_id()},
        })
    return {"traceEvents": events, "baseTimeNanoseconds": anchor_unix_ns}


class capture:
    """Context manager: profile a workload region and yield its spans.

    Wraps ``torch.profiler.profile`` (CPU activity, and CUDA when a card
    is present: without CPU activity the profiler records no
    ``record_function`` range, so no module lane) and records the
    wall-clock anchor, so
    ``span_refs()`` emits absolute timestamps the matcher can join
    against probe events::

        with xla_spans.capture(tmpdir, include_ops=True) as cap:
            engine.step()
        refs = cap.span_refs(service="frontdoor", node="host-0")

    On exit the device is synchronized (so that the region's kernels are
    in the trace), the Chrome trace is written under ``log_dir``
    (``<host>.trace.json``, as the profiler exports it, for the readers
    of the trace directory) and the spans are parsed from the profiler's
    in-memory events (:func:`_doc_from_events`; reading the export back
    cost ~35 ms more per window of a front-door step on the card).
    ``module_source`` says how the module lane was read (see
    :func:`module_lane_source`; a card's trace without the ranges'
    device extents raises), ``stages_ms`` what each stage of the exit
    cost, and ``profile`` holds the profiler for callers that want its
    own tables.
    """

    def __init__(self, log_dir: str, include_ops: bool = False):
        self.log_dir = log_dir
        self.include_ops = include_ops
        self.anchor_unix_ns = 0
        self.spans: list[XLASpan] = []
        self.spans_by_host: dict[str, list[XLASpan]] = {}
        self.trace_path = ""
        self.module_source = ""
        self.stages_ms: dict[str, float] = {}
        self.profile = None

    def __enter__(self) -> "capture":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.anchor_unix_ns = time.time_ns()
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stages = self.stages_ms = {}
        mark = [time.perf_counter()]

        def lap(stage: str) -> None:
            now = time.perf_counter()
            stages[stage] = (now - mark[0]) * 1000.0
            mark[0] = now

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        lap("synchronize")
        self.profile.__exit__(exc_type, exc, tb)
        lap("stop")
        if exc_type is not None:
            return
        run_dir = os.path.join(
            self.log_dir, "plugins", "profile", _run_dir_name()
        )
        os.makedirs(run_dir, exist_ok=True)
        host = socket.gethostname()
        self.trace_path = os.path.join(run_dir, f"{host}.trace.json")
        # Reading a trace builds hundreds of thousands of short-lived
        # objects: the cyclic collector's passes over the whole heap in
        # the middle of it are most of the parse's spread.
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.profile.export_chrome_trace(self.trace_path)
            lap("export")
            doc = _doc_from_events(self.profile, self.anchor_unix_ns)
            lap("events")
            self.module_source = module_lane_source(doc)
            lap("source")
            self.spans_by_host = {
                host: parse_trace_events(
                    doc, include_ops=self.include_ops,
                    anchor_unix_ns=self.anchor_unix_ns,
                )
            }
            self.spans = list(self.spans_by_host[host])
            lap("parse")
        finally:
            if collecting:
                gc.enable()

    def span_refs(
        self,
        service: str = "",
        node: str = "",
        slice_id: str = "",
        host_index: int = -1,
        modules_only: bool = True,
    ) -> list[dict[str, Any]]:
        """Single-host convenience; several host files must be labelled
        per host (launch ids are only unique within one host's file)."""
        if len(self.spans_by_host) > 1 and (node or host_index >= 0):
            raise ValueError(
                "multiple host trace files captured; use "
                "span_refs_by_host() to label each host correctly"
            )
        return [
            s.to_span_ref_dict(
                self.anchor_unix_ns,
                service=service,
                node=node,
                slice_id=slice_id,
                host_index=host_index,
            )
            for s in self.spans
            if (not modules_only) or s.lane == MODULES_LANE
        ]

    def span_refs_by_host(
        self,
        identities: dict[str, dict[str, Any]],
        service: str = "",
        slice_id: str = "",
        modules_only: bool = True,
    ) -> dict[str, list[dict[str, Any]]]:
        """Per-host span refs; ``identities`` maps trace-file stem →
        ``{"node": ..., "host_index": ...}`` labels."""
        out: dict[str, list[dict[str, Any]]] = {}
        for host, spans in self.spans_by_host.items():
            ident = identities.get(host, {})
            out[host] = [
                s.to_span_ref_dict(
                    self.anchor_unix_ns,
                    service=service,
                    node=ident.get("node", host),
                    slice_id=slice_id,
                    host_index=int(ident.get("host_index", -1)),
                )
                for s in spans
                if (not modules_only) or s.lane == MODULES_LANE
            ]
        return out

    def launches(self) -> Iterator[XLASpan]:
        """Module spans only: one per dispatch, or on a card one per run
        of a dispatch's kernels (each with the dispatch's identity)."""
        return (s for s in self.spans if s.lane == MODULES_LANE)
