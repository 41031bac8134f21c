"""Structural fast-path validation for the probe-event hot loop
(the port's own copy of ``tpuslo/schema/fastpath.py``).

The node agent validates every probe event before it crosses a process
boundary.  Running the full contract validator per event costs far more
than the event, so the hot path uses a hand-rolled structural check of
the known :class:`ProbeEventV1` shape instead:

* **Fast path** — type/range/enum checks written directly against the
  ``v1alpha1/probe-event`` contract.  It only ever answers "definitely
  valid"; anything it cannot prove falls through.
* **Slow path** — the full contract validator
  (:mod:`tpuslo_torch.schema.validator`) remains the source of truth for
  every payload the fast path could not accept, so the combined result is
  always exactly what the full validator would say
  (tests/test_torch_schema.py locks the parity in).

The object-level check (:func:`fast_probe_event_valid`) additionally
skips ``to_dict`` entirely for well-formed events, which is where the
bulk of the per-event win comes from.

Counters are plain ints guarded only by the GIL: a lost increment under
contention is acceptable for diagnostics, a lock on the hot path is not.
"""

from __future__ import annotations

from typing import Any

from tpuslo_torch.schema.types import ConnTuple, ProbeEventV1, TPURef
from tpuslo_torch.schema.validator import SCHEMA_PROBE_EVENT, is_valid

_STATUSES = frozenset({"ok", "warning", "error"})

_REQUIRED_KEYS = (
    "ts_unix_nano",
    "signal",
    "node",
    "namespace",
    "pod",
    "container",
    "pid",
    "tid",
    "value",
    "unit",
    "status",
)
# Public aliases for consumers that classify rejections (ingest gate).
REQUIRED_PROBE_KEYS = _REQUIRED_KEYS
_ALLOWED_KEYS = frozenset(_REQUIRED_KEYS) | {
    "conn_tuple",
    "trace_id",
    "span_id",
    "errno",
    "confidence",
    "tpu",
}
_STR_KEYS = ("signal", "node", "namespace", "pod", "container", "unit")
_CONN_KEYS = frozenset({"src_ip", "dst_ip", "src_port", "dst_port", "protocol"})
_TPU_ALLOWED_KEYS = frozenset(
    {
        "chip",
        "slice_id",
        "host_index",
        "ici_link",
        "program_id",
        "launch_id",
        "module_name",
    }
)
_TPU_STR_KEYS = ("chip", "slice_id", "program_id", "module_name")
_TPU_INT_KEYS = ("host_index", "ici_link", "launch_id")


class ValidationCounters:
    """Process-wide tallies proving which validation path ran.

    ``fastpath_valid``     — events accepted without the full validator.
    ``fastpath_fallback``  — events the fast path could not prove valid.
    ``slowpath_valid``     — fallbacks the full validator then accepted.
    ``slowpath_invalid``   — fallbacks the full validator rejected (true drops).
    """

    __slots__ = (
        "fastpath_valid",
        "fastpath_fallback",
        "slowpath_valid",
        "slowpath_invalid",
    )

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.fastpath_valid = 0
        self.fastpath_fallback = 0
        self.slowpath_valid = 0
        self.slowpath_invalid = 0

    @property
    def engaged(self) -> bool:
        """True once the fast path has accepted at least one event."""
        return self.fastpath_valid > 0

    def snapshot(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


VALIDATION_COUNTERS = ValidationCounters()


def _is_int(value: Any) -> bool:
    # `bool` is an int subclass in Python but NOT an integer to
    # the full validator, so the check must be on the exact type.
    return type(value) is int


def _is_num(value: Any) -> bool:
    return type(value) is int or type(value) is float


def fast_probe_event_valid(event: ProbeEventV1) -> bool:
    """Prove a :class:`ProbeEventV1` valid without building its dict.

    Returns False (meaning "fall back to the full validator", not "invalid")
    whenever any field deviates from the canonical shape.
    """
    try:
        if type(event) is not ProbeEventV1:
            return False
        if not _is_int(event.ts_unix_nano) or event.ts_unix_nano < 0:
            return False
        if (
            type(event.signal) is not str
            or type(event.node) is not str
            or type(event.namespace) is not str
            or type(event.pod) is not str
            or type(event.container) is not str
            or type(event.unit) is not str
            or type(event.trace_id) is not str
            or type(event.span_id) is not str
        ):
            return False
        if not _is_int(event.pid) or event.pid < 0:
            return False
        if not _is_int(event.tid) or event.tid < 0:
            return False
        if not _is_num(event.value):
            return False
        if event.status not in _STATUSES:
            return False
        if event.errno is not None and not _is_int(event.errno):
            return False
        confidence = event.confidence
        if confidence is not None and (
            not _is_num(confidence) or confidence < 0 or confidence > 1
        ):
            return False
        conn = event.conn_tuple
        if conn is not None:
            if type(conn) is not ConnTuple:
                return False
            if (
                type(conn.src_ip) is not str
                or type(conn.dst_ip) is not str
                or type(conn.protocol) is not str
            ):
                return False
            if not _is_int(conn.src_port) or not 0 <= conn.src_port <= 65535:
                return False
            if not _is_int(conn.dst_port) or not 0 <= conn.dst_port <= 65535:
                return False
        tpu = event.tpu
        if tpu is not None:
            if type(tpu) is not TPURef:
                return False
            if (
                type(tpu.chip) is not str
                or type(tpu.slice_id) is not str
                or type(tpu.program_id) is not str
                or type(tpu.module_name) is not str
            ):
                return False
            # Negative ints are fine: to_dict omits them, and the
            # schema minimums only apply to fields actually emitted.
            if (
                not _is_int(tpu.host_index)
                or not _is_int(tpu.ici_link)
                or not _is_int(tpu.launch_id)
            ):
                return False
        return True
    except (AttributeError, TypeError):
        return False


def fast_probe_payload_valid(payload: Any) -> bool:
    """Prove a payload dict valid against the probe-event contract.

    The dict-level twin of :func:`fast_probe_event_valid`, for emit
    sites that already hold serialized payloads.  Same contract: a True
    is definitive, a False only means "let the full validator decide".
    """
    try:
        if type(payload) is not dict or not _ALLOWED_KEYS.issuperset(payload):
            return False
        ts = payload.get("ts_unix_nano")
        if not _is_int(ts) or ts < 0:
            return False
        for key in _STR_KEYS:
            if type(payload.get(key)) is not str:
                return False
        pid = payload.get("pid")
        if not _is_int(pid) or pid < 0:
            return False
        tid = payload.get("tid")
        if not _is_int(tid) or tid < 0:
            return False
        if not _is_num(payload.get("value")):
            return False
        if payload.get("status") not in _STATUSES:
            return False
        # Optional scalar fields: absent is fine, present must typecheck.
        for key in ("trace_id", "span_id"):
            if key in payload and type(payload[key]) is not str:
                return False
        if "errno" in payload and not _is_int(payload["errno"]):
            return False
        if "confidence" in payload:
            confidence = payload["confidence"]
            if not _is_num(confidence) or confidence < 0 or confidence > 1:
                return False
        if "conn_tuple" in payload:
            conn = payload["conn_tuple"]
            # All five keys required, additionalProperties false.
            if type(conn) is not dict or frozenset(conn) != _CONN_KEYS:
                return False
            if (
                type(conn["src_ip"]) is not str
                or type(conn["dst_ip"]) is not str
                or type(conn["protocol"]) is not str
            ):
                return False
            for key in ("src_port", "dst_port"):
                port = conn[key]
                if not _is_int(port) or not 0 <= port <= 65535:
                    return False
        if "tpu" in payload:
            tpu = payload["tpu"]
            if type(tpu) is not dict or not _TPU_ALLOWED_KEYS.issuperset(tpu):
                return False
            for key in _TPU_STR_KEYS:
                if key in tpu and type(tpu[key]) is not str:
                    return False
            for key in _TPU_INT_KEYS:
                if key in tpu and (not _is_int(tpu[key]) or tpu[key] < 0):
                    return False
        return True
    except TypeError:
        return False


def validate_probe_event(event: ProbeEventV1) -> bool:
    """Hot-path probe validation: structural fast path, full-validator fallback."""
    counters = VALIDATION_COUNTERS
    if fast_probe_event_valid(event):
        counters.fastpath_valid += 1
        return True
    counters.fastpath_fallback += 1
    ok = is_valid(event.to_dict(), SCHEMA_PROBE_EVENT)
    if ok:
        counters.slowpath_valid += 1
    else:
        counters.slowpath_invalid += 1
    return ok


# Reason classes for payloads the combined validator rejected.  Kept
# beside the rules they mirror so a new/tightened fast-path rule and
# its classification are edited (and reviewed) together.
REJECT_NOT_OBJECT = "not_object"
REJECT_MISSING_FIELD = "missing_field"
REJECT_BAD_FIELD_TYPE = "bad_field_type"
REJECT_SCHEMA = "schema_reject"


def classify_probe_payload_reject(payload: Any) -> str:
    """Why a payload failed validation (call only after a reject).

    Coarser than the full validator's error list — these are quarantine-triage
    buckets, not error messages: framing bugs (``not_object``),
    producer version skew (``missing_field``), corruption
    (``bad_field_type``), and everything structurally typed but
    contract-violating (``schema_reject``).
    """
    if type(payload) is not dict:
        return REJECT_NOT_OBJECT
    if any(key not in payload for key in _REQUIRED_KEYS):
        return REJECT_MISSING_FIELD
    ts = payload.get("ts_unix_nano")
    checks = (
        _is_int(ts) and ts >= 0,
        all(type(payload.get(key)) is str for key in _STR_KEYS),
        _is_int(payload.get("pid")) and payload.get("pid", -1) >= 0,
        _is_int(payload.get("tid")) and payload.get("tid", -1) >= 0,
        _is_num(payload.get("value")),
        payload.get("status") in _STATUSES,
    )
    if not all(checks):
        return REJECT_BAD_FIELD_TYPE
    return REJECT_SCHEMA


def validate_probe_payload(payload: dict[str, Any]) -> bool:
    """Dict-level hot-path validation with the same fallback contract."""
    counters = VALIDATION_COUNTERS
    if fast_probe_payload_valid(payload):
        counters.fastpath_valid += 1
        return True
    counters.fastpath_fallback += 1
    ok = is_valid(payload, SCHEMA_PROBE_EVENT)
    if ok:
        counters.slowpath_valid += 1
    else:
        counters.slowpath_invalid += 1
    return ok
