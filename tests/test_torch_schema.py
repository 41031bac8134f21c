"""The port's contract layer against the JAX package's.

Mirrors ``tests/test_schema.py`` and ``tests/test_validator_fastpath.py``
on ``tpuslo_torch.schema``, then sweeps the four contracts: on every
payload those tests use, and on payloads mutated from a full valid
instance of each contract (each required key dropped, each enum broken,
each bound crossed, each type changed, an extra key where none is
allowed, bad date-times), the port's own checker and the JAX package's
``jsonschema`` validator must say the same, valid or not.
"""

from __future__ import annotations

import copy
import json
from datetime import datetime, timezone

import pytest

from tpuslo import schema as jschema
from tpuslo_torch import schema
from tpuslo_torch import signals
from tpuslo_torch.collector import synthetic
from tpuslo_torch.schema import (
    SCHEMA_PROBE_EVENT,
    VALIDATION_COUNTERS,
    ConnTuple,
    ProbeEventV1,
    TPURef,
    fast_probe_event_valid,
    fast_probe_payload_valid,
    is_valid,
    validate_probe_event,
    validate_probe_payload,
)
from tpuslo_torch.schema import validator

TS = datetime(2026, 7, 29, 12, 0, 0, tzinfo=timezone.utc)


def make_slo_event(**overrides):
    ev = schema.SLOEvent(
        event_id="req-0001-ttft_ms",
        timestamp=TS,
        cluster="tpu-cluster",
        namespace="llm",
        workload="rag-service",
        service="rag-service",
        request_id="req-0001",
        sli_name="ttft_ms",
        sli_value=340.0,
        unit="ms",
        status="ok",
        trace_id="trace-0001",
        labels={"source": "synthetic"},
    )
    for k, v in overrides.items():
        setattr(ev, k, v)
    return ev


def make_probe_event(**overrides):
    ev = schema.ProbeEventV1(
        ts_unix_nano=int(TS.timestamp() * 1e9),
        signal="dns_latency_ms",
        node="tpu-vm-0",
        namespace="llm",
        pod="rag-service-abc",
        container="rag",
        pid=1234,
        tid=1234,
        value=12.0,
        unit="ms",
        status="ok",
        conn_tuple=schema.ConnTuple("10.0.0.10", "10.0.0.53", 42424, 53, "udp"),
    )
    for k, v in overrides.items():
        setattr(ev, k, v)
    return ev


def make_attribution(domain="network_dns"):
    return schema.IncidentAttribution(
        incident_id="inc-0001",
        timestamp=TS,
        cluster="tpu-cluster",
        service="rag-service",
        predicted_fault_domain=domain,
        confidence=0.92,
        evidence=[
            schema.Evidence("dns_latency_ms", 220.0, "ebpf"),
            schema.Evidence("fault_label", "dns_latency", "application"),
        ],
        slo_impact=schema.SLOImpact("ttft_ms", 2.4, 30),
        trace_ids=["trace-0001"],
        request_ids=["req-0001"],
        fault_hypotheses=[
            schema.FaultHypothesis("network_dns", 0.92, ["dns_latency_ms"]),
            schema.FaultHypothesis("network_egress", 0.05, []),
        ],
    )


# ---- tests/test_schema.py, on the port ------------------------------------


class TestSLOEvent:
    def test_valid_event_passes_contract(self):
        schema.validate(make_slo_event().to_dict(), schema.SCHEMA_SLO_EVENT)

    def test_timestamp_rfc3339_z_suffix(self):
        payload = make_slo_event().to_dict()
        assert payload["timestamp"] == "2026-07-29T12:00:00Z"

    @pytest.mark.parametrize("field,value", [("status", "exploded"),
                                             ("sli_name", "nonsense_sli")])
    def test_bad_enum_rejected(self, field, value):
        payload = make_slo_event(**{field: value}).to_dict()
        with pytest.raises(schema.SchemaValidationError):
            schema.validate(payload, schema.SCHEMA_SLO_EVENT)

    def test_missing_required_field_rejected(self):
        payload = make_slo_event().to_dict()
        del payload["cluster"]
        with pytest.raises(schema.SchemaValidationError, match="cluster"):
            schema.validate(payload, schema.SCHEMA_SLO_EVENT)

    def test_empty_trace_id_omitted(self):
        payload = make_slo_event(trace_id="").to_dict()
        assert "trace_id" not in payload
        schema.validate(payload, schema.SCHEMA_SLO_EVENT)

    def test_payload_equals_jax(self):
        jev = jschema.SLOEvent(**{f: getattr(make_slo_event(), f)
                                  for f in make_slo_event().__dataclass_fields__})
        assert make_slo_event().to_dict() == jev.to_dict()


class TestProbeEvent:
    def test_valid_probe_passes_contract(self):
        schema.validate(make_probe_event().to_dict(), schema.SCHEMA_PROBE_EVENT)

    def test_tpu_block_round_trips(self):
        ev = make_probe_event(
            signal="xla_compile_ms",
            conn_tuple=None,
            tpu=schema.TPURef(
                chip="accel0", slice_id="v5e-8-slice0", host_index=0,
                program_id="jit_train_step", launch_id=17,
                module_name="jit_train_step.17",
            ),
        )
        payload = ev.to_dict()
        assert payload["tpu"]["chip"] == "accel0"
        assert payload["tpu"]["launch_id"] == 17
        assert "ici_link" not in payload["tpu"]
        schema.validate(payload, schema.SCHEMA_PROBE_EVENT)
        assert schema.ProbeEventV1.from_dict(payload).to_dict() == payload
        assert jschema.ProbeEventV1.from_dict(payload).to_dict() == payload

    def test_errno_and_confidence_serialised(self):
        payload = make_probe_event(errno=110, confidence=0.9).to_dict()
        assert payload["errno"] == 110
        assert payload["confidence"] == 0.9
        schema.validate(payload, schema.SCHEMA_PROBE_EVENT)

    def test_conn_tuple_key_is_canonical(self):
        tup = schema.ConnTuple("1.2.3.4", "5.6.7.8", 1111, 443, "tcp")
        assert tup.key() == "tcp:1.2.3.4:1111->5.6.7.8:443"
        assert tup.key() == jschema.ConnTuple("1.2.3.4", "5.6.7.8", 1111, 443, "tcp").key()

    def test_invalid_status_rejected(self):
        payload = make_probe_event(status="breach").to_dict()
        with pytest.raises(schema.SchemaValidationError):
            schema.validate(payload, schema.SCHEMA_PROBE_EVENT)

    def test_negative_port_rejected(self):
        payload = make_probe_event(
            conn_tuple=schema.ConnTuple("1.2.3.4", "5.6.7.8", -1, 443, "tcp")
        ).to_dict()
        with pytest.raises(schema.SchemaValidationError, match="minimum"):
            schema.validate(payload, schema.SCHEMA_PROBE_EVENT)


class TestIncidentAttribution:
    def test_valid_attribution_passes_contract(self):
        schema.validate(make_attribution().to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)

    @pytest.mark.parametrize(
        "domain", ["tpu_ici", "tpu_hbm", "xla_compile", "host_offload"]
    )
    def test_tpu_fault_domains_accepted(self, domain):
        schema.validate(
            make_attribution(domain=domain).to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION
        )

    def test_unknown_domain_rejected(self):
        payload = make_attribution(domain="gpu_meltdown").to_dict()
        with pytest.raises(schema.SchemaValidationError):
            schema.validate(payload, schema.SCHEMA_INCIDENT_ATTRIBUTION)

    def test_confidence_out_of_range_rejected(self):
        bad = make_attribution()
        bad.confidence = 1.7
        with pytest.raises(schema.SchemaValidationError):
            schema.validate(bad.to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)

    def test_libtpu_evidence_source_accepted(self):
        att = make_attribution(domain="tpu_hbm")
        att.evidence = [schema.Evidence("hbm_alloc_stall_ms", 45.0, "libtpu")]
        schema.validate(att.to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)


class TestSchemaCompilation:
    def test_all_schemas_load(self):
        for name in schema.ALL_SCHEMAS:
            assert schema.load_schema(name)["$schema"]

    def test_contracts_are_byte_copies(self):
        for name in schema.ALL_SCHEMAS:
            assert (schema.schema_path(name).read_bytes()
                    == jschema.schema_path(name).read_bytes())

    def test_is_valid_nonraising(self):
        assert not schema.is_valid({}, schema.SCHEMA_SLO_EVENT)

    @pytest.mark.parametrize("bad", [
        {"type": "object", "patternProperties": {}},
        {"type": "string", "format": "email"},
        {"properties": {"x": {"oneOf": []}}},
        {"items": {"pattern": "a+"}},
    ])
    def test_unknown_keyword_raises(self, bad):
        with pytest.raises(validator.UnsupportedSchemaError):
            validator._check_schema(bad, "test")


class TestTimestamps:
    def test_parse_round_trip(self):
        assert schema.parse_rfc3339(schema.rfc3339(TS)) == TS

    def test_naive_datetime_treated_as_utc(self):
        naive = datetime(2026, 7, 29, 12, 0, 0)
        assert schema.rfc3339(naive) == "2026-07-29T12:00:00Z"


# ---- tests/test_validator_fastpath.py, on the port --------------------------


def _event(**overrides) -> ProbeEventV1:
    base = dict(
        ts_unix_nano=1_700_000_000_000_000_000, signal="dns_latency_ms",
        node="node-0", namespace="llm", pod="rag-0", container="rag",
        pid=41, tid=42, value=12.5, unit="ms", status="ok",
    )
    base.update(overrides)
    return ProbeEventV1(**base)


def _generated_corpus() -> list[ProbeEventV1]:
    """The port's generator over every fault scenario: conn tuples,
    errno-carrying connect signals and TPU identity blocks included."""
    meta = signals.Metadata(
        node="n0", namespace="llm", pod="p0", container="c0", pid=7, tid=8,
        tpu_chip="accel0", slice_id="slice-0", xla_program_id="jit_step",
    )
    gen = signals.Generator(signals.CAPABILITY_TPU_FULL)
    start = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events: list[ProbeEventV1] = []
    for scenario in ("baseline", "tpu_mixed", "network_partition"):
        samples = synthetic.generate_synthetic_samples(
            scenario, 4, start, synthetic.SampleMeta()
        )
        events.extend(gen.generate_batch(samples, meta))
    return events


_MALFORMED_EVENTS = [
    _event(status="bogus"), _event(status=""), _event(ts_unix_nano=-1),
    _event(ts_unix_nano=True), _event(pid=-1), _event(tid=-2),
    _event(value="12.5"), _event(value=None), _event(signal=123),
    _event(unit=None), _event(errno="ECONNREFUSED"), _event(errno=True),
    _event(confidence=1.5), _event(confidence=-0.1), _event(confidence="high"),
    _event(conn_tuple=ConnTuple("a", "b", -1, 443, "tcp")),
    _event(conn_tuple=ConnTuple("a", "b", 70000, 443, "tcp")),
    _event(conn_tuple=ConnTuple("a", "b", 1, 65536, "tcp")),
    _event(conn_tuple=ConnTuple(1, "b", 10, 443, "tcp")),
    _event(conn_tuple=ConnTuple("a", "b", "10", 443, "tcp")),
    _event(conn_tuple=ConnTuple("a", "b", 10, 443, None)),
]

_VALID_EVENTS = [
    _event(),
    _event(trace_id="t" * 32, span_id="s" * 16),
    _event(errno=111, conn_tuple=ConnTuple("10.0.0.1", "10.0.0.2", 1, 65535, "tcp")),
    _event(confidence=0.0), _event(confidence=1.0), _event(value=0),
    _event(tpu=TPURef()),
    _event(tpu=TPURef(chip="accel0", launch_id=0, host_index=0, ici_link=0)),
    _event(tpu=TPURef(chip="accel1", launch_id=-1, host_index=-5)),
    _event(signal="xla_compile_ms"),
]


def _probe_payloads() -> list:
    """The JAX fastpath tests' payload corpus, built on the port."""
    payloads = [e.to_dict() for e in _generated_corpus() + _VALID_EVENTS]
    base = _event().to_dict()
    for key in base:
        broken = dict(base)
        del broken[key]
        payloads.append(broken)
    conn = ConnTuple("a", "b", 1, 2, "tcp").to_dict()
    payloads += [
        {**base, "surprise": 1}, {**base, "conn_tuple": {}},
        {**base, "conn_tuple": {"src_ip": "a", "dst_ip": "b"}},
        {**base, "conn_tuple": {**conn, "extra": 1}},
        {**base, "conn_tuple": {**conn, "src_port": "1"}},
        {**base, "tpu": {"chip": 5}}, {**base, "tpu": {"launch_id": -1}},
        {**base, "tpu": {"host_index": True}}, {**base, "tpu": {"unknown": "x"}},
        {**base, "errno": 1.5}, {**base, "pid": True}, {**base, "value": True},
        {**base, "status": "breach"}, {**base, "tpu": {}},
    ]
    return payloads


class TestObjectParity:
    def test_generated_corpus_all_fastpath(self):
        for event in _generated_corpus():
            assert fast_probe_event_valid(event), event
            assert is_valid(event.to_dict(), SCHEMA_PROBE_EVENT), event

    def test_generated_corpus_equals_jax_generator(self):
        from tpuslo import collector as jcollector
        from tpuslo import signals as jsignals

        meta = jsignals.Metadata(
            node="n0", namespace="llm", pod="p0", container="c0", pid=7, tid=8,
            tpu_chip="accel0", slice_id="slice-0", xla_program_id="jit_step",
        )
        gen = jsignals.Generator(jsignals.CAPABILITY_TPU_FULL)
        start = datetime(2026, 1, 1, tzinfo=timezone.utc)
        want = []
        for scenario in ("baseline", "tpu_mixed", "network_partition"):
            samples = jcollector.generate_synthetic_samples(
                scenario, 4, start, jcollector.SampleMeta()
            )
            want.extend(e.to_dict() for e in gen.generate_batch(samples, meta))
        assert [e.to_dict() for e in _generated_corpus()] == want

    def test_valid_corpus_parity(self):
        for event in _VALID_EVENTS:
            assert validate_probe_event(event) is True, event
            assert is_valid(event.to_dict(), SCHEMA_PROBE_EVENT), event

    def test_malformed_corpus_parity(self):
        for event in _MALFORMED_EVENTS:
            expected = is_valid(event.to_dict(), SCHEMA_PROBE_EVENT)
            assert validate_probe_event(event) is expected, event
            if fast_probe_event_valid(event):
                assert expected, event

    def test_malformed_corpus_actually_malformed(self):
        for event in _MALFORMED_EVENTS:
            assert not is_valid(event.to_dict(), SCHEMA_PROBE_EVENT), event


class TestPayloadParity:
    def test_payload_corpus_parity(self):
        for payload in _probe_payloads():
            expected = is_valid(payload, SCHEMA_PROBE_EVENT)
            assert validate_probe_payload(payload) is expected, payload
            if fast_probe_payload_valid(payload):
                assert expected, payload


class TestCounters:
    def test_fastpath_and_fallback_counted(self):
        VALIDATION_COUNTERS.reset()
        assert not VALIDATION_COUNTERS.engaged
        assert validate_probe_event(_event())
        assert VALIDATION_COUNTERS.engaged
        assert VALIDATION_COUNTERS.fastpath_valid == 1
        assert not validate_probe_event(_event(status="bogus"))
        snap = VALIDATION_COUNTERS.snapshot()
        assert snap["fastpath_fallback"] == 1
        assert snap["slowpath_invalid"] == 1
        # A contract-valid shape the fast path cannot prove (a float with
        # an integral value is a JSON Schema "integer").
        assert validate_probe_event(_event(pid=1.0))
        snap = VALIDATION_COUNTERS.snapshot()
        assert snap["fastpath_fallback"] == 2
        assert snap["slowpath_valid"] == 1


# ---- the parity sweep: the port's checker vs jsonschema ---------------------

DATE = "2026-07-29T12:00:00Z"
BAD_DATES = [
    "not-a-date", "2026-13-01T00:00:00Z", "2026-02-30T00:00:00Z",
    "2026-07-29 12:00:00Z", "2026-07-29T24:00:00Z", "2026-07-29T12:60:00Z",
    "0000-01-01T00:00:00Z", "2026-07-29T12:00:00", "2026-07-29T12:00:00+5:30",
    "2026-07-29", "", "2026-07-29T12:00:00.Z",
]
GOOD_DATES = [
    "2026-07-29t12:00:00z", "2024-02-29T23:59:59.123456+05:30",
    "2026-07-29T00:00:00-00:00", "9999-12-31T23:59:59Z",
]


def _instance(node: dict):
    """A full valid instance of a schema: every property present."""
    types = node.get("type")
    kind = types[0] if isinstance(types, list) else types
    if "enum" in node:
        return node["enum"][0]
    if kind == "object":
        out = {k: _instance(v) for k, v in node.get("properties", {}).items()}
        if isinstance(node.get("additionalProperties"), dict):
            out["extra_key"] = _instance(node["additionalProperties"])
        return out
    if kind == "array":
        return [_instance(node["items"])] if "items" in node else []
    if kind == "string":
        return DATE if node.get("format") == "date-time" else "x" * max(1, node.get("minLength", 1))
    if kind == "integer":
        return int(node.get("minimum", 1))
    if kind == "number":
        lo, hi = node.get("minimum", 0.0), node.get("maximum")
        return (lo + hi) / 2 if hi is not None else lo + 0.5
    if kind == "boolean":
        return True
    raise AssertionError(f"no instance for {node}")


def _at(payload, path):
    for key in path[:-1]:
        payload = payload[key]
    return payload


def _mutations(node: dict, value, path=()):
    """(name, path, new value or DROP) edits that each break one rule of
    ``node`` at ``path`` (or keep it valid: the checker must agree both
    ways)."""
    types = node.get("type")
    names = types if isinstance(types, list) else [types]
    where = "/".join(map(str, path)) or "<root>"
    out = []
    if path:
        out.append((f"{where}:type-list", path, [value]))
        out.append((f"{where}:type-null", path, None))
        if "string" not in names:
            out.append((f"{where}:type-str", path, "7"))
        if "boolean" not in names:
            out.append((f"{where}:type-bool", path, True))
        if "integer" in names and "number" not in names:
            out.append((f"{where}:integral-float", path, float(value) + 0.0))
            out.append((f"{where}:fraction", path, float(value) + 0.5))
    if "enum" in node:
        out.append((f"{where}:enum", path, "not-in-enum"))
        out.append((f"{where}:enum-case", path, str(node["enum"][-1]).upper()))
    if "minimum" in node:
        out.append((f"{where}:below-min", path, node["minimum"] - 1))
        out.append((f"{where}:at-min", path, node["minimum"]))
    if "maximum" in node:
        out.append((f"{where}:above-max", path, node["maximum"] + 0.5))
        out.append((f"{where}:at-max", path, node["maximum"]))
    if "minLength" in node:
        out.append((f"{where}:too-short", path, ""))
    if node.get("format") == "date-time":
        out += [(f"{where}:bad-date-{i}", path, d) for i, d in enumerate(BAD_DATES)]
        out += [(f"{where}:good-date-{i}", path, d) for i, d in enumerate(GOOD_DATES)]
    if isinstance(value, dict):
        for key in node.get("required", ()):
            out.append((f"{where}:drop-{key}", path + (key,), DROP))
        if node.get("additionalProperties") is False:
            out.append((f"{where}:extra-key", path + ("surprise",), 1))
        for key, sub in node.get("properties", {}).items():
            if key in value:
                out += _mutations(sub, value[key], path + (key,))
        extra = node.get("additionalProperties")
        if isinstance(extra, dict) and "extra_key" in value:
            out += _mutations(extra, value["extra_key"], path + ("extra_key",))
    if isinstance(value, list) and value and "items" in node:
        out += _mutations(node["items"], value[0], path + (0,))
    return out


DROP = object()


def _apply(payload, path, new):
    out = copy.deepcopy(payload)
    parent = _at(out, path)
    if new is DROP:
        del parent[path[-1]]
    else:
        parent[path[-1]] = new
    return out


def _sweep_cases():
    cases = []
    for name in schema.ALL_SCHEMAS:
        node = json.loads(schema.schema_path(name).read_text())
        full = _instance(node)
        cases.append((name, "full-instance", full))
        for label, path, new in _mutations(node, full):
            cases.append((name, label, _apply(full, path, new)))
    fixed = {
        schema.SCHEMA_SLO_EVENT: [make_slo_event().to_dict(),
                                  make_slo_event(status="exploded").to_dict(),
                                  make_slo_event(sli_name="nonsense").to_dict(),
                                  make_slo_event(trace_id="").to_dict()],
        schema.SCHEMA_INCIDENT_ATTRIBUTION: [make_attribution().to_dict(),
                                             make_attribution("gpu_meltdown").to_dict()],
        schema.SCHEMA_PROBE_EVENT: _probe_payloads()
        + [e.to_dict() for e in _MALFORMED_EVENTS],
        schema.SCHEMA_TOOLKIT_CONFIG: [{}, {"signal_set": []}],
    }
    for name, payloads in fixed.items():
        cases += [(name, f"tests-{i}", p) for i, p in enumerate(payloads)]
    return cases


SWEEP = _sweep_cases()


@pytest.mark.parametrize("name", schema.ALL_SCHEMAS)
def test_validator_agrees_with_jsonschema(name):
    """Every payload of the sweep for one contract: the port's verdict is
    jsonschema's, and so is the port's combined probe validation."""
    cases = [(label, p) for n, label, p in SWEEP if n == name]
    assert len(cases) > 20
    disagree = [label for label, p in cases
                if schema.is_valid(p, name) != jschema.is_valid(p, name)]
    assert not disagree, disagree
    verdicts = {jschema.is_valid(p, name) for _, p in cases}
    assert verdicts == {True, False}  # the sweep holds both kinds


def test_sweep_covers_every_rule_kind():
    labels = {label.rsplit(":", 1)[-1].rsplit("-", 1)[0] for _, label, _ in SWEEP}
    for kind in ("drop", "enum", "below", "above", "too", "extra", "bad-date", "type"):
        assert any(label.startswith(kind) for label in labels), kind


def test_errors_name_the_path():
    payload = make_attribution().to_dict()
    payload["slo_impact"]["window_minutes"] = 0
    with pytest.raises(schema.SchemaValidationError, match="slo_impact/window_minutes"):
        schema.validate(payload, schema.SCHEMA_INCIDENT_ATTRIBUTION)
