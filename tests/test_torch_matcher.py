"""The port's correlation matcher (``tpuslo_torch.correlation.matcher``)
against the JAX package's (``tpuslo.correlation.matcher``).

Both sides get the same span and signal records, built from one seed;
every decision (``matched``, ``tier``, ``confidence``) must be equal,
exactly: each tier, the window edges of 100, 250, 500 ms and of the
global window (inclusive, and 1 us past), missing and unparseable
timestamps, ``match_batch``'s picks, ``enrich_dns`` and the rejection
counters.
"""

from __future__ import annotations

import dataclasses
import random
from datetime import datetime, timedelta, timezone

import pytest

from tpuslo import semconv as jsemconv
from tpuslo.correlation import matcher as jm
from tpuslo.metrics.rejections import REJECTION_COUNTERS as J_REJECTIONS
from tpuslo_torch import semconv as tsemconv
from tpuslo_torch.correlation import matcher as tm
from tpuslo_torch.metrics import REJECTION_COUNTERS as T_REJECTIONS

TS = datetime(2026, 7, 29, 12, 0, 0, tzinfo=timezone.utc)

#: (span identity, signal identity, the tier's window in ms).
TIERS = {
    "trace_id_exact": ({"trace_id": "t1"}, {"trace_id": "t1"}, 2000),
    "xla_launch": ({"program_id": "jit_step", "launch_id": 42},
                   {"program_id": "jit_step", "launch_id": 42}, 250),
    "pod_pid_100ms": ({"pod": "p", "pid": 11}, {"pod": "p", "pid": 11}, 100),
    "pod_conn_250ms": ({"pod": "p", "conn_tuple": "tcp:a->b"},
                       {"pod": "p", "conn_tuple": "tcp:a->b"}, 250),
    "slice_host_250ms": ({"slice_id": "s0", "host_index": 1},
                         {"slice_id": "s0", "host_index": 1}, 250),
    "service_node_500ms": ({"service": "svc", "node": "n0"},
                           {"service": "svc", "node": "n0"}, 500),
}


def _stamp(offset_us: int | None):
    if offset_us is None:
        return None
    return (TS + timedelta(microseconds=offset_us)).isoformat().replace("+00:00", "Z")


def _records(seed: int, n: int) -> list[dict]:
    """``n`` span-or-signal records with identities drawn from small
    pools (so that every tier finds partners) and offsets near every
    window edge; some timestamps missing or unparseable."""
    rng = random.Random(seed)
    edges = [0, 100_000, 250_000, 500_000, 2_000_000]
    out = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.06:
            stamp = None
        elif roll < 0.09:
            stamp = "not a timestamp"
        else:
            edge = rng.choice(edges)
            stamp = _stamp(rng.choice((1, -1)) * (edge + rng.choice((-1, 0, 1, 0, 0)))
                           + rng.choice((0, 0, 0, rng.randrange(-3_000_000, 3_000_000))))
        out.append({
            "timestamp": stamp,
            "trace_id": rng.choice(["", "", "", "t1", "t2"]),
            "service": rng.choice(["", "svc", "api"]),
            "node": rng.choice(["", "n0", "n1"]),
            "pod": rng.choice(["", "p", "q"]),
            "pid": rng.choice([0, 11, 12]),
            "conn_tuple": rng.choice(["", "tcp:a->b", "tcp:c->d"]),
            "slice_id": rng.choice(["", "s0", "s1"]),
            "host_index": rng.choice([-1, 0, 1]),
            "program_id": rng.choice(["", "jit_step", "jit_other"]),
            "launch_id": rng.choice([-1, 42, 43]),
            "signal": rng.choice(["dns_latency_ms", "xla_compile_ms"]),
            "value": round(rng.uniform(0, 50), 3),
        })
    return out


def _decision(d) -> tuple:
    return (d.matched, d.tier, d.confidence)


def _pair(span_raw: dict, signal_raw: dict, window_ms: int = 0):
    """The two sides' decisions for one raw span and signal."""
    return tuple(
        _decision(m.match(m.SpanRef.from_dict(span_raw), m.SignalRef.from_dict(signal_raw),
                          window_ms))
        for m in (jm, tm)
    )


def test_constants_and_semconv_equal_jax():
    for name in ("DEFAULT_WINDOW_MS", "DEFAULT_ENRICHMENT_THRESHOLD", "MISSING_TS_CONFIDENCE",
                 "TIER_CONFIDENCE", "TIER_TRACE_ID", "TIER_XLA_LAUNCH", "TIER_POD_PID",
                 "TIER_POD_CONN", "TIER_SLICE_HOST", "TIER_SERVICE_NODE"):
        assert getattr(tm, name) == getattr(jm, name)
    names = {k for k in vars(jsemconv) if k.isupper()}
    assert names == {k for k in vars(tsemconv) if k.isupper()}
    assert all(getattr(tsemconv, k) == getattr(jsemconv, k) for k in names)
    for cls in ("SpanRef", "SignalRef", "Decision", "BatchMatch"):
        assert ([f.name for f in dataclasses.fields(getattr(tm, cls))]
                == [f.name for f in dataclasses.fields(getattr(jm, cls))])


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("sign", [1, -1])
def test_each_tier_at_its_window_edges(tier, sign):
    """At the tier's edge and 1 us either side of it, and half-way: the
    tier when inside, nothing (or a lower tier) past it; equal sides."""
    span_id, signal_id, edge_ms = TIERS[tier]
    seen = set()
    for delta_us in (-1, 0, 1, -edge_ms * 500):
        span_raw = {"timestamp": _stamp(0), **span_id}
        signal_raw = {"timestamp": _stamp(sign * (edge_ms * 1000 + delta_us)), **signal_id}
        want, got = _pair(span_raw, signal_raw)
        assert got == want
        seen.add(got[1])
    assert tier in seen and "" in seen


@pytest.mark.parametrize("window_ms", [0, 150, 3000])
def test_the_global_window_bounds_every_tier(window_ms):
    for tier, (span_id, signal_id, edge_ms) in TIERS.items():
        for offset_ms in (edge_ms, min(edge_ms, window_ms or 2000), 149, 151):
            span_raw = {"timestamp": _stamp(0), **span_id}
            signal_raw = {"timestamp": _stamp(offset_ms * 1000), **signal_id}
            want, got = _pair(span_raw, signal_raw, window_ms)
            assert got == want, (tier, offset_ms)


@pytest.mark.parametrize("case", ["span", "signal", "both", "garbage", "wrong_type"])
def test_missing_timestamps_cap_the_trace_join_and_count_rejections(case):
    stamps = {"span": (None, _stamp(0)), "signal": (_stamp(0), None), "both": (None, None),
              "garbage": ("yesterday", _stamp(0)), "wrong_type": (_stamp(0), 12345)}[case]
    for trace in ("t1", ""):
        span_raw = {"timestamp": stamps[0], "trace_id": trace, "pod": "p", "pid": 11}
        signal_raw = {"timestamp": stamps[1], "trace_id": trace, "pod": "p", "pid": 11}
        before = (J_REJECTIONS.snapshot("matcher"), T_REJECTIONS.snapshot("matcher"))
        want, got = _pair(span_raw, signal_raw)
        assert got == want
        assert got == ((True, "trace_id_exact", tm.MISSING_TS_CONFIDENCE) if trace
                       else (False, "", 0.0))
        after = (J_REJECTIONS.snapshot("matcher"), T_REJECTIONS.snapshot("matcher"))
        grew = [{k: a.get(k, 0) - b.get(k, 0) for k in a} for a, b in zip(after, before)]
        assert grew[0] == grew[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_pairs_equal_jax(seed):
    spans = _records(seed, 60)
    signals = _records(seed + 100, 60)
    tiers = set()
    for span_raw in spans:
        for signal_raw in signals:
            want, got = _pair(span_raw, signal_raw)
            assert got == want
            tiers.add(got[1])
    assert tiers >= {"", "trace_id_exact", "xla_launch", "pod_pid_100ms"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("window_ms", [0, 300])
def test_match_batch_equals_jax(seed, window_ms):
    """``match_batch`` over the seeded batch: each span's pick (signal
    index and decision) equals JAX's, and a batch whose signals all lack
    timestamps takes the missing-timestamp path on both sides."""
    spans = _records(seed, 80)
    signals = _records(seed + 200, 120)

    def run(m, sig_raws):
        got = m.match_batch([m.SpanRef.from_dict(r) for r in spans],
                            [m.SignalRef.from_dict(r) for r in sig_raws], window_ms)
        return [(b.span_index, b.signal_index, _decision(b.decision)) for b in got]

    want, got = run(jm, signals), run(tm, signals)
    assert got == want
    assert {tier for _, _, (_, tier, _) in got} >= {"trace_id_exact", "xla_launch"}
    untimed = [{**r, "timestamp": None} for r in signals]
    assert run(tm, untimed) == run(jm, untimed)


@pytest.mark.parametrize("seed", [0, 1])
def test_enrich_dns_equals_jax(seed):
    spans = _records(seed, 30)
    signals = _records(seed + 300, 30)
    for span_raw in spans:
        for signal_raw in signals:
            base = {"k": 1.0}
            outs = [m.enrich_dns(base, m.SpanRef.from_dict(span_raw),
                                 m.SignalRef.from_dict(signal_raw), threshold=0.75)
                    for m in (jm, tm)]
            assert outs[1][0] == outs[0][0] and base == {"k": 1.0}
            assert _decision(outs[1][1]) == _decision(outs[0][1])


def test_signal_from_probe_dict_equals_jax():
    events = [
        {"signal": "xla_compile_ms", "ts_unix_nano": 1_785_000_000_123_456_789, "node": "n0",
         "pod": "p", "pid": 7, "value": 3.5,
         "conn_tuple": {"protocol": "tcp", "src_ip": "a", "src_port": 1, "dst_ip": "b",
                        "dst_port": 2},
         "tpu": {"slice_id": "s0", "host_index": 1, "program_id": "jit", "launch_id": 3}},
        {"signal": "dns_latency_ms", "ts_unix_nano": 0, "pid": "bad"},
        {"signal": "dns_latency_ms", "ts_unix_nano": 1.5e18},
    ]
    for event in events:
        want = dataclasses.astuple(jm.SignalRef.from_probe_dict(event))
        assert dataclasses.astuple(tm.SignalRef.from_probe_dict(event)) == want
