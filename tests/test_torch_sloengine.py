"""The port's own copy of the burn engine against the original.

``tpuslo_torch.sloengine`` is a copy of ``tpuslo.sloengine`` (plain
Python; the port imports nothing of the JAX package).  One seeded stream
of ``RequestOutcome``s goes through both ``BurnEngine``s: every
``evaluate`` transition, ``status`` row, burn state, admission priority
and the exported state must be equal, exactly (the arithmetic is the
same code).  The dispatch ledger and the null tracer cycle are held to
their originals the same way.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tpuslo import sloengine as js
from tpuslo.deviceplane.dispatch import DispatchLedger as JDispatchLedger
from tpuslo.obs import tracer as jtracer
from tpuslo_torch import sloengine as ts
from tpuslo_torch.deviceplane.dispatch import DispatchLedger as TDispatchLedger
from tpuslo_torch.obs import tracer as ttracer

TENANTS = ("alpha", "beta", "gamma", "")
NOW0 = 50_000.0


def _stream(seed: int, n: int = 1500):
    """(offset seconds, outcome fields) drawn from a numpy seed: beta
    errs on half of its requests in the middle third, gamma is slow."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(2.0, n))
    rows = []
    for i in range(n):
        tenant = TENANTS[int(rng.integers(len(TENANTS)))]
        bad = tenant == "beta" and n // 3 < i < 2 * n // 3 and rng.random() < 0.5
        ttft = float(rng.gamma(2.0, 60.0)) * (8.0 if tenant == "gamma" else 1.0)
        rows.append((float(t[i]), dict(
            tenant=tenant, ts_unix_nano=int((NOW0 + t[i]) * 1e9), ttft_ms=ttft,
            tpot_ms=float(rng.gamma(2.0, 8.0)), tokens=int(rng.integers(1, 64)),
            status="error" if bad else ("shed" if rng.random() < 0.01 else "ok"),
        )))
    return rows


def _drive(mod, rows, checkpoint_every: int = 100):
    """Feed the stream, evaluating every ``checkpoint_every`` outcomes;
    returns everything observable, as plain data."""
    burn = mod.BurnEngine()
    seen = {"transitions": [], "states": [], "status": [], "accepted": []}
    for i, (off, fields) in enumerate(rows):
        seen["accepted"].append(burn.record(mod.RequestOutcome(**fields)))
        if (i + 1) % checkpoint_every == 0:
            fired = burn.evaluate(NOW0 + off)
            seen["transitions"].append([t.to_dict() for t in fired])
            seen["states"].append({t: burn.tenant_burn_state(t) for t in TENANTS})
            seen["status"].append([s.to_dict() for s in burn.status()])
    seen["active"] = burn.active_burns()
    seen["snapshot"] = burn.snapshot()
    return burn, seen


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_stream_gives_equal_transitions_status_and_state(seed):
    rows = _stream(seed)
    bj, sj = _drive(js, rows)
    bt, st = _drive(ts, rows)
    assert st == sj
    assert any(fired for fired in st["transitions"]), "the stream fired no alert"
    assert "fast_burn" in {s["beta"] for s in st["states"]}
    assert json.dumps(bt.export_state(), sort_keys=True) == json.dumps(
        bj.export_state(), sort_keys=True
    )


def test_admission_priority_after_demote_and_restore():
    for mod in (js, ts):
        burn = mod.BurnEngine()
        assert burn.admission_priority("t") == mod.DEFAULT_ADMISSION_PRIORITY
        assert burn.demote_tenant("t") is True
        assert burn.demote_tenant("t") is False
        assert burn.admission_priority("t") == mod.DEMOTED_ADMISSION_PRIORITY
        assert burn.demoted_tenants() == ["t"]
        assert burn.demote_tenant("u", priority=3) and burn.admission_priority("u") == 3
        assert burn.restore_tenant("t") is True
        assert burn.restore_tenant("t") is False
        assert burn.admission_priority("t") == mod.DEFAULT_ADMISSION_PRIORITY


def test_priority_constants_and_windows_equal():
    assert ts.DEFAULT_ADMISSION_PRIORITY == js.DEFAULT_ADMISSION_PRIORITY == 100
    assert ts.DEMOTED_ADMISSION_PRIORITY == js.DEMOTED_ADMISSION_PRIORITY == 10
    assert ts.WINDOWS == js.WINDOWS
    assert ts.OBJECTIVES == js.OBJECTIVES
    assert sorted(ts.__all__) == sorted(js.__all__)


def test_export_state_round_trip_crosses_the_two_copies():
    """A state exported by the original restores into the copy (through
    JSON) and goes on to the same transitions, and the other way."""
    rows = _stream(3)
    head, tail = rows[:900], rows[900:]
    for src, dst in ((js, ts), (ts, js)):
        burn_src, _ = _drive(src, head)
        state = json.loads(json.dumps(burn_src.export_state()))
        burn_dst = dst.BurnEngine()
        burn_dst.demote_tenant("stale")  # restore replaces the admission map
        burn_dst.restore_state(state)
        assert burn_dst.recorded == burn_src.recorded
        assert burn_dst.demoted_tenants() == burn_src.demoted_tenants()
        for tenant in TENANTS:
            assert burn_dst.tenant_burn_state(tenant) == burn_src.tenant_burn_state(tenant)
        out = []
        for burn, mod in ((burn_src, src), (burn_dst, dst)):
            for off, fields in tail:
                burn.record(mod.RequestOutcome(**fields))
            fired = burn.evaluate(NOW0 + tail[-1][0])
            out.append(([t.to_dict() for t in fired], [s.to_dict() for s in burn.status()]))
        assert out[0] == out[1]


def test_restore_rejects_unknown_version_in_both():
    for mod in (js, ts):
        burn = mod.BurnEngine()
        burn.restore_state({"version": 99, "recorded": 7})
        assert burn.recorded == 0
        burn.restore_state("not a dict")
        assert burn.recorded == 0


def test_request_outcome_dict_round_trip_equal():
    fields = _stream(5, 3)[0][1]
    a, b = js.RequestOutcome(**fields), ts.RequestOutcome(**fields)
    assert a.to_dict() == b.to_dict()
    assert ts.RequestOutcome.from_dict(a.to_dict()).to_dict() == a.to_dict()


def test_dispatch_ledger_copy_equals_original():
    rng = np.random.default_rng(9)
    a, b = JDispatchLedger(), TDispatchLedger()
    assert a.totals() == b.totals()
    for _ in range(50):
        args = (int(rng.integers(1, 10**7)), int(rng.integers(1, 10**8)),
                int(rng.integers(0, 40)), int(rng.integers(1, 9)))
        a.note(*args)
        b.note(*args)
        assert a.last() == b.last()
    assert a.totals() == b.totals()
    assert a.device_wait_ms_total == b.device_wait_ms_total


def test_null_cycle_copy_behaves_as_the_original():
    for mod in (jtracer, ttracer):
        cycle = mod._NULL_CYCLE
        with cycle.stage("admit", queued=3) as span:
            assert span.set(tokens=1) is None
        assert cycle.mark_keep() is None
        assert (cycle.trace_id, cycle.root, cycle.error) == ("", None, False)
    assert type(ttracer._NULL_CYCLE).__slots__ == type(jtracer._NULL_CYCLE).__slots__
