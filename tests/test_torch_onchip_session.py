"""The port's on-chip session (``python -m tpuslo_torch.demo.e2e_onchip_session``)
rehearsed on the CPU at ``llama_tiny`` in f32, on the JAX engine's
seed-0 weights (``bridge.params_from_numpy``): the serve, the storm
written into a ring, the port's agent consuming it as a subprocess, the
SIGTERM drain, the joins and the attribution.  Every plumbing verdict
must hold, the attribution must read the agent's own emitted compile
rows (nothing falls back to the storm's times), the three greedy streams
must equal the JAX engine's, and the attribution step, given the same
agent JSONL, must give the JAX session's domain and posteriors (to
1e-10).  ``chip_smoke``'s phase 30 gates pass on the rehearsal's report.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from datetime import datetime, timezone
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo_torch.demo import e2e_onchip_session as session_mod  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=256), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=256), dtype=torch.float32)
PLUMBING = ("live_backend", "agent_consumed_ring", "storm_measured",
            "xprof_spans_captured", "spans_joined")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
        pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
        out = tmp_path_factory.mktemp("session")
        session = session_mod.run(out, "cpu", params=pt, cfg=CFG_T)
    finally:
        torch.set_num_threads(threads)
    return out, session, pj


def test_the_rehearsal_holds_every_plumbing_verdict(rehearsal):
    out, session, _ = rehearsal
    assert session["rehearsal"] is True and session["model"] == "llama_tiny"
    for verdict in PLUMBING:
        assert session["verdicts"][verdict], verdict
    assert session["checks"] == {"from_agent_emitted_events": True,
                                 "agent_exit_0_by_sigterm": True,
                                 "agent_opened_no_cuda_context": True,
                                 "streams_equal_generate": True}
    assert session["agent"]["exit_code"] == 0
    assert "reason=signal_15" in session["agent"]["drain"]
    assert session["agent_rows_by_signal"] == {"hbm_utilization_pct": 2,
                                               "xla_compile_ms": session_mod.STORM_COMPILES}
    assert "REHEARSAL RUN" in (out / "README.md").read_text()
    assert json.loads((out / "session.json").read_text())["pass"] == session["pass"]


def test_attribution_reads_the_agents_rows_not_the_storms(rehearsal):
    out, session, _ = rehearsal
    rows = session_mod.ring_rows(session_mod.read_rows(out / "agent_onchip.jsonl"),
                                 "xla_compile_ms")
    agent_ms = [r["value"] for r in rows]
    assert [round(v, 1) for v in agent_ms] == [s["wall_ms"] for s in session["storm"]]
    attribution = json.loads((out / "attribution.json").read_text())
    assert attribution["from_agent_emitted_events"] is True
    assert attribution["measured_compile_ms"] == round(max(agent_ms), 1)
    # No agent row, no attribution: nothing falls back to the storm.
    empty = session_mod.attribute([])
    assert empty["from_agent_emitted_events"] is False
    assert empty["measured_compile_ms"] is None


def test_the_streams_equal_the_jax_engines(rehearsal):
    from tpuslo.models.serve import ServeEngine as JServe

    _, session, pj = rehearsal
    engine = JServe(cfg=CFG_J, params=pj, prefill_buckets=(32, 64, 128, 256))
    want = [[e.token_id for e in engine.generate(
        f"incident session request {i}", max_new_tokens=session_mod.SERVE_TOKENS,
        stop_at_eos=False)] for i in range(session_mod.SERVE_REQUESTS)]
    assert session["streams"] == want


def _jax_attribution(rows: list[dict]):
    """The JAX session's attribution step over the agent's compile rows."""
    from tpuslo.attribution.calibrate import calibrated_attributor
    from tpuslo.attribution.mapper import FaultSample
    from tpuslo.signals.generator import profile_for_fault

    signals = dict(profile_for_fault("baseline"))
    signals["xla_compile_ms"] = max(float(e.get("value", 0.0)) for e in rows)
    return calibrated_attributor().attribute_sample(FaultSample(
        incident_id="e2e-onchip-0001", timestamp=datetime.now(timezone.utc),
        cluster="local", namespace="llm", service="onchip-serve", fault_label="",
        expected_domain="", signals=signals, confidence=0.9, burn_rate=2.5,
        window_minutes=5, request_id="e2e-onchip-req-0001",
        trace_id="e2e-onchip-trace-0001"))


@pytest.mark.parametrize("scale", [1.0, 20.0, 60.0], ids=["rehearsal", "x20", "x60"])
def test_attribution_equals_the_jax_sessions_on_the_same_jsonl(rehearsal, scale):
    """The rehearsal's own rows, and the same rows scaled into and past the
    ~500 ms band where the attributor names xla_compile."""
    out, _, _ = rehearsal
    rows = session_mod.ring_rows(session_mod.read_rows(out / "agent_onchip.jsonl"),
                                 "xla_compile_ms")
    rows = [{**r, "value": r["value"] * scale} for r in rows]
    got = session_mod.attribute(rows)
    want = _jax_attribution(rows)
    assert got["predicted_domain"] == want.predicted_fault_domain
    assert set(got["posteriors"]) == {h.domain for h in want.fault_hypotheses}
    for h in want.fault_hypotheses:
        assert abs(got["posteriors"][h.domain] - h.posterior) <= 1e-10, h.domain
    sys.path.insert(0, str(ROOT / "scripts" / "demo"))
    try:
        from e2e_multihost_session import _posterior_context
    finally:
        sys.path.remove(str(ROOT / "scripts" / "demo"))
    assert got["calibration_context"] == _posterior_context(want)


def test_phase_30_gates_pass_the_rehearsal_and_name_each_failure(rehearsal, tmp_path):
    out, session, _ = rehearsal
    compile_ms = [r["value"] for r in session_mod.ring_rows(
        session_mod.read_rows(out / "agent_onchip.jsonl"), "xla_compile_ms")]
    report = {
        "session": {"exit_code": 0 if session["pass"] else 1, "session": session,
                    "agent_compile_ms": compile_ms, "launches": session["kernel_launches"],
                    "seconds": 1.0},
        "prober": {"exit_code": 0, "rows": {op: 3 for op in chip_smoke.AGENT_PROBER_OPS},
                   "disabled": [], "stderr_tail": ""},
        "expected_domain": session["attribution"]["predicted_domain"],
    }
    assert chip_smoke.agent_failures(report) == []


@pytest.mark.parametrize("before,during,ok", [
    (None, None, True),          # no nvidia-smi: the CPU
    ([1], [1], True),            # the session alone on the card
    ([1, 1], [1, 1], True),      # the caller's own context beside it
    ([1, 1], [1], True),         # an earlier process released its context
    ([1], [1, 1], False),        # the agent opened a context
    ([1], [77], False),          # the agent's pid among the apps
    ([1], None, False),          # nvidia-smi failed while the agent ran
])
def test_the_agent_is_held_to_the_apps_before_it(before, during, ok):
    assert session_mod.agent_added_no_app(before, during, 77) is ok
