"""A healthy steady window through both packages' attributors.

On the card a steady front-door window (no injected fault) is read as
``network_dns`` at 0.0797, tied with ``network_egress`` on the flat
prior.  The question was whether the reference reads such a window the
same way.  These are the device-plane signals of five steady windows the
card recorded in chip_smoke's phase 12 (idle gap 7-19 ms, no eviction,
no unexplained share, MFU 1.96-1.98 %), replayed on the CPU through
``tpuslo.attribution`` and ``tpuslo_torch.attribution``: the same top
domain, the same order of the tied domains and the same posteriors to
1e-10, on the host path and on ``attribute_batch``'s numpy lane.
"""

from __future__ import annotations

from datetime import datetime, timezone

import pytest

pytest.importorskip("torch")

from tpuslo.attribution.bayesian import BayesianAttributor as JaxAttributor  # noqa: E402
from tpuslo.faultreplay.generator import FaultSample as JaxSample  # noqa: E402
from tpuslo_torch.attribution.bayesian import BayesianAttributor  # noqa: E402
from tpuslo_torch.faultreplay.generator import FaultSample  # noqa: E402

POSTERIOR_TOL = 1e-10
STEADY_WINDOWS = [
    (9.250595999997916, 1.98),
    (8.505104999998402, 1.97),
    (19.432247000005795, 1.98),
    (6.975874999998072, 1.97),
    (17.60351000000813, 1.96),
]


def _signals(idle_gap_ms: float, mfu_pct: float) -> dict[str, float]:
    return {"device_idle_gap_ms": idle_gap_ms, "device_eviction_events_total": 0.0,
            "device_unexplained_share": 0.0, "device_mfu_pct": mfu_pct}


@pytest.mark.parametrize("window", STEADY_WINDOWS)
def test_a_healthy_window_reads_the_same_in_both_packages(window):
    values = _signals(*window)
    want = JaxAttributor().attribute(values)
    got = BayesianAttributor().attribute(values)
    assert [r.domain for r in got] == [r.domain for r in want]
    for g, w in zip(got, want):
        assert abs(g.posterior - w.posterior) <= POSTERIOR_TOL, g.domain
    # The reference's own reading: network_dns first, tied with egress.
    assert want[0].domain == "network_dns" and want[1].domain == "network_egress"
    assert abs(want[0].posterior - 0.0797) < 1e-4
    assert abs(want[0].posterior - want[1].posterior) <= POSTERIOR_TOL


def _sample(cls, values):
    return cls(incident_id="window", timestamp=datetime(2026, 1, 1, tzinfo=timezone.utc),
               cluster="h100", namespace="llm", service="frontdoor", fault_label="",
               confidence=1.0, burn_rate=0.0, window_minutes=1, request_id="",
               trace_id="", signals=values)


def test_the_batch_lane_agrees_on_healthy_windows():
    values = [_signals(*w) for w in STEADY_WINDOWS]
    want = JaxAttributor().attribute_batch([_sample(JaxSample, v) for v in values])
    got = BayesianAttributor().attribute_batch([_sample(FaultSample, v) for v in values])
    for g, w in zip(got, want):
        assert g.predicted_fault_domain == w.predicted_fault_domain == "network_dns"
        assert abs(g.confidence - w.confidence) <= POSTERIOR_TOL
