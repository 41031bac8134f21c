"""The serving benches: ``tpuslo_torch.benchmark.frontdoor_bench`` and
``router_bench`` against the JAX package's, on the CPU at a few streams,
tokens and one pass.

Each bench runs once per package over the same arguments (the port's on
``device="cpu"``).  The reports are compared in three ways:

* **keys**: the same report keys at every level, and the same gate
  constants;
* **deterministic fields**, which must be equal: the configuration
  echoed back, the request and token counts of the front door's passes
  and of the router's burst passes, the burning tenant, its burn state
  and submitted share, the shed counts (0 at this size: every queue
  holds all the streams), and the router's kill scenario (lost requests,
  mismatched streams, sheds);
* **measured fields** (every time, TTFT, TPOT, rate, speedup and
  goodput, the SLOs derived from the solo request, the acceptance rate
  of bf16 engines, occupancy, the router's rebalanced count and affinity
  hit rate, the request counts of the router's paced and kill passes,
  which the bench sizes from a measured rate, host syncs per token, which
  count different things in the two packages, ``passed`` and
  ``failures``): compared by presence only.

The port's ``spec_retrace_count`` must be 0.  The sizes are cut (the JAX
defaults serve 192 and 1,024 streams) so that each package's run takes
seconds on one CPU.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tpuslo.benchmark import frontdoor_bench as jfb  # noqa: E402
from tpuslo.benchmark import router_bench as jrb  # noqa: E402
from tpuslo_torch.benchmark import frontdoor_bench as tfb  # noqa: E402
from tpuslo_torch.benchmark import router_bench as trb  # noqa: E402

FD_ARGS = dict(streams=6, max_slots=2, k=3, max_new_tokens=8, passes=1, rounds_per_step=2)
ROUTER_ARGS = dict(engines=2, streams=8, max_slots=2, max_new_tokens=4, prefix_groups=2,
                   kill_streams=6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frontdoor_reports():
    return jfb.run_frontdoor_bench(**FD_ARGS), tfb.run_frontdoor_bench(**FD_ARGS, device="cpu")


@pytest.fixture(scope="module")
def router_reports():
    return jrb.run_router_bench(**ROUTER_ARGS), trb.run_router_bench(**ROUTER_ARGS,
                                                                     device="cpu")


def _key_paths(report, prefix=()):
    paths = set()
    for key, value in report.items():
        paths.add(prefix + (key,))
        if isinstance(value, dict):
            paths |= _key_paths(value, prefix + (key,))
    return paths


def _at(report, path):
    for key in path:
        report = report[key]
    return report


FD_DETERMINISTIC = [
    ("seed",), ("streams",), ("max_slots",), ("k",), ("max_new_tokens",), ("arrival",),
    ("tenants",), ("tenant_mix",), ("prefix_rate",), ("self_draft",),
    ("parity_spot_check",), ("sequential", "requests"), ("sequential", "tokens"),
    ("frontdoor", "requests"), ("frontdoor", "tokens"), ("spec_retrace_count",),
    ("burn_scenario", "burning_tenant"), ("burn_scenario", "burn_state"),
    ("burn_scenario", "submitted_share"), ("burn_scenario", "shed"), ("gates",),
]
ROUTER_DETERMINISTIC = [
    ("seed",), ("engines",), ("streams",), ("max_slots",), ("k",), ("max_new_tokens",),
    ("tenants",), ("prefix_groups",), ("prefix_rate",), ("paged",), ("block_size",),
    ("self_draft",), ("fleet", "requests"), ("fleet", "tokens"), ("fleet", "shed"),
    ("single", "requests"), ("single", "tokens"), ("single", "shed"),
    ("router_scaling_floor",), ("spec_retrace_count",), ("kill_scenario", "killed_engine"),
    ("kill_scenario", "lost_requests"), ("kill_scenario", "mismatched_streams"),
    ("kill_scenario", "shed"), ("router_lost_requests",), ("gates",),
]


def test_frontdoor_report_keys_and_gates_equal_jax(frontdoor_reports):
    want, got = frontdoor_reports
    assert _key_paths(got) == _key_paths(want)
    for name in ("GOODPUT_SPEEDUP_FLOOR", "THROUGHPUT_SPEEDUP_FLOOR", "SPEC_RETRACE_CEILING",
                 "HOST_SYNCS_PER_TOKEN_CEILING"):
        assert getattr(tfb, name) == getattr(jfb, name)


@pytest.mark.parametrize("path", FD_DETERMINISTIC, ids="/".join)
def test_frontdoor_deterministic_fields_equal_jax(frontdoor_reports, path):
    want, got = frontdoor_reports
    assert _at(got, path) == _at(want, path)


def test_frontdoor_counts_and_audit(frontdoor_reports):
    _, got = frontdoor_reports
    assert got["spec_retrace_count"] == 0
    assert got["parity_spot_check"] is True
    served = FD_ARGS["streams"] * FD_ARGS["max_new_tokens"]
    assert got["sequential"]["tokens"] == got["frontdoor"]["tokens"] == served
    # The CPU reports reads only: the first token of each admission and
    # one per step, under one per token.
    assert 0 < got["frontdoor_host_syncs_per_token"] < 1.0
    assert isinstance(got["failures"], list) and got["passed"] == (not got["failures"])


def test_router_report_keys_and_gates_equal_jax(router_reports):
    want, got = router_reports
    assert _key_paths(got) == _key_paths(want)
    for name in ("SCALEOUT_FLOOR_PER_ENGINE", "SPEC_RETRACE_CEILING", "LOST_REQUEST_CEILING",
                 "PACED_UTILIZATION", "KILL_UTILIZATION"):
        assert getattr(trb, name) == getattr(jrb, name)


@pytest.mark.parametrize("path", ROUTER_DETERMINISTIC, ids="/".join)
def test_router_deterministic_fields_equal_jax(router_reports, path):
    want, got = router_reports
    assert _at(got, path) == _at(want, path)


def test_router_kill_loses_nothing_and_the_port_never_recaptures(router_reports):
    _, got = router_reports
    assert got["spec_retrace_count"] == 0
    assert got["router_lost_requests"] == 0
    assert got["kill_scenario"]["mismatched_streams"] == 0


def test_the_exactness_probe_holds_a_front_door_to_the_stream(monkeypatch):
    """``python -m tpuslo_torch.benchmark.probes exactness`` on the CPU at
    ``llama_tiny``'s widths in f32: the 2-slot front door's streams equal
    the single stream's, as the bench's spot check requires."""
    from tpuslo_torch.benchmark import probes
    from tpuslo_torch.models import llama

    monkeypatch.setattr(probes.llama, "llama32_3b",
                        lambda max_seq_len=192: llama.llama_tiny(max_seq_len=max_seq_len))
    rows = probes.exactness("float32", 2, 12, "cpu")
    assert [(r["tokens"], r["parted_at"]) for r in rows] == [(12, None), (12, None)]


def test_the_router_probe_splits_ttft_by_prefix_state_and_depth(monkeypatch):
    """``python -m tpuslo_torch.benchmark.probes router`` on the CPU at the
    cut router bench: the paced affinity and random passes' TTFTs split by
    the prefix state met at routing and by the replica's queue depth, each
    split counting every timed request of its pass once, and the router's
    methods put back after the run."""
    from tpuslo_torch.benchmark import probes
    from tpuslo_torch.models import router as router_mod

    run = trb.run_router_bench
    monkeypatch.setattr(probes.router_bench, "run_router_bench",
                        lambda device: run(**ROUTER_ARGS, device=device))
    route = router_mod.SLORouter.route
    (row,) = probes.router(1, "cpu")
    assert router_mod.SLORouter.route is route
    assert set(row["split"]) == {"affinity", "random"}
    for side, split in row["split"].items():
        n = sum(s["n"] for s in split["ttft_by_state"].values())
        assert n == sum(s["n"] for s in split["ttft_by_depth"].values())
        assert n == sum(split["requests_by_engine"]) > 0
        assert set(split["ttft_by_state"]) <= {"warm", "cold", "plain"}
        assert all(s["p50_ms"] <= s["p99_ms"] for s in split["ttft_by_state"].values())
        assert split["slowest_1pct"]["n"] == sum(split["slowest_1pct"]["states"].values())


def test_the_router_probe_splits_admission_host_time(monkeypatch):
    """The router probe splits each admission kind's host time into the
    launch of its prefill pieces, its read wait, the work after the read
    and the rest, and reports every fill's admissions and host reads; the
    front door's and the read's methods are put back after the run."""
    import gc

    from tpuslo_torch.benchmark import probes
    from tpuslo_torch.models import frontdoor, serve

    run = trb.run_router_bench
    monkeypatch.setattr(probes.router_bench, "run_router_bench",
                        lambda device: run(**ROUTER_ARGS, device=device))
    def methods():
        fd = frontdoor.FrontDoorEngine
        return (fd._admit, fd._admit_batch, fd._admit_both, fd._fill_slots,
                serve._HostRead.values)

    before, callbacks = methods(), list(gc.callbacks)
    (row,) = probes.router(1, "cpu")
    assert methods() == before and gc.callbacks == callbacks
    assert {"warm", "plain_batch"} <= set(row["admissions"])
    assert set(row["gc"]) == {"affinity", "random"}
    assert all(g["n"] >= g["gen2"] >= 0 and g["total_ms"] >= g["max_ms"] >= 0
               for g in row["gc"].values())
    for kind, admits in row["admissions"].items():
        assert admits["n"] > 0
        assert admits["launch_median_ms"] > 0
        assert min(admits[f"{p}_median_ms"] for p in ("wait", "after_read")) >= 0
    fills = row["fills"]
    assert fills["n"] > 0 and fills["reads_median"] >= 1
    assert fills["admissions_max"] >= 1
