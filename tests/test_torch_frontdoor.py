"""Serving front door: ``tpuslo_torch.models.frontdoor`` against the JAX
engine.

Every scenario of ``tests/test_frontdoor.py`` is written once, as a
function of a *side* (one framework's classes and engines), and run on
both sides: the JAX ``FrontDoorEngine`` and the port's, on ``llama_tiny``
in f32 on the CPU over the same weights (drawn by JAX, carried over as
numpy).  What a scenario observes must be equal on both sides: token
streams, shed requests by reason, preemption and resume counts, rounds
and accepted draft tokens.  The JAX test's own assertions are then made
on the port's observation.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo import remediation as jrem  # noqa: E402
from tpuslo import runtime as jruntime  # noqa: E402
from tpuslo.attribution.bayesian import BayesianAttributor as JBayesianAttributor  # noqa: E402
from tpuslo.faultreplay.generator import generate_fault_samples as jreplay  # noqa: E402
from tpuslo.models import frontdoor as jfd  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import speculative as jsp  # noqa: E402
from tpuslo.sloengine import engine as jslo  # noqa: E402
from tpuslo.sloengine.stream import RequestOutcome as JRequestOutcome  # noqa: E402
from tpuslo_torch import remediation as trem  # noqa: E402
from tpuslo_torch import runtime as truntime  # noqa: E402
from tpuslo_torch.attribution.bayesian import BayesianAttributor as TBayesianAttributor  # noqa: E402
from tpuslo_torch.faultreplay.generator import generate_fault_samples as treplay  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import frontdoor as tfd  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.models import speculative as tsp  # noqa: E402
from tpuslo_torch.sloengine import engine as tslo  # noqa: E402
from tpuslo_torch.sloengine.stream import RequestOutcome as TRequestOutcome  # noqa: E402

CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny models gain nothing from intra-op threads, and several
    test workers on one machine lose a lot to them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sides():
    """(JAX side, port side): each with a self-draft pair ``engines`` and
    a genuinely different pair ``real``, all over the same weights."""
    def engines(seed):
        pj = jl.init_params(jax.random.PRNGKey(seed), CFG_J)
        pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
        return (lambda: js.ServeEngine(cfg=CFG_J, params=pj),
                lambda: ts.ServeEngine(cfg=CFG_T, params=pt, device="cpu"))

    mk_j0, mk_t0 = engines(0)
    mk_j7, mk_t7 = engines(7)
    target_j, target_t = mk_j0(), mk_t0()
    jax_side = SimpleNamespace(
        name="jax", mod=jfd, slo=jslo, RequestOutcome=JRequestOutcome,
        SpeculativeEngine=jsp.SpeculativeEngine, runtime=jruntime, rem=jrem,
        replay=jreplay, BayesianAttributor=JBayesianAttributor,
        engines=(target_j, mk_j0()), real=(target_j, mk_j7()),
    )
    port_side = SimpleNamespace(
        name="port", mod=tfd, slo=tslo, RequestOutcome=TRequestOutcome,
        SpeculativeEngine=tsp.SpeculativeEngine, runtime=truntime, rem=trem,
        replay=treplay, BayesianAttributor=TBayesianAttributor,
        engines=(target_t, mk_t0()), real=(target_t, mk_t7()),
    )
    return jax_side, port_side


def observe(fd) -> dict:
    """Everything a scenario's outcome is judged by, as plain data."""
    return {
        "results": {rid: list(toks) for rid, toks in fd.results.items()},
        "shed_requests": dict(fd.shed_requests),
        "shed_by_reason": dict(fd.shed_by_reason),
        "preemptions": fd.preemptions,
        "resumes": fd.resumes,
        "snapshot_resumes": fd.snapshot_resumes,
        "rounds": fd.rounds,
        "slot_rounds": fd.slot_rounds,
        "accepted_draft_tokens": fd.accepted_draft_tokens,
        "emitted_tokens": fd.emitted_tokens,
        "paged": (fd.paged_parks, fd.paged_resumes, fd.paged_fallback_parks),
    }


def both(sides, scenario):
    """Run ``scenario(side)`` on both sides, require equal observations,
    return the port's."""
    want, got = scenario(sides[0]), scenario(sides[1])
    assert got == want
    return got


def spec_reference(side, pair, prompt, n, stop_at_eos=False, prefix=None):
    spec = side.SpeculativeEngine(pair[0], pair[1], k=3)
    return spec.generate(prompt, max_new_tokens=n, stop_at_eos=stop_at_eos, prefix=prefix)


def make_burning_engine(side, tenant: str, now_s: float = 10_000.0):
    """A real BurnEngine with ``tenant`` in fast burn at ``now_s``."""
    burn = side.slo.BurnEngine()
    for j in range(600):
        burn.record(side.RequestOutcome(
            tenant=tenant, ts_unix_nano=int((now_s - 1500.0 + j * 2.5) * 1e9),
            ttft_ms=50.0, tpot_ms=10.0, tokens=8,
            status="error" if j % 2 == 0 else "ok",
        ))
    burn.evaluate(now_s)
    assert burn.tenant_burn_state(tenant) == "fast_burn"
    return burn


def serve_all(side, pair, prompts, budgets, refs=True, stop_at_eos=False, prefix=None, **kw):
    """Submit, run, and return the observation plus each request's
    stream beside the per-stream speculative reference."""
    fd = side.mod.FrontDoorEngine(*pair, k=3, max_slots=2, **kw)
    ids = [fd.submit(p, max_new_tokens=b, stop_at_eos=stop_at_eos, prefix=prefix)
           for p, b in zip(prompts, budgets)]
    results = fd.run()
    out = observe(fd)
    out["ids"] = ids
    if refs:
        out["refs"] = [spec_reference(side, pair, p, b, stop_at_eos, prefix)
                       for p, b in zip(prompts, budgets)]
        assert [results[rid] for rid in ids] == out["refs"]
    return out


# ---- exactness ---------------------------------------------------------


class TestStreamParity:
    def test_matches_per_stream_speculative(self, sides):
        prompts = [f"hello world {i}" for i in range(5)]
        both(sides, lambda s: serve_all(s, s.engines, prompts, [10] * 5))

    @pytest.mark.parametrize("rounds_per_step", [1, 2, 3])
    def test_multi_round_dispatch_parity(self, sides, rounds_per_step):
        prompts = [f"multi round {i}" for i in range(5)]
        got = both(sides, lambda s: serve_all(
            s, s.engines, prompts, [11] * 5, rounds_per_step=rounds_per_step))
        assert got["slot_rounds"] > 0

    def test_real_draft_pair_parity(self, sides):
        """A draft that actually disagrees exercises partial-acceptance
        frontiers across slots."""
        prompts = [f"disagreeing draft {i}" for i in range(4)]
        got = both(sides, lambda s: serve_all(s, s.real, prompts, [12] * 4))
        assert got["accepted_draft_tokens"] < got["slot_rounds"] * 3

    def test_stop_at_eos_respected(self, sides):
        prompts = [f"eos probe {i}" for i in range(3)]
        got = both(sides, lambda s: serve_all(s, s.engines, prompts, [16] * 3, stop_at_eos=True))
        for rid in got["ids"]:
            assert ts.EOS not in got["results"][rid][:-1]

    def test_mixed_budgets_and_more_requests_than_slots(self, sides):
        budgets = [3, 9, 1, 14, 6, 2, 11]
        prompts = [f"budget {i}" for i in range(len(budgets))]
        got = both(sides, lambda s: serve_all(s, s.engines, prompts, budgets))
        assert [len(got["results"][rid]) for rid in got["ids"]] == budgets


# ---- admission policy --------------------------------------------------


class TestAdmissionPolicy:
    def test_burn_demotion_changes_admission_order(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, burn_engine=burn)
            order: list[str] = []

            class Obs(s.mod.FrontDoorObserver):
                def admitted(self, tenant: str) -> None:
                    order.append(tenant)

            fd._observer = Obs()
            for prompt, tenant in (("first in line", "lowly"), ("second in line", "vip"),
                                   ("third in line", "vip")):
                fd.submit(prompt, tenant=tenant, max_new_tokens=4, stop_at_eos=False)
            fd.run()
            return {**observe(fd), "order": order}

        assert both(sides, scenario)["order"] == ["vip", "vip", "lowly"]

    def test_fast_burn_state_deprioritizes_without_demotion(self, sides):
        def scenario(s):
            burn = make_burning_engine(s, "burny")
            fd = s.mod.FrontDoorEngine(*s.engines, burn_engine=burn)
            return (burn.admission_priority("burny"), fd.effective_priority("burny"),
                    fd.effective_priority("healthy"))

        assert both(sides, scenario) == (
            tslo.DEFAULT_ADMISSION_PRIORITY, tfd.DEMOTED_PRIORITY,
            tslo.DEFAULT_ADMISSION_PRIORITY)

    def test_full_queue_sheds_by_reason(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, max_queue=2,
                                       burn_engine=burn)
            keep = fd.submit("occupies the slot", max_new_tokens=30, stop_at_eos=False)
            fd.step()  # admit into the slot; queue now empty
            fd.submit("queued 1", tenant="lowly", max_new_tokens=4)
            fd.submit("queued 2", tenant="lowly", max_new_tokens=4)
            # Queue full; an equal-or-lower arrival sheds itself...
            shed_low = fd.submit("refused", tenant="lowly", max_new_tokens=4)
            # ...while a higher-priority arrival displaces a queued one.
            kept_hi = fd.submit("displaces", tenant="vip", max_new_tokens=4)
            fd2 = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, max_queue=1)
            fd2.submit("slot", max_new_tokens=30, stop_at_eos=False)
            fd2.step()
            fd2.submit("queued", max_new_tokens=4)
            plain = fd2.submit("refused", max_new_tokens=4)
            fd.run()
            return {**observe(fd), "keep": keep, "shed_low": shed_low, "kept_hi": kept_hi,
                    "plain": plain, "plain_reasons": dict(fd2.shed_by_reason)}

        got = both(sides, scenario)
        assert got["shed_low"] is None and got["kept_hi"] is not None and got["plain"] is None
        assert got["shed_by_reason"] == {tfd.SHED_BURNING: 1, tfd.SHED_DISPLACED: 1,
                                         tfd.SHED_QUEUE_FULL: 0}
        assert got["plain_reasons"][tfd.SHED_QUEUE_FULL] == 1
        assert sorted(got["shed_requests"].values()) == sorted(
            [tfd.SHED_BURNING, tfd.SHED_DISPLACED])
        assert got["keep"] in got["results"]

    def test_shed_records_failed_outcome_for_shed_tenant(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, max_queue=1,
                                       burn_engine=burn)
            fd.submit("slot", max_new_tokens=30, stop_at_eos=False)
            fd.step()
            fd.submit("queued", max_new_tokens=4)
            before = burn.recorded
            refused = fd.submit("refused", tenant="lowly", max_new_tokens=4)
            return refused, burn.recorded - before

        assert both(sides, scenario) == (None, 1)

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_preempted_slot_resumes_bit_identical(self, sides, paged):
        """Park-and-resume parity vs an uncontended run; the parked rows
        are copies, so the rounds that run meanwhile do not touch them."""
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2, burn_engine=burn,
                                       paged=paged, block_size=32)
            low = [fd.submit(f"low stream {i}", tenant="lowly", max_new_tokens=24,
                             stop_at_eos=False) for i in range(2)]
            for _ in range(2):
                fd.step()
            hi = fd.submit("high priority arrives", tenant="vip", max_new_tokens=8,
                           stop_at_eos=False)
            results = fd.run()
            for i, rid in enumerate(low):
                assert results[rid] == spec_reference(s, s.engines, f"low stream {i}", 24)
            assert results[hi] == spec_reference(s, s.engines, "high priority arrives", 8)
            return {**observe(fd), "free": fd.stats()["paged"]["free_blocks"],
                    "pool": fd.stats()["paged"]["pool_blocks"]}

        got = both(sides, scenario)
        assert got["preemptions"] >= 1 and got["resumes"] >= 1
        if paged:
            parks, resumes, fallbacks = got["paged"]
            assert parks >= 1 and resumes >= 1 and fallbacks == 0
            assert got["free"] == got["pool"] - 1  # every parked block came back

    def test_equal_priorities_never_preempt(self, sides):
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1)
            fd.submit("long runner", max_new_tokens=20, stop_at_eos=False)
            fd.step()
            fd.submit("same priority", max_new_tokens=4, stop_at_eos=False)
            fd.run()
            return observe(fd)

        assert both(sides, scenario)["preemptions"] == 0


# ---- prefix-cache-aware placement --------------------------------------


class TestPrefixPlacement:
    PREFIX = "[system] You are a terse assistant."

    def test_prefix_streams_match_reference(self, sides):
        prompts = [f" question {i}?" for i in range(4)]
        both(sides, lambda s: serve_all(s, s.engines, prompts, [8] * 4, prefix=self.PREFIX))

    def test_warm_prefix_is_reused_after_the_first_admission(self, sides):
        """The second same-prefix request reuses the KV snapshot: the
        prefix is ingested once per engine, the later admissions prefill
        only their suffix.  The front door admits through each engine's
        admission pieces, whose ``ingest`` is the engine's full ingestion
        there; both are counted."""
        _, s = sides
        target, draft = s.engines
        prefix = "[system] a fresh prefix never cached before this test."
        fd = s.mod.FrontDoorEngine(target, draft, k=3, max_slots=1)
        assert not fd._prefix_warm(prefix)
        heads = []
        spied = [(eng, "_ingest_ids") for eng in (target, draft)]
        spied += [(adm, "ingest") for adm in fd._adms]
        for owner, name in spied:
            orig = getattr(owner, name)
            setattr(owner, name, lambda ids, _orig=orig: heads.append(len(ids)) or _orig(ids))
        try:
            for i in range(3):
                fd.submit(f" ask {i}?", max_new_tokens=2, stop_at_eos=False, prefix=prefix)
                fd.run()
        finally:
            for owner, name in spied:
                delattr(owner, name)
        assert fd._prefix_warm(prefix)
        assert len(heads) == 2  # one full ingestion per engine, for the cold request

    def test_warm_prefix_requests_sort_together(self, sides):
        def scenario(s):
            target, draft = s.engines
            fd = s.mod.FrontDoorEngine(target, draft, k=3, max_slots=1)
            warm_prefix = "[system] warm group prefix."
            target.cache_prefix(warm_prefix)
            draft.cache_prefix(warm_prefix)
            fd.submit("occupy", max_new_tokens=6, stop_at_eos=False)
            fd.step()
            cold = fd.submit(" cold", max_new_tokens=2, stop_at_eos=False,
                             prefix="[system] cold group prefix.")
            warm = fd.submit(" warm", max_new_tokens=2, stop_at_eos=False, prefix=warm_prefix)
            fd._queue.sort(key=fd._order_key)
            order = [r.request_id for r in fd._queue]
            fd.run()
            return {**observe(fd), "order": order, "expect": [warm, cold]}

        got = both(sides, scenario)
        assert got["order"] == got["expect"]


# ---- burn-engine feedback ----------------------------------------------


class TestOutcomeFeedback:
    def test_completions_record_outcomes(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2, burn_engine=burn)
            fd.submit("tenant a stream", tenant="a", max_new_tokens=6, stop_at_eos=False)
            fd.submit("tenant b stream", tenant="b", max_new_tokens=6, stop_at_eos=False)
            fd.run()
            return burn.recorded, burn.snapshot()["tenants"]

        assert both(sides, scenario) == (2, 2)

    def test_outcome_timestamps_follow_the_injected_clock(self, sides):
        """The injectable ``clock=`` drives every request timestamp and
        the burn engine's event time (anchored at ``time.time_ns()``)."""
        _, s = sides
        now = [100.0]
        seen = []

        class Burn:
            def admission_priority(self, tenant):
                return 100

            def tenant_burn_state(self, tenant):
                return "ok"

            def record(self, outcome):
                seen.append(outcome)

        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, burn_engine=Burn(),
                                   clock=lambda: now[0])
        rid = fd.submit("clocked", max_new_tokens=20, stop_at_eos=False)
        now[0] = 102.0
        fd.step()
        now[0] = 105.0
        fd.run()
        timing = fd.request_timings()[rid]
        assert timing["ttft_s"] == 2.0 and timing["e2e_s"] == 5.0
        assert seen[0].ttft_ms == 2000.0 and seen[0].status == "ok"
        assert seen[0].ts_unix_nano == fd._epoch_ns + int(5e9)


# ---- lifecycle / telemetry ---------------------------------------------


class TestLifecycle:
    def test_bad_args_rejected(self, sides):
        _, s = sides
        for kw in ({"k": 0}, {"max_slots": 0}, {"max_queue": 0}, {"rounds_per_step": 0}):
            with pytest.raises(ValueError):
                s.mod.FrontDoorEngine(*s.engines, **kw)
        with pytest.raises(ValueError, match="block_size"):
            s.mod.FrontDoorEngine(*s.engines, paged=True, block_size=48)

    def test_priority_scale_is_the_sloengine_scale(self):
        assert tfd.DEFAULT_PRIORITY is tslo.DEFAULT_ADMISSION_PRIORITY
        assert tfd.DEMOTED_PRIORITY is tslo.DEMOTED_ADMISSION_PRIORITY
        assert (tfd.DEFAULT_PRIORITY, tfd.DEMOTED_PRIORITY) == (
            jfd.DEFAULT_PRIORITY, jfd.DEMOTED_PRIORITY)
        assert tfd.SHED_REASONS == jfd.SHED_REASONS
        assert tfd.STATE_VERSION == jfd.STATE_VERSION == 1

    def test_cancel_completed_clears_both_result_surfaces(self, sides):
        _, s = sides
        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1)
        rid = fd.submit("done then cancelled", max_new_tokens=6, stop_at_eos=False)
        fd.run()
        assert rid in fd.request_timings()
        fd.cancel(rid)
        assert rid not in fd.results
        assert rid not in fd.request_timings()

    def test_partial_tokens_and_cancel(self, sides):
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1)
            a = fd.submit("running stream", max_new_tokens=20, stop_at_eos=False)
            b = fd.submit("queued stream", max_new_tokens=4, stop_at_eos=False)
            fd.step()
            partial = (fd.partial_tokens(a), fd.partial_tokens(b), fd.partial_tokens(999))
            fd.cancel(b)
            after = fd.partial_tokens(b)
            fd.run()
            return {**observe(fd), "partial": partial, "after": after, "a": a, "b": b}

        got = both(sides, scenario)
        assert len(got["partial"][0]) >= 1 and got["partial"][1:] == ([], None)
        assert got["after"] is None
        assert got["b"] not in got["results"] and got["a"] in got["results"]

    def test_stats_and_timings(self, sides):
        _, s = sides
        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
        rid = fd.submit("timed stream", max_new_tokens=8, stop_at_eos=False)
        fd.run()
        stats = fd.stats()
        assert stats["completed"] == 1
        assert stats["acceptance_rate"] == 1.0  # self-draft
        assert stats["emitted_tokens"] == 8
        ledger = stats["dispatch_ledger"]
        assert ledger["steps"] == fd.rounds and ledger["tokens_total"] == 7
        record = fd.request_timings()[rid]
        assert record["ttft_s"] >= 0.0
        assert record["e2e_s"] >= record["ttft_s"]
        assert record["tpot_s"] > 0.0
        assert record["tenant"] == "default"
        assert fd.device == s.engines[0].device

    def test_stats_keys_equal_jax(self, sides):
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2, paged=True)
            fd.submit("keys", max_new_tokens=4, stop_at_eos=False)
            fd.run()
            stats = fd.stats()
            return (sorted(stats), sorted(stats["paged"]), stats["paged"],
                    sorted(stats["dispatch_ledger"]), sorted(fd.export_state()))

        both(sides, scenario)

    def test_instant_complete_requests_never_hold_slots(self, sides):
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1)
            ids = [fd.submit(f"instant {i}", max_new_tokens=1, stop_at_eos=False)
                   for i in range(3)]
            results = fd.run()
            for i, rid in enumerate(ids):
                assert results[rid] == spec_reference(s, s.engines, f"instant {i}", 1)
            return observe(fd)

        assert both(sides, scenario)["rounds"] == 0  # nothing needed a decode round

    def test_one_read_per_step_and_none_in_the_round(self, sides):
        """A steady ``step()`` (no admission) reads the host once."""
        _, s = sides
        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2, rounds_per_step=2)
        for i in range(2):
            fd.submit(f"steady {i}", max_new_tokens=40, stop_at_eos=False)
        fd.step()  # admission: first-token read plus the step's read
        for _ in range(3):
            reads = ts._HostRead.reads
            assert fd.step()
            assert ts._HostRead.reads - reads == 1
        fd.run()

    def test_a_self_tracer_sees_the_four_stages(self, sides):
        """``self_tracer=`` stays duck-typed: any object with
        ``cycle(name, **attrs)`` is driven through the four stages, and
        the retire span carries the dispatch ledger."""
        _, s = sides
        stages, attrs = [], {}

        class Span:
            def set(self, **kw):
                attrs.update(kw)

        class Stage:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                stages.append(self.name)
                return Span()

            def __exit__(self, *exc):
                return False

        class Cycle:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def stage(self, name, **kw):
                return Stage(name)

        class Tracer:
            def cycle(self, name, **kw):
                assert name == "frontdoor.step"
                return Cycle()

        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, self_tracer=Tracer())
        fd.submit("traced", max_new_tokens=6, stop_at_eos=False)
        fd.step()
        assert stages == ["admit", "dispatch", "read", "retire"]
        assert attrs["slots"] == 1 and "device_wait_ms_total" in attrs
        fd.run()


# ---- snapshot / restore -------------------------------------------------


class TestSnapshotRestore:
    def test_export_restore_round_trip_json_safe(self, sides):
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            for name in ("stream one", "stream two", "queued three"):
                fd.submit(name, max_new_tokens=24, stop_at_eos=False)
            fd.step()
            state = json.loads(json.dumps(fd.export_state()))
            fd2 = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            fd2.restore_state(state)
            return state, len(fd2._queue), fd2._next_id == fd._next_id

        state, queued, same_next = both(sides, scenario)
        assert queued == 3 and same_next  # 2 in flight + 1 queued
        assert state["version"] == tfd.STATE_VERSION

    def test_restart_mid_serve_on_a_fresh_engine(self, sides):
        """Kill mid-serve, restore a JSON snapshot into a fresh engine,
        finish: per-request streams equal the uninterrupted reference.
        (The agent runtime's state store carries the same snapshot in
        ``test_restart_mid_serve_through_agent_runtime``.)"""
        def scenario(s):
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            prompts = [f"restart stream {i}" for i in range(4)]
            ids = [fd.submit(p, max_new_tokens=18, stop_at_eos=False) for p in prompts]
            for _ in range(2):
                fd.step()
            blob = json.dumps(fd.export_state())
            del fd  # the "crash"
            fd2 = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            fd2.restore_state(json.loads(blob))
            results = fd2.run()
            for prompt, rid in zip(prompts, ids):
                assert results[rid] == spec_reference(s, s.engines, prompt, 18)
            return observe(fd2)

        assert both(sides, scenario)["snapshot_resumes"] >= 1

    def test_restart_mid_serve_through_agent_runtime(self, sides, tmp_path):
        """Kill mid-serve, restore through the side's own ``StateStore``
        and ``AgentRuntime``, finish: per-request streams equal the
        uninterrupted reference, and equal on both sides."""
        def scenario(s):
            store_path = tmp_path / s.name / "state.json"
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(store_path, interval_s=0.0))
            fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            runtime.register("frontdoor", fd.export_state, fd.restore_state)
            prompts = [f"restart stream {i}" for i in range(4)]
            ids = [fd.submit(p, max_new_tokens=18, stop_at_eos=False) for p in prompts]
            for _ in range(2):
                fd.step()
            assert runtime.snapshot_now()
            del fd  # the "crash"
            runtime2 = s.runtime.AgentRuntime(s.runtime.StateStore(store_path))
            fd2 = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
            runtime2.register("frontdoor", fd2.export_state, fd2.restore_state)
            assert runtime2.restore() == "restored"
            results = fd2.run()
            assert fd2.snapshot_resumes >= 1
            for prompt, rid in zip(prompts, ids):
                assert results[rid] == spec_reference(s, s.engines, prompt, 18)
            return observe(fd2)

        assert both(sides, scenario)["snapshot_resumes"] >= 1

    def test_a_snapshot_crosses_the_frameworks(self, sides):
        """A snapshot exported by the JAX engine mid-serve restores into
        the port's engine, which finishes every stream as JAX would."""
        j, t = sides
        fd = j.mod.FrontDoorEngine(*j.engines, k=3, max_slots=2)
        prompts = [f"crossing stream {i}" for i in range(3)]
        ids = [fd.submit(p, max_new_tokens=14, stop_at_eos=False) for p in prompts]
        fd.step()
        blob = json.dumps(fd.export_state())
        want = fd.run()
        fd2 = t.mod.FrontDoorEngine(*t.engines, k=3, max_slots=2)
        fd2.restore_state(json.loads(blob))
        got = fd2.run()
        assert {rid: got[rid] for rid in ids} == {rid: want[rid] for rid in ids}

    def test_restore_rejects_unknown_version(self, sides):
        _, s = sides
        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
        fd.restore_state({"version": 99, "queue": [{"request_id": 1}]})
        assert fd._queue == []
        fd.restore_state("not a dict")
        assert fd._queue == []


# ---- remediation end to end ---------------------------------------------


def test_hbm_attribution_demotes_tenant_in_live_admission(sides):
    """fault replay → ``BayesianAttributor`` → remediation policy →
    ``DemoteTenantAction`` → the live admission order flips, on both
    packages (the JAX package runs this chain only as a slow test).
    Nothing is scripted: the posterior comes from a real hbm_pressure
    fault profile, the policy gates on it and on real fast-burn state,
    the action mutates the real ``BurnEngine``, and the front door, which
    reads that engine live, admits the demoted tenant last."""
    from datetime import datetime, timezone

    def scenario(s):
        tenant, now_s = "burny", 10_000.0
        burn = make_burning_engine(s, tenant, now_s)
        order: list[str] = []

        class Obs(s.mod.FrontDoorObserver):
            def admitted(self, t: str) -> None:
                order.append(t)

        fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, burn_engine=burn,
                                   observer=Obs())
        # Before remediation: fast burn already deprioritizes, but the
        # remediation surface itself is untouched.
        assert burn.admission_priority(tenant) == s.slo.DEFAULT_ADMISSION_PRIORITY

        sample = s.replay("hbm_pressure", 1,
                          start=datetime.fromtimestamp(now_s, tz=timezone.utc))[0]
        attribution = s.BayesianAttributor().attribute_sample(sample)
        assert attribution.predicted_fault_domain == "tpu_hbm"
        engine = s.rem.RemediationEngine(bindings=s.rem.ActionBindings(burn_engine=burn))
        record = engine.consider(s.rem.AttributionContext(
            incident_id="inc-e2e-hbm", domain=attribution.predicted_fault_domain,
            confidence=attribution.confidence, burn_state=burn.tenant_burn_state(tenant),
            burn_rate=burn.max_active_burn(), tenant=tenant, at_s=now_s), now_s)
        assert record is not None and record.phase == "verifying"
        assert burn.admission_priority(tenant) == s.slo.DEMOTED_ADMISSION_PRIORITY

        # The live scheduling change: the demoted tenant queued first
        # still serves last.
        fd.submit("demoted tenant request", tenant=tenant, max_new_tokens=3,
                  stop_at_eos=False)
        fd.submit("healthy tenant request", tenant="healthy", max_new_tokens=3,
                  stop_at_eos=False)
        fd.run()
        assert order == ["healthy", tenant]
        return {"order": list(order), "record": record.to_dict(),
                "confidence": attribution.confidence, "priority": burn.admission_priority(tenant),
                "fd": observe(fd)}

    both(sides, scenario)


# ---- parked state across the bridge --------------------------------------


def test_a_request_parked_by_jax_resumes_in_the_port(sides):
    """A dense parked snapshot ``(row_t, row_d, current, frontier)``
    drained from the JAX front door mid-stream is carried over as numpy
    and adopted by the port's front door, which finishes the stream as
    the uninterrupted reference would; and back the other way."""
    j, t = sides
    want = spec_reference(t, t.engines, "parked across", 20)
    for src, dst, cfg_t, cfg_d in ((j, t, CFG_T, CFG_T), (t, j, CFG_J, CFG_J)):
        fd = src.mod.FrontDoorEngine(*src.engines, k=3, max_slots=1)
        fd.submit("parked across", max_new_tokens=20, stop_at_eos=False)
        for _ in range(2):
            fd.step()
        (req,) = fd.drain()
        row_t, row_d, current, frontier = req.parked
        if src is j:
            tree = {"row_t": jax.tree.map(np.asarray, row_t),
                    "row_d": jax.tree.map(np.asarray, row_d),
                    "current": current, "frontier": frontier}
            parked = bridge.parked_from_numpy(tree, cfg_t, cfg_d, "cpu")
        else:
            tree = bridge.parked_to_numpy(req.parked)
            assert tree["row_t"]["k"].dtype == np.float32
            parked = (
                {**jax.tree.map(jnp.asarray, tree["row_t"]),
                 "length": jnp.asarray(tree["frontier"], jnp.int32)},
                {**jax.tree.map(jnp.asarray, tree["row_d"]),
                 "length": jnp.asarray(tree["frontier"], jnp.int32)},
                tree["current"], tree["frontier"],
            )
        adopted = dst.mod.FrontDoorRequest(
            request_id=0, tenant=req.tenant, prompt=req.prompt,
            max_new_tokens=req.max_new_tokens, stop_at_eos=req.stop_at_eos,
            prefix=req.prefix, submitted_s=0.0, tokens=list(req.tokens), parked=parked,
        )
        fd2 = dst.mod.FrontDoorEngine(*dst.engines, k=3, max_slots=1)
        rid = fd2.adopt(adopted)
        assert fd2.run()[rid] == want
        assert fd2.resumes == 1


def test_parked_rows_are_copies_not_views_of_the_pool(sides):
    """In-place caches: a parked row must survive the rounds that run
    after the park (the JAX engine gets this from immutable arrays)."""
    _, s = sides
    burn = s.slo.BurnEngine()
    burn.demote_tenant("lowly")
    fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=1, burn_engine=burn)
    fd.submit("to be parked", tenant="lowly", max_new_tokens=30, stop_at_eos=False)
    fd.step()
    fd.submit("takes the slot", tenant="vip", max_new_tokens=40, stop_at_eos=False)
    fd._fill_slots()  # parks the running request, admits the arrival
    (parked_req,) = fd._queue
    row_t, row_d, _current, frontier = parked_req.parked
    before = [row_t["k"].clone(), row_t["v"].clone(), row_d["k"].clone(), row_d["v"].clone()]
    for _ in range(2):  # 4 further rounds, the arrival still running
        fd.step()
    assert fd._queue == [parked_req]
    after = [row_t["k"], row_t["v"], row_d["k"], row_d["v"]]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(fd._cache_t["k"][:, 0, :frontier], row_t["k"][:, 0, :frontier])
    fd.run()


# ---- fixed storage: what the dispatch's CUDA graph rests on ---------------


def _fixed_storage(fd) -> dict:
    """data_ptr() of every buffer a front door's graph reads or writes:
    each cache leaf (K/V and lengths) of both pools, the current tokens,
    the staged frontiers and mask, and the captured output (a card
    only)."""
    ptrs = {}
    for name, pool in (("t", fd._cache_t), ("d", fd._cache_d)):
        for side in ("k", "v", "length"):
            leaves = pool[side] if isinstance(pool[side], dict) else {"": pool[side]}
            for leaf, t in leaves.items():
                ptrs[f"{name}.{side}{leaf}"] = t.data_ptr()
    ptrs["tokens"] = fd._tokens.data_ptr()
    ptrs["start"] = fd._start_in.tensor.data_ptr()
    ptrs["active"] = fd._active_in.tensor.data_ptr()
    if fd._dispatch.outputs is not None:
        ptrs["packed"] = fd._dispatch.outputs.data_ptr()
    return ptrs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_storage_stays_fixed_across_steps_admissions_parks_resumes_and_a_drain(sides, paged):
    """Admission (batched and prefix), preemption into a park, the resume,
    steady steps and a kill-drain onto a sibling all write the pools in
    place: no buffer of either engine is ever rebound, and the streams
    still equal the per-stream reference."""
    _, s = sides
    burn = s.slo.BurnEngine()
    burn.demote_tenant("lowly")
    make = lambda: s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2, burn_engine=burn,  # noqa: E731
                                         paged=paged, block_size=32)
    fd, sibling = make(), make()
    fixed, fixed_sibling = _fixed_storage(fd), _fixed_storage(sibling)
    low = [fd.submit(f"fixed low {i}", tenant="lowly", max_new_tokens=24, stop_at_eos=False)
           for i in range(2)]
    fd.step()  # a batched admission
    assert _fixed_storage(fd) == fixed
    hi = fd.submit("fixed vip", tenant="vip", max_new_tokens=8, stop_at_eos=False,
                   prefix="a shared preamble")
    fd.step()  # a park and a prefix admission
    assert fd.preemptions == 1 and _fixed_storage(fd) == fixed
    results = {}
    while fd.resumes == 0:
        fd.step()
    assert _fixed_storage(fd) == fixed
    results[hi] = fd.results[hi]
    fd.submit("drained later", tenant="vip", max_new_tokens=12, stop_at_eos=False)
    fd.step()
    moved = {req.prompt: sibling.adopt(req) for req in fd.drain()}
    assert _fixed_storage(fd) == fixed
    finished = sibling.run()
    assert _fixed_storage(sibling) == fixed_sibling
    for i, rid in enumerate(low):
        got = fd.results.get(rid) or finished[moved[f"fixed low {i}"]]
        assert got == spec_reference(s, s.engines, f"fixed low {i}", 24)
    assert results[hi] == spec_reference(s, s.engines, "fixed vip", 8, prefix="a shared preamble")
    assert finished[moved["drained later"]] == spec_reference(s, s.engines, "drained later", 12)


def test_restore_state_readmits_into_the_engines_own_storage(sides):
    """``restore_state`` fills in host state on an engine that already
    exists; the requests it re-queues are re-admitted by teacher forcing
    through the same in-place injection, so the buffers its dispatch
    reads (its graph on a card) stay the ones it was built with."""
    _, s = sides
    fd = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
    prompts = [f"restored in place {i}" for i in range(4)]
    ids = [fd.submit(p, max_new_tokens=30, stop_at_eos=False) for p in prompts]
    for _ in range(2):
        fd.step()
    blob = json.dumps(fd.export_state())
    fresh = s.mod.FrontDoorEngine(*s.engines, k=3, max_slots=2)
    fixed = _fixed_storage(fresh)
    fresh.restore_state(json.loads(blob))
    results = fresh.run()
    assert fresh.snapshot_resumes >= 1 and _fixed_storage(fresh) == fixed
    for prompt, rid in zip(prompts, ids):
        assert results[rid] == spec_reference(s, s.engines, prompt, 30)
