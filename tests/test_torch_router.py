"""Serving scale-out: ``tpuslo_torch.models.router`` and the paged front
door against the JAX ones.

The scenarios of ``tests/test_router.py`` are written once as functions
of a *side* (one framework's classes and engines) and run on both, on
``llama_tiny`` in f32 on the CPU over the same weights and with the same
router ``seed``.  Streams, per-request engine choices, decisions and
rebalancing counts must be equal; the JAX test's own assertions are then
made on the port's observation.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import frontdoor as jfd  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import router as jr  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import speculative as jsp  # noqa: E402
from tpuslo.sloengine import engine as jslo  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import frontdoor as tfd  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import router as tr  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.models import speculative as tsp  # noqa: E402
from tpuslo_torch.sloengine import engine as tslo  # noqa: E402

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
    """(JAX side, port side); every front door of a side shares the
    side's two ``ServeEngine``s (a self-draft pair), as replicas do."""
    pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), CFG_T, "cpu")
    return (
        SimpleNamespace(
            fd=jfd, router=jr, slo=jslo, SpeculativeEngine=jsp.SpeculativeEngine,
            engines=(js.ServeEngine(cfg=CFG_J, params=pj), js.ServeEngine(cfg=CFG_J, params=pj)),
        ),
        SimpleNamespace(
            fd=tfd, router=tr, slo=tslo, SpeculativeEngine=tsp.SpeculativeEngine,
            engines=(ts.ServeEngine(cfg=CFG_T, params=pt, device="cpu"),
                     ts.ServeEngine(cfg=CFG_T, params=pt, device="cpu")),
        ),
    )


def both(sides, scenario):
    want, got = scenario(sides[0]), scenario(sides[1])
    assert got == want
    return got


def spec_reference(s, prompt, n, stop_at_eos=False, prefix=None):
    spec = s.SpeculativeEngine(s.engines[0], s.engines[1], k=3)
    return spec.generate(prompt, max_new_tokens=n, stop_at_eos=stop_at_eos, prefix=prefix)


def make_frontdoor(s, paged=False, **kw):
    kw.setdefault("k", 3)
    kw.setdefault("max_slots", 2)
    kw.setdefault("rounds_per_step", 1)
    return s.fd.FrontDoorEngine(*s.engines, paged=paged, block_size=32, **kw)


def make_fleet(s, n, paged=True, **kw):
    return [make_frontdoor(s, paged=paged, **kw) for _ in range(n)]


def observe(router) -> dict:
    """A router's outcome as plain data."""
    return {
        "results": {gid: list(t) for gid, t in router.results().items()},
        "placements": dict(router._placements),
        "decisions": [dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d
                      for d in router.decisions],
        "shed": dict(router.shed),
        "routed": router.routed,
        "affinity_hits": router.affinity_hits,
        "kills": router.kills,
        "rebalanced": router.rebalanced,
        "warm": [sorted(w) for w in router._warm],
        "live": router.live_engines(),
    }


# ---- paged-vs-dense parity ----------------------------------------------


class TestPagedParity:
    def test_paged_streams_match_dense(self, sides):
        def scenario(s):
            prompts = [f"paged parity {i}" for i in range(6)]
            outs = []
            for paged in (False, True):
                fd = make_frontdoor(s, paged=paged)
                ids = [fd.submit(p, max_new_tokens=10, stop_at_eos=False) for p in prompts]
                results = fd.run()
                outs.append([results[rid] for rid in ids])
            assert outs[0] == outs[1]
            return outs[1]

        both(sides, scenario)

    def test_paged_warm_prefix_admission(self, sides):
        def scenario(s):
            prefix = "[system] paged prefix parity."
            fd = make_frontdoor(s, paged=True)
            prompts = [f" q{i}?" for i in range(4)]
            ids = [fd.submit(p, max_new_tokens=8, stop_at_eos=False, prefix=prefix)
                   for p in prompts]
            results = fd.run()
            for prompt, rid in zip(prompts, ids):
                assert results[rid] == spec_reference(s, prompt, 8, prefix=prefix)
            return [results[rid] for rid in ids]

        both(sides, scenario)

    def test_pool_exhaustion_falls_back_to_dense_park(self, sides):
        """A park pool too small for even one bucket must not fail the
        preemption: it falls back to the full-row snapshot."""
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = s.fd.FrontDoorEngine(*s.engines, k=3, max_slots=2, rounds_per_step=1,
                                      paged=True, block_size=32, pool_blocks=1,
                                      burn_engine=burn)
            lo = fd.submit("fallback stream one two three", tenant="lowly",
                           max_new_tokens=24, stop_at_eos=False)
            fd.submit("second low", tenant="lowly", max_new_tokens=24, stop_at_eos=False)
            for _ in range(2):
                fd.step()
            fd.submit("vip arrival", tenant="vip", max_new_tokens=8, stop_at_eos=False)
            results = fd.run()
            assert results[lo] == spec_reference(s, "fallback stream one two three", 24)
            return (fd.paged_fallback_parks, fd.paged_parks, fd.preemptions, fd.resumes,
                    {rid: list(t) for rid, t in results.items()})

        assert both(sides, scenario)[0] >= 1

    def test_drained_paged_park_materializes_to_a_dense_row(self, sides):
        """drain() turns a block-granular park into the dense snapshot a
        sibling installs; the stream finishes as the reference would."""
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fd = make_frontdoor(s, paged=True, max_slots=1, burn_engine=burn)
            fd.submit("parked then drained", tenant="lowly", max_new_tokens=20,
                      stop_at_eos=False)
            fd.step()
            fd.submit("vip takes over", tenant="vip", max_new_tokens=20, stop_at_eos=False)
            fd.step()  # parks the low stream block-granular
            assert fd.paged_parks == 1
            evacuated = fd.drain()
            assert all(isinstance(r.parked, tuple) for r in evacuated)
            stats = fd.stats()["paged"]
            assert stats["free_blocks"] == stats["pool_blocks"] - 1
            sibling = make_frontdoor(s, paged=True, max_slots=2)
            ids = {r.prompt: sibling.adopt(r) for r in evacuated}
            results = sibling.run()
            for prompt, rid in ids.items():
                assert results[rid] == spec_reference(s, prompt, 20)
            return sorted(ids), sibling.resumes

        assert both(sides, scenario)[1] == 2


# ---- routing policy ----------------------------------------------------


class TestRoutingPolicy:
    def test_affinity_routes_group_to_one_engine(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            homes = set()
            for i in range(6):
                gid = router.route(f" q{i}", max_new_tokens=4, prefix="grp-00/sys")
                homes.add(router._placements[gid][0])
                router.run()  # drain: queues stay under the overflow bound
            return {**observe(router), "homes": sorted(homes)}

        got = both(sides, scenario)
        assert len(got["homes"]) == 1  # one warm home, all requests follow it
        assert got["affinity_hits"] == 5  # all but the cold fill

    def test_hot_group_spills_past_overflow_bound(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            gids = [router.route(f" hot{i}", max_new_tokens=4, prefix="grp-00/sys")
                    for i in range(6)]  # no stepping: queues only grow
            homes = {router._placements[g][0] for g in gids}
            warm_on = [i for i in router.live_engines() if "grp-00/sys" in router._warm[i]]
            router.run()
            return {**observe(router), "homes": sorted(homes), "warm_on": warm_on}

        got = both(sides, scenario)
        assert len(got["homes"]) > 1  # the overloaded home stopped attracting
        assert len(got["warm_on"]) == len(got["homes"])  # spillover 2-homed the group

    def test_distinct_groups_spread_by_load(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            for g in range(3):
                for i in range(2):
                    router.route(f" q{g}-{i}", max_new_tokens=4, prefix=f"grp-{g:02d}/sys")
            router.run()
            return observe(router)

        got = both(sides, scenario)
        assert sum(d["warm_hit"] for d in got["decisions"]) == 3
        assert len({d["engine"] for d in got["decisions"] if not d["warm_hit"]}) > 1

    def test_random_policy_never_counts_affinity(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 3), policy="random", seed=3)
            for i in range(6):
                router.route(f" q{i}", max_new_tokens=4, prefix="grp-00/sys")
            router.run()
            return observe(router)

        assert both(sides, scenario)["affinity_hits"] == 0

    def test_fleet_streams_match_single_engine(self, sides):
        def scenario(s):
            prompts = [f"fleet parity {i}" for i in range(8)]
            single = make_frontdoor(s)
            ref_ids = [single.submit(p, max_new_tokens=8, stop_at_eos=False) for p in prompts]
            ref = single.run()
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            gids = [router.route(p, max_new_tokens=8, stop_at_eos=False) for p in prompts]
            out = router.run()
            for rid, gid in zip(ref_ids, gids):
                assert out[gid] == ref[rid]
            return observe(router)

        both(sides, scenario)

    def test_burning_tenant_steers_off_contended_engine(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            router = s.router.SLORouter(make_fleet(s, 2, max_slots=1), burn_engine=burn, seed=0)
            # Occupy the warm home's only slot (contended: a full house
            # with an empty queue, so affinity still holds for healthy
            # tenants: burn steering, not overflow, must do the work).
            router.route("occupy one", max_new_tokens=16, stop_at_eos=False, prefix="hot/sys")
            contended = router._placements[0][0]
            router.step()

            class FakeBurn:
                def tenant_burn_state(self, tenant):
                    return "fast_burn" if tenant == "burny" else "ok"

            router._burn = FakeBurn()
            gid = router.route("burning request", tenant="burny", max_new_tokens=4,
                               prefix="hot/sys")
            burning_home = router._placements[gid][0]
            router._burn = None
            ok = router.route("healthy request", max_new_tokens=4, prefix="hot/sys")
            healthy_home = router._placements[ok][0]
            router.run()
            return {**observe(router), "contended": contended, "burning_home": burning_home,
                    "healthy_home": healthy_home}

        got = both(sides, scenario)
        assert got["burning_home"] != got["contended"]  # burn steering overrides affinity
        assert got["healthy_home"] == got["contended"]  # a healthy tenant follows it

    def test_shed_reconciliation_surfaces_global_ids(self, sides):
        def scenario(s):
            router = s.router.SLORouter([make_frontdoor(s, max_slots=1, max_queue=1)], seed=0)
            kept = router.route("first", max_new_tokens=12, stop_at_eos=False)
            router.step()  # first occupies the slot
            router.route("second", max_new_tokens=4)  # fills the queue
            refused = router.route("third", max_new_tokens=4)
            router.run()
            return {**observe(router), "kept": kept, "refused": refused,
                    "partial": router.partial_tokens(2)}

        got = both(sides, scenario)
        assert got["refused"] is None and got["partial"] is None
        assert got["shed"] == {2: "queue_full"}  # a global-scope shed record
        assert got["kept"] in got["results"]

    def test_displacement_shed_is_reconciled_to_its_global_id(self, sides):
        def scenario(s):
            burn = s.slo.BurnEngine()
            burn.demote_tenant("lowly")
            fleet = [make_frontdoor(s, max_slots=1, max_queue=1, burn_engine=burn)]
            router = s.router.SLORouter(fleet, burn_engine=burn, seed=0)
            router.route("first", max_new_tokens=12, stop_at_eos=False)
            router.step()
            low = router.route("queued low", tenant="lowly", max_new_tokens=4)
            vip = router.route("displaces it", tenant="vip", max_new_tokens=4)
            router.run()
            return {**observe(router), "low": low, "vip": vip}

        got = both(sides, scenario)
        assert got["shed"] == {got["low"]: "displaced"}
        assert got["vip"] in got["results"] and got["low"] not in got["results"]

    def test_decision_log_bounded_and_typed(self, sides):
        _, s = sides
        router = s.router.SLORouter(make_fleet(s, 2), seed=0)
        router.route("decided", max_new_tokens=2)
        dec = router.decisions[-1]
        assert isinstance(dec, s.router.RouterDecision)
        assert dec.engine in (0, 1)
        assert s.router.RouterDecision.__slots__  # the arrival-path record stays slotted
        assert router.decisions.maxlen == tr.DECISION_LOG_CAP == jr.DECISION_LOG_CAP
        assert tr.WARM_MIRROR_CAP == jr.WARM_MIRROR_CAP
        router.run()

    def test_bad_arguments_rejected(self, sides):
        _, s = sides
        with pytest.raises(ValueError, match="at least one engine"):
            s.router.SLORouter([])
        with pytest.raises(ValueError, match="unknown policy"):
            s.router.SLORouter(make_fleet(s, 1), policy="sticky")

    def test_stats_and_timings_equal_in_shape(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 2), seed=0)
            gids = [router.route(f"timed {i}", max_new_tokens=4, stop_at_eos=False)
                    for i in range(3)]
            router.run()
            stats = router.stats()
            timings = router.request_timings()
            return (sorted(stats), {k: stats[k] for k in (
                "engines", "live_engines", "policy", "routed", "affinity_hits",
                "affinity_hit_rate", "shed", "kills", "rebalanced", "warm_groups")},
                sorted(timings) == sorted(gids), sorted(timings[gids[0]]))

        assert both(sides, scenario)[2]


# ---- rebalancing under failure -----------------------------------------


class TestEngineKill:
    def test_kill_loses_zero_requests_and_keeps_parity(self, sides):
        """Mixed plain + prefixed traffic across a kill: every stream
        matches the uninterrupted single-engine reference."""
        def scenario(s):
            specs = [(f"kill parity {i}", f"grp-{i % 2:02d}/sys" if i % 3 else None)
                     for i in range(9)]
            single = make_frontdoor(s)
            ref_ids = [single.submit(p, max_new_tokens=10, stop_at_eos=False, prefix=g)
                       for p, g in specs]
            ref = single.run()
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            gids = [router.route(p, max_new_tokens=10, stop_at_eos=False, prefix=g)
                    for p, g in specs]
            for _ in range(2):
                router.step()
            victim = router.live_engines()[0]
            moved = router.kill_engine(victim)
            assert victim not in router.live_engines()
            out = router.run()
            assert len(out) == len(specs)  # zero lost across the kill
            for rid, gid in zip(ref_ids, gids):
                assert out[gid] == ref[rid]
            return {**observe(router), "moved": moved}

        got = both(sides, scenario)
        assert got["rebalanced"] == got["moved"] >= 1

    def test_kill_mid_run_stream_parity_no_prefix(self, sides):
        def scenario(s):
            prompts = [f"kill stream {i}" for i in range(8)]
            router = s.router.SLORouter(make_fleet(s, 3), seed=1)
            gids = {router.route(p, max_new_tokens=16, stop_at_eos=False): p for p in prompts}
            for _ in range(2):
                router.step()
            moved = router.kill_engine(1)
            out = router.run()
            assert len(out) == len(prompts)
            for gid, p in gids.items():
                assert out[gid] == spec_reference(s, p, 16), p
            return {**observe(router), "moved": moved}

        assert both(sides, scenario)["moved"] >= 1  # the kill rebalanced live work

    def test_kill_rehomes_warm_groups(self, sides):
        def scenario(s):
            router = s.router.SLORouter(make_fleet(s, 3), seed=0)
            router.route("warm it", max_new_tokens=2, prefix="grp-07/sys")
            home = router._placements[0][0]
            router.run()
            router.kill_engine(home)
            rehomed = [i for i in router.live_engines() if "grp-07/sys" in router._warm[i]]
            gid = router.route("after kill", max_new_tokens=2, prefix="grp-07/sys")
            placed = router._placements[gid][0]
            router.run()
            return {**observe(router), "home": home, "rehomed": rehomed, "placed": placed}

        got = both(sides, scenario)
        assert got["rehomed"] and got["home"] not in got["rehomed"]
        assert got["placed"] in got["live"]
        assert 0 in got["results"]  # the dead engine's finished stream was harvested

    def test_kill_last_engine_refuses_routing(self, sides):
        _, s = sides
        router = s.router.SLORouter(make_fleet(s, 1), seed=0)
        assert router.kill_engine(0) == 0
        assert router.kill_engine(0) == 0  # already dead: nothing to drain
        with pytest.raises(RuntimeError):
            router.route("nowhere to go", max_new_tokens=2)
        with pytest.raises(KeyError):
            router.engine(0)
