"""SLO-aware router over N replicated serving front doors (PyTorch
port of ``tpuslo/models/router.py``; host logic over the port's
:class:`~tpuslo_torch.models.frontdoor.FrontDoorEngine`, unchanged in
behaviour).

ONE front door sustains continuous-batching goodput; this module is the
placement layer on top of it, a fleet of replicated front doors behind
one scored routing policy (replicated serving units under a control
plane, at toolkit scale):

* **Prefix affinity first, bounded by load.**  The router keeps a
  warm-set MIRROR of each engine's prefix cache (groups it has placed
  there), and routes a request whose ``prefix`` is warm somewhere to
  that engine — the engine serves it suffix-only off its KV snapshot.
  The mirror is router-side state: placement must not poll N engines'
  caches per request.  Affinity is BOUNDED: an engine whose queue has
  grown past ``affinity_overflow × max_slots`` no longer counts as
  warm, so a hot prefix group spills onto the least-loaded sibling
  and becomes warm THERE too — replication under pressure (the
  bounded-load consistent-hashing idea).  Without the bound, skewed
  group popularity pins the hottest group's whole tail onto one
  engine while siblings idle.

* **Burn-aware steering.**  A fast-burn tenant's requests are steered
  away from CONTENDED engines (queued work or a full house) — this
  outranks even affinity, or a burning tenant would keep piling onto
  its warm engine's queue against healthy tenants.  They fill idle
  capacity but never add queueing pressure where healthy tenants
  wait.  (The engine's own admission already guarantees a demoted
  tenant cannot displace healthy slots; the router keeps its queueing
  pressure away too.)

* **Power-of-two-choices on load.**  Among engines tied on affinity
  and burn rank, the router samples two and takes the shorter
  ``queue_depth + busy_slots`` — the classical load-balance result
  (exponential improvement over random placement) at O(1) cost,
  instead of scanning N queue depths per request.

* **Rebalancing under failure.**  :meth:`kill_engine` drains the dead
  engine — running slots park (block-granular in paged mode), parks
  materialize to dense portable snapshots — and every live request is
  adopted by a sibling chosen warm-first: parked streams re-inject
  bit-identically, teacher-forced streams continue identically, and
  the dead engine's warm prefix groups are re-homed round-robin so
  each group's traffic converges on ONE sibling immediately (its
  first post-kill request warms the new home's cache on arrival).
  Zero requests are lost; the tests hold stream parity against an
  uninterrupted reference.

Global request ids are router-scope; each engine keeps its own local
ids.  ``route``/``_score_engine`` run once per request at arrival rate:
they stay O(1) host work and never touch the device.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass
from typing import Any

from tpuslo_torch.models.frontdoor import FrontDoorEngine, FrontDoorRequest

#: Per-engine warm-set mirror capacity — matches the order of the
#: engines' own bounded prefix caches; LRU-ish FIFO beyond it.
WARM_MIRROR_CAP = 128

#: Placement decisions kept for triage (the serving-scaleout runbook
#: reads these to explain an affinity miss).
DECISION_LOG_CAP = 256


@dataclass(slots=True)
class RouterDecision:
    """One placement record (slotted: written once per request on the
    arrival path, read only by triage tooling)."""

    global_id: int
    tenant: str
    engine: int
    warm_hit: bool
    burning: bool
    load: int
    shed_reason: str | None


class SLORouter:
    """Scored placement over replicated front doors.

    ``engines`` must be replicated — same target/draft configs — or
    drained KV snapshots could not re-inject on siblings.
    ``burn_engine`` is the same duck-typed surface the engines consult
    (``tenant_burn_state``); the router only reads fast-burn state.
    ``policy`` is ``"slo"`` (affinity + burn + p2c load) or
    ``"random"`` (uniform placement — the bench's control arm).
    """

    def __init__(
        self,
        engines: list[FrontDoorEngine],
        burn_engine=None,
        policy: str = "slo",
        seed: int = 0,
        affinity_overflow: float = 1.0,
    ):
        if not engines:
            raise ValueError("need at least one engine")
        if policy not in ("slo", "random"):
            raise ValueError(f"unknown policy: {policy!r}")
        self._engines: list[FrontDoorEngine | None] = list(engines)
        self._burn = burn_engine
        self.policy = policy
        self._rng = random.Random(seed)
        # Queue depth (in units of engine max_slots) past which a warm
        # engine stops attracting its groups' traffic (see module
        # docstring: bounded-load affinity).
        self.affinity_overflow = affinity_overflow
        # Router-side warm mirror: per-engine insertion-ordered dict
        # used as a bounded set of prefix strings placed there.
        self._warm: list[dict[str, None]] = [
            {} for _ in engines
        ]
        self._next_gid = 0
        #: global id -> (engine index, engine-local request id)
        self._placements: dict[int, tuple[int, int]] = {}
        #: per-engine local id -> global id (shed/result reconciliation)
        self._local: list[dict[int, int]] = [{} for _ in engines]
        #: global id -> shed reason (router-scope refusal record)
        self.shed: dict[int, str] = {}
        self.decisions: deque[RouterDecision] = deque(
            maxlen=DECISION_LOG_CAP
        )
        # Work a dead engine already FINISHED is harvested at kill
        # time — completed streams must survive their engine.
        self._dead_results: dict[int, list[int]] = {}
        self._dead_timings: dict[int, dict[str, float]] = {}
        self.routed = 0
        self.affinity_hits = 0
        self.kills = 0
        self.rebalanced = 0

    # ---- live-fleet helpers ---------------------------------------------

    def live_engines(self) -> list[int]:
        return [
            i for i, e in enumerate(self._engines) if e is not None
        ]

    def engine(self, idx: int) -> FrontDoorEngine:
        eng = self._engines[idx]
        if eng is None:
            raise KeyError(f"engine {idx} is dead")
        return eng

    def _burning(self, tenant: str) -> bool:
        return (
            self._burn is not None
            and self._burn.tenant_burn_state(tenant) == "fast_burn"
        )

    def _load(self, idx: int) -> int:
        eng = self._engines[idx]
        return eng.queue_depth + eng.busy_slots

    def _warm_mark(self, idx: int, prefix: str) -> None:
        warm = self._warm[idx]
        warm.pop(prefix, None)
        warm[prefix] = None
        while len(warm) > WARM_MIRROR_CAP:
            warm.pop(next(iter(warm)))

    # ---- the scored policy ----------------------------------------------

    def _score_engine(
        self, idx: int, prefix: str | None, burning: bool
    ) -> tuple[int, int, int]:
        """Placement score for one engine, lower-is-better lexical:
        (burn rank, affinity rank, load).  Burn rank 1 penalizes a
        CONTENDED engine for a fast-burn tenant — it outranks
        affinity, or a burning tenant would keep piling onto its warm
        engine's queue against healthy tenants (for everyone else it
        is always 0, so affinity leads).  Affinity rank 0 means the
        warm mirror says this engine holds the request's prefix group
        AND its queue is under the overflow bound — past it the warm
        claim is worthless (the snapshot saves a prefill but the
        queue costs many) and the group spills to a sibling; load is
        queue depth + busy slots."""
        eng = self._engines[idx]
        overflow_depth = max(
            1, int(self.affinity_overflow * eng.max_slots)
        )
        warm_rank = (
            0
            if prefix is not None
            and prefix in self._warm[idx]
            and eng.queue_depth < overflow_depth
            else 1
        )
        contended = (
            eng.queue_depth > 0 or eng.busy_slots >= eng.max_slots
        )
        burn_rank = 1 if (burning and contended) else 0
        return (burn_rank, warm_rank, eng.queue_depth + eng.busy_slots)

    def _pick_engine(
        self, prefix: str | None, burning: bool
    ) -> tuple[int, bool]:
        """Choose a live engine; returns (index, warm_hit).

        The (affinity, burn) class picks the candidate set; power-of-
        two-choices breaks load ties inside it — sample two, keep the
        shorter queue, never scan the fleet."""
        live = self.live_engines()
        if not live:
            raise RuntimeError("no live engines to route to")
        if self.policy == "random":
            return self._rng.choice(live), False
        scored = [
            (self._score_engine(i, prefix, burning), i) for i in live
        ]
        best_class = min(score[:2] for score, _ in scored)
        ties = [i for score, i in scored if score[:2] == best_class]
        if len(ties) > 2:
            ties = self._rng.sample(ties, 2)
        pick = min(ties, key=lambda i: (self._load(i), i))
        return pick, best_class[1] == 0

    def route(
        self,
        prompt: str,
        tenant: str = "default",
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        prefix: str | None = None,
    ) -> int | None:
        """Place one request on the fleet; returns its GLOBAL id, or
        ``None`` when the chosen engine sheds it (reason lands in
        :attr:`shed` under the global id — engine-level admission
        still owns the shed decision; the router only places)."""
        burning = self._burning(tenant)
        idx, warm_hit = self._pick_engine(prefix, burning)
        eng = self._engines[idx]
        gid = self._next_gid
        self._next_gid += 1
        lid = eng.submit(
            prompt,
            tenant=tenant,
            max_new_tokens=max_new_tokens,
            stop_at_eos=stop_at_eos,
            prefix=prefix,
        )
        self.routed += 1
        if warm_hit:
            self.affinity_hits += 1
        shed_reason = None
        if lid is None:
            # Local ids are engine-scope and monotonic: the refused
            # request's id is the engine's last-assigned one.
            shed_reason = eng.shed_requests.get(eng._next_id - 1)
            self.shed[gid] = shed_reason or "queue_full"
        else:
            self._placements[gid] = (idx, lid)
            self._local[idx][lid] = gid
            if prefix is not None:
                self._warm_mark(idx, prefix)
        self._reconcile_sheds(idx)
        self.decisions.append(
            RouterDecision(
                global_id=gid,
                tenant=tenant,
                engine=idx,
                warm_hit=warm_hit,
                burning=burning,
                load=self._load(idx),
                shed_reason=shed_reason,
            )
        )
        return None if lid is None else gid

    def _reconcile_sheds(self, idx: int) -> None:
        """Fold engine-side displacement sheds (queued victims evicted
        AFTER placement) back into router-scope records."""
        eng = self._engines[idx]
        if eng is None or not eng.shed_requests:
            return
        local = self._local[idx]
        for lid, reason in eng.shed_requests.items():
            gid = local.pop(lid, None)
            if gid is not None:
                self._placements.pop(gid, None)
                self.shed[gid] = reason

    # ---- fleet stepping --------------------------------------------------

    def step(self) -> bool:
        """One admission+round boundary on every live engine; returns
        True while any engine still holds work."""
        busy = False
        for idx in self.live_engines():
            if self._engines[idx].step():
                busy = True
            self._reconcile_sheds(idx)
        return busy

    def run(self) -> dict[int, list[int]]:
        while self.step():
            pass
        return self.results()

    # ---- rebalancing under failure --------------------------------------

    def _pick_sibling(self, req: FrontDoorRequest) -> int:
        live = self.live_engines()
        if req.prefix is not None:
            for i in live:
                if req.prefix in self._warm[i]:
                    return i
        return min(live, key=lambda i: (self._load(i), i))

    def kill_engine(self, idx: int) -> int:
        """Mid-run engine failure: drain the dead engine's live work
        onto siblings and re-home its warm prefix groups.  Returns the
        number of requests rebalanced; none are lost — parked slots
        re-inject their KV snapshots, in-flight token prefixes
        teacher-force to the identical continuation."""
        eng = self._engines[idx]
        if eng is None:
            return 0
        evacuated = eng.drain()
        self._engines[idx] = None
        dead_local = self._local[idx]
        self._local[idx] = {}
        # Harvest finished work before the engine object goes away:
        # a completed stream must not die with its engine.
        dead_timings = eng.request_timings()
        for lid, gid in dead_local.items():
            if lid in eng.results:
                self._dead_results[gid] = eng.results[lid]
            record = dead_timings.get(lid)
            if record is not None:
                self._dead_timings[gid] = record
        dead_warm = list(self._warm[idx])
        self._warm[idx] = {}
        moved = 0
        for req in evacuated:
            gid = dead_local.pop(req.request_id, None)
            sib = self._pick_sibling(req)
            new_lid = self._engines[sib].adopt(req)
            if gid is not None:
                self._placements[gid] = (sib, new_lid)
                self._local[sib][new_lid] = gid
            if req.prefix is not None:
                self._warm_mark(sib, req.prefix)
            moved += 1
        # Re-home the remaining warm groups round-robin so each
        # group's future traffic converges on ONE sibling at once; the
        # first post-kill request per group warms the new home's cache
        # on arrival (one expected affinity TTFT miss per group — the
        # runbook's triage case).
        live = self.live_engines()
        if live:
            for j, group in enumerate(dead_warm):
                if not any(group in self._warm[i] for i in live):
                    self._warm_mark(live[j % len(live)], group)
        self.kills += 1
        self.rebalanced += moved
        return moved

    # ---- merged result surfaces -----------------------------------------

    def results(self) -> dict[int, list[int]]:
        """Completed token streams keyed by GLOBAL id (including work
        finished on since-killed engines)."""
        out: dict[int, list[int]] = dict(self._dead_results)
        for gid, (idx, lid) in self._placements.items():
            eng = self._engines[idx]
            if eng is not None and lid in eng.results:
                out[gid] = eng.results[lid]
        return out

    def partial_tokens(self, global_id: int) -> list[int] | None:
        if global_id in self.shed:
            return None
        if global_id in self._dead_results:
            return list(self._dead_results[global_id])
        placed = self._placements.get(global_id)
        if placed is None:
            return None
        idx, lid = placed
        eng = self._engines[idx]
        return None if eng is None else eng.partial_tokens(lid)

    def request_timings(self) -> dict[int, dict[str, float]]:
        """Per-completed-request latency SLIs keyed by GLOBAL id."""
        per_engine = [
            eng.request_timings() if eng is not None else {}
            for eng in self._engines
        ]
        out: dict[int, dict[str, float]] = dict(self._dead_timings)
        for gid, (idx, lid) in self._placements.items():
            record = per_engine[idx].get(lid)
            if record is not None:
                out[gid] = record
        return out

    def stats(self) -> dict[str, Any]:
        live = self.live_engines()
        return {
            "engines": len(self._engines),
            "live_engines": len(live),
            "policy": self.policy,
            "routed": self.routed,
            "affinity_hits": self.affinity_hits,
            "affinity_hit_rate": (
                round(self.affinity_hits / self.routed, 4)
                if self.routed
                else 0.0
            ),
            "shed": len(self.shed),
            "kills": self.kills,
            "rebalanced": self.rebalanced,
            "warm_groups": [len(w) for w in self._warm],
            "engine_stats": {
                i: self._engines[i].stats() for i in live
            },
        }
