"""One serving front door: batched speculative decoding inside
continuous-batching slots, with SLO-aware admission (PyTorch port of
``tpuslo/models/frontdoor.py``).

* **Batched spec rounds across slots.**  The engine owns a fixed pool
  of ``max_slots`` KV rows on BOTH a target and a draft model and
  steps every occupied slot through ``rounds_per_step`` chained
  speculative rounds per iteration
  (:func:`tpuslo_torch.models.speculative._shared_spec_multi_round_fn`),
  with per-slot acceptance frontiers and an active mask.  Slots
  inject/retire only at round boundaries, so shapes never change: the
  rounds' kernels in, one packed ``(drafts, preds, accepted)`` read
  out.  Per-slot output is identical to the target-only greedy stream.

* **SLO-aware admission.**  The scheduler consults the toolkit's OWN
  :class:`~tpuslo_torch.sloengine.engine.BurnEngine` live: a tenant's
  effective priority is its remediation-surface ``admission_priority``
  (``demote_tenant`` lands HERE, in the serving loop), further demoted
  while the tenant's budget is in ``fast_burn``.  Under queue pressure
  low-priority requests shed (counted by reason) and running
  low-priority slots are PREEMPTED: the slot's KV rows are parked as
  copies and later re-injected, resuming the stream bit-identically.
  Completed requests feed their outcomes back into the burn engine.

* **Prefix-cache-aware placement.**  Queue order breaks priority ties
  toward requests whose shared prefix already has a KV snapshot on
  both engines, so same-prefix requests reuse the snapshot
  (suffix-only prefill).

* **Paged parks.**  With ``paged=True`` the engine attaches side pools
  from the paged-KV plane and preemption parks only the pow2 bucket of
  aligned blocks the slot's frontier touched
  (:func:`tpuslo_torch.models.paged_kv.park_slot_blocks`) instead of a
  full ``max_seq_len`` row.  Decode is untouched: the same dense round,
  so paged and dense front doors emit identical greedy token streams.
  A drained engine materializes its paged parks back into dense rows
  (``gather_parked_row``) so siblings under an
  :class:`~tpuslo_torch.models.router.SLORouter` can adopt them.

Crash-safety: :meth:`FrontDoorEngine.export_state` /
``restore_state`` give a JSON-safe snapshot.  KV does not ride it;
in-flight requests are persisted as their emitted-token prefix and
resume by teacher-forcing ``prompt + emitted[:-1]`` back through
prefill; greedy decoding makes the continuation identical to the
uninterrupted stream.

What differs from the JAX engine: there is no jit.  On a card the
engine's dispatch is one CUDA graph, captured when the engine is built
(:class:`tpuslo_torch.models.graphs.GraphedDispatch`), so the
capture stays out of a bench's timer as XLA's compile does; each
``step()`` replays it.  Each admission prefill is a graph replay too:
the first front door over a pair of engines captures their
:class:`~tpuslo_torch.models.serve.AdmissionGraphs` (a cold prefill per
batch and prefill bucket, a suffix chunk per bucket), which later front
doors over the same engines replay; ``admission_captures`` and
``admission_capture_ms`` say what this one captured, ``eager_admissions``
counts the chunks no graph fits (a remainder at the cache end).  The
admitted rows come back in the engines' staged storage and are injected
into the pools at once.  The graph reads and writes buffers whose storage
never changes over the engine's life: the two slot pools (admission,
parks and resumes copy rows in and out of them in place), the current
tokens, the frontiers and the mask (refilled from pinned host memory:
no synchronizing call) and the packed output, which the step's one read
takes through :class:`tpuslo_torch.models.serve._HostRead`.  The
admissions of one fill hold their first tokens on the device and read
them all at once (JAX reads each admission's): the fill reads before a
decision the free slots decide, so every admission, shed and preemption
is JAX's, and only the slot a request takes after an EOS first token may
differ.  On the CPU
the same buffers are used and the dispatch runs eagerly.  The memoized
``_SHARED_*`` splice programs and the retrace audit of JAX have no
counterpart; a parked row is a clone and never a view of the pool.  The
dispatch ledger's ``dispatch`` share is the host's time to stage and
launch the dispatch and its ``device wait`` share what the device still
owed after that.  Over a tp target (JAX's front door over its tp
engine) every rank runs the same front door over its target shards, a
replica of an unsharded draft and pools of its ``n_kv_heads / tp`` heads;
admissions, sheds and preemptions decide from gathered tokens and host
state alone, so every rank makes the same ones.  On the card the one-rank
NCCL all_reduce is captured in the dispatch's and the admissions' CUDA
graphs; a mesh whose collectives go through host memory (gloo with CUDA
tensors) is refused.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpuslo_torch.deviceplane.dispatch import DispatchLedger
from tpuslo_torch.models.batching import _extract_row, _inject_row, _inject_rows
from tpuslo_torch.models.llama import init_kv_cache
from tpuslo_torch.models.paged_kv import (
    PagedBatchingEngine,
    gather_parked_row,
    init_paged_pool,
    park_slot_blocks,
    resume_slot_blocks,
)
from tpuslo_torch.models.serve import (
    BOS,
    EOS,
    ServeEngine,
    _bucket,
    _HostRead,
    _upload,
)
from tpuslo_torch.models.graphs import GraphedDispatch, StagedInput
from tpuslo_torch.models.speculative import (
    _check_pair,
    _rehome_draft_cache,
    _shared_spec_multi_round_fn,
    joint_prompt_ids,
    pack_round,
    unpack_round,
    zero_cache,
)
from tpuslo_torch.obs.tracer import _NULL_CYCLE

# The ONE admission-priority scale: the sloengine remediation surface
# owns it (demote_tenant writes these values), the front door only
# reads it: a local mirror would silently desync the fast-burn clamp
# and the shed-reason classification from the remediation engine.
from tpuslo_torch.sloengine.engine import (
    DEFAULT_ADMISSION_PRIORITY as DEFAULT_PRIORITY,
    DEMOTED_ADMISSION_PRIORITY as DEMOTED_PRIORITY,
)
from tpuslo_torch.sloengine.stream import RequestOutcome

Cache = dict[str, Any]

#: Shed reasons (the precision evidence satellite tests count by):
SHED_QUEUE_FULL = "queue_full"  # queue at capacity, arrival not better
SHED_DISPLACED = "displaced"  # queued low-priority evicted for arrival
SHED_BURNING = "queue_full_burning"  # arrival's tenant burning, queue full
SHED_REASONS = (SHED_QUEUE_FULL, SHED_DISPLACED, SHED_BURNING)

STATE_VERSION = 1


@dataclass(slots=True)
class FrontDoorRequest:
    """One request's lifecycle through the front door (slotted: queue
    scans and per-round emission touch these records on the hot path)."""

    request_id: int
    tenant: str
    prompt: str
    max_new_tokens: int
    stop_at_eos: bool
    prefix: str | None
    submitted_s: float
    tokens: list[int] = field(default_factory=list)
    admitted_s: float | None = None
    first_token_s: float | None = None
    completed_s: float | None = None
    preemptions: int = 0
    resumed_from_snapshot: bool = False
    #: Parked KV snapshot: (row_t, row_d, current_token, frontier).
    parked: tuple | None = None

    def persistable(self) -> dict[str, Any]:
        """JSON-safe form for the runtime snapshot (KV never rides)."""
        return {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "prompt": self.prompt,
            "max_new_tokens": self.max_new_tokens,
            "stop_at_eos": self.stop_at_eos,
            "prefix": self.prefix,
            "tokens": [int(t) for t in self.tokens],
            "preemptions": self.preemptions,
        }

    @classmethod
    def from_persisted(cls, raw: dict[str, Any]) -> "FrontDoorRequest":
        req = cls(
            request_id=int(raw["request_id"]),
            tenant=str(raw.get("tenant", "default")),
            prompt=str(raw.get("prompt", "")),
            max_new_tokens=int(raw.get("max_new_tokens", 1)),
            stop_at_eos=bool(raw.get("stop_at_eos", True)),
            prefix=raw.get("prefix") or None,
            submitted_s=time.perf_counter(),
            tokens=[int(t) for t in raw.get("tokens", [])],
            preemptions=int(raw.get("preemptions", 0)),
        )
        req.resumed_from_snapshot = bool(req.tokens)
        return req


@dataclass(slots=True)
class _PagedParked:
    """Block-granular park record: which physical side-pool blocks
    hold a preempted slot's KV (same indices in the target and draft
    pools), plus the host frontier state a resume re-installs.
    Slotted: parks/resumes happen inside the serving loop."""

    phys: tuple[int, ...]
    current: int
    frontier: int


@dataclass(slots=True)
class _FirstToken:
    """An admission whose first token is still on the device: its slot
    (None where the request ends on that token whatever it is), the
    token (one element), the admission's start time and the slot's
    frontier once the token is read."""

    slot: int | None
    req: FrontDoorRequest
    token: torch.Tensor
    now_s: float
    start: int


class FrontDoorObserver:
    """No-op observer; the bench/agent bridge these to metrics."""

    def admitted(self, tenant: str) -> None: ...

    def shed(self, tenant: str, reason: str) -> None: ...

    def preempted(self, tenant: str) -> None: ...

    def resumed(self, tenant: str) -> None: ...

    def completed(self, tenant: str, tokens: int) -> None: ...


class FrontDoorEngine:
    """SLO-aware continuous batching over batched speculative rounds.

    ``target``/``draft`` follow the :class:`SpeculativeEngine`
    contract (shared byte tokenizer; draft much cheaper for real
    speedup, any pair correct).  ``burn_engine`` is duck-typed
    (``admission_priority``/``tenant_burn_state``/``record``); without
    one every tenant serves at the default priority and no outcomes
    are recorded.  The engine serves on its ``ServeEngine``s' device
    (theirs defaults to the card).
    """

    def __init__(
        self,
        target: ServeEngine,
        draft: ServeEngine,
        k: int = 4,
        max_slots: int = 4,
        max_queue: int = 256,
        rounds_per_step: int = 2,
        burn_engine=None,
        observer: FrontDoorObserver | None = None,
        self_tracer=None,
        paged: bool = False,
        block_size: int = 32,
        pool_blocks: int | None = None,
        clock=None,
    ):
        if k < 1:
            raise ValueError("k must be >= 1")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if rounds_per_step < 1:
            raise ValueError("rounds_per_step must be >= 1")
        _check_pair(target, draft)
        self.target = target
        self.draft = draft
        self.device = target.device
        self.k = k
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.rounds_per_step = rounds_per_step
        self._burn = burn_engine
        self._observer = observer or FrontDoorObserver()
        # Self-observability: when a tracer is passed (duck-typed:
        # ``cycle(name, **attrs)``), every step() emits a root span with
        # admit/dispatch/read/retire children.  The per-dispatch ledger
        # runs either way: 3 perf_counter reads per step.
        self._tracer = self_tracer
        self.dispatch_ledger = DispatchLedger()
        # ONE memoized multi-round function per (cfg_t, cfg_d, k,
        # rounds): rounds_per_step chains that many spec rounds
        # device-side per dispatch, so the host's packed read amortizes
        # over rounds*(k+1) tokens per slot.
        self._round = _shared_spec_multi_round_fn(
            target.cfg, draft.cfg, k, rounds_per_step
        )
        # Admission-batch buckets: lockstep prefill + one multi-row
        # inject per (bucket, prompt-chunk shape), the same power-of-two
        # discipline as everything else.
        buckets: list[int] = []
        b = 1
        while b < max_slots:
            buckets.append(b)
            b <<= 1
        buckets.append(max_slots)
        self._admit_buckets = tuple(buckets)
        # Every dispatch writes KV for up to rounds*(k+1) tokens past
        # the frontier; beyond this limit a row must already be done
        # (admission clamps budgets so it always is).
        self._joint_seq = min(
            target.cfg.max_seq_len, draft.cfg.max_seq_len
        )
        self._limit = self._joint_seq - rounds_per_step * (k + 1)
        self._cache_t = self._init_pool(target)
        self._cache_d = _rehome_draft_cache(
            target, draft, self._init_pool(draft)
        )
        self._tokens = torch.full(
            (max_slots,), BOS, dtype=torch.long, device=self.device
        )
        self._start_in = StagedInput((max_slots,), torch.long, self.device)
        self._active_in = StagedInput((max_slots,), torch.bool, self.device)
        # Host mirrors of the device-side frontiers/current tokens —
        # maintained from values the emission loop already reads, so
        # parking a slot needs no extra device sync.
        self._start = np.ones(max_slots, np.int64)
        self._current = np.full(max_slots, BOS, np.int64)
        self._slots: list[FrontDoorRequest | None] = [None] * max_slots
        # Admissions of the running fill whose first token is not read.
        self._firsts: list[_FirstToken] = []
        self._queue: list[FrontDoorRequest] = []
        self._next_id = 0
        # Injectable monotonic clock: every request timestamp the
        # engine writes comes from ONE callable, so a scale-out bench
        # can drive N replicated engines on per-engine VIRTUAL clocks
        # (discrete-event time) while production keeps perf_counter.
        # The dispatch ledger stays on real perf_counter_ns — device
        # wait is a physical measurement, never simulated.
        self._clock = clock if clock is not None else time.perf_counter
        # Wall-clock anchor for burn-engine outcome timestamps: the hot
        # path never reads the wall clock; event time derives from
        # monotonic deltas against this init-time anchor.
        self._epoch_ns = time.time_ns()
        self._epoch_pc = self._clock()

        # Paged slot mode: preemption parks only the pow2
        # bucket of KV blocks the slot's frontier has touched into
        # per-config side pools, instead of full (max_seq_len) rows.
        # Decode itself stays on the dense round (identical token
        # streams); only the park/resume copies change cost class.
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self.paged_parks = 0
        self.paged_resumes = 0
        self.paged_fallback_parks = 0
        if self.paged:
            PagedBatchingEngine.validate_block_geometry(
                target.cfg, self.block_size
            )
            PagedBatchingEngine.validate_block_geometry(
                draft.cfg, self.block_size
            )
            if pool_blocks is None:
                # Default: room to park two full houses of joint-depth
                # rows, plus the reserved null block 0.
                pool_blocks = 1 + 2 * max_slots * (
                    self._joint_seq // self.block_size
                )
            self._pool_blocks = int(pool_blocks)
            self._paged_pool_t = init_paged_pool(
                target.cfg, self._pool_blocks, self.block_size, 1,
                kv_dtype=target.kv_dtype, device=self.device, tp=target.tp,
            )
            self._paged_pool_d = init_paged_pool(
                draft.cfg, self._pool_blocks, self.block_size, 1,
                kv_dtype=draft.kv_dtype, device=self.device, tp=draft.tp,
            )
            # One host free list indexes BOTH pools (a park takes the
            # same physical ids in each); block 0 is the null block.
            self._free_blocks: list[int] = list(
                range(1, self._pool_blocks)
            )
        else:
            self._pool_blocks = 0
            self._paged_pool_t = None
            self._paged_pool_d = None
            self._free_blocks = []

        self.rounds = 0
        self.slot_rounds = 0
        self.accepted_draft_tokens = 0
        self.emitted_tokens = 0
        self.preemptions = 0
        self.resumes = 0
        self.snapshot_resumes = 0
        self.shed_by_reason: dict[str, int] = {r: 0 for r in SHED_REASONS}
        #: request id -> shed reason (the caller-visible refusal record)
        self.shed_requests: dict[int, str] = {}
        #: finished request id -> emitted token ids
        self.results: dict[int, list[int]] = {}
        self._finished: dict[int, FrontDoorRequest] = {}

        # The dispatch, captured now on a card (its warm-up runs every
        # lane inactive; the pools, tokens and lengths are then put back
        # to their initial state).
        self._dispatch = GraphedDispatch(
            self._dispatch_body, "spec_multi_round",
            (self._tokens, k, rounds_per_step), self.device,
            f"spec_multi_round:{max_slots}x{rounds_per_step}", owner=self,
            pool=(torch.cuda.graph_pool_handle()
                  if self.device.type == "cuda" else None),
            compile_events=target.compile_events,
        )
        if self._dispatch.graph is not None:
            for pool in (self._cache_t, self._cache_d):
                zero_cache(pool)
                pool["length"].fill_(1)
            self._tokens.fill_(BOS)
        # The admissions' prefill pieces on each engine (on a card CUDA
        # graphs, captured by the first front door over the engine and
        # kept there, so that a later one captures nothing).
        held = (target._admission, draft._admission)
        self._adm_t = target.admission_graphs(self._admit_buckets)
        self._adm_d = draft.admission_graphs(self._admit_buckets)
        self._adms = tuple({id(a): a for a in (self._adm_t, self._adm_d)}.values())
        built = [a for a in self._adms if not any(a is h for h in held)]
        #: Admission graphs this front door captured, and their ms.
        self.admission_captures = sum(a.captures for a in built)
        self.admission_capture_ms = sum(a.capture_ms for a in built)
        #: Admission chunks that ran eagerly: no prefill bucket fits them.
        self.eager_admissions = 0

    # ---- construction helpers -----------------------------------------

    def _init_pool(self, engine: ServeEngine) -> Cache:
        pool = init_kv_cache(
            engine.cfg, self.max_slots, kv_dtype=engine.kv_dtype,
            device=self.device, tp=engine.tp,
        )
        # Free lanes idle at frontier 1 (attention over one zero-KV
        # position is well-defined; frontier 0 would be the only
        # frontier the rounds never see elsewhere).
        pool["length"] = torch.ones(
            (self.max_slots,), dtype=torch.long, device=self.device
        )
        return pool

    def _dispatch_body(self) -> torch.Tensor:
        """The step's dispatch over the engine's fixed buffers: the chained
        rounds, their carries written back in place, the packed output."""
        draft_toks, preds, accepted, current, cache_t, cache_d = self._round(
            self.target.params, self.draft.params,
            self._tokens, self._cache_t, self._cache_d,
            self._start_in.tensor, self._active_in.tensor,
        )
        self._tokens.copy_(current)
        self._cache_t["length"].copy_(cache_t["length"])
        self._cache_d["length"].copy_(cache_d["length"])
        return pack_round(draft_toks, preds, accepted)

    def _now_ns(self) -> int:
        return self._epoch_ns + int(
            (self._clock() - self._epoch_pc) * 1e9
        )

    @property
    def acceptance_rate(self) -> float:
        proposed = self.slot_rounds * self.k
        return self.accepted_draft_tokens / proposed if proposed else 0.0

    @property
    def queue_depth(self) -> int:
        """Waiting requests — the router's load signal (O(1) host)."""
        return len(self._queue)

    @property
    def busy_slots(self) -> int:
        """Occupied decode slots — the router's occupancy signal."""
        return sum(1 for s in self._slots if s is not None)

    # ---- admission policy ---------------------------------------------

    def effective_priority(self, tenant: str) -> int:
        """Live per-tenant priority: the remediation surface's
        ``admission_priority`` (demote_tenant lands here), further
        demoted while the tenant's budget is in fast burn."""
        if self._burn is None:
            return DEFAULT_PRIORITY
        priority = int(self._burn.admission_priority(tenant))
        if self._burn.tenant_burn_state(tenant) == "fast_burn":
            priority = min(priority, DEMOTED_PRIORITY)
        return priority

    def _prefix_warm(self, prefix: str | None) -> bool:
        return bool(prefix) and (
            self.target.prefix_warm(prefix)
            and self.draft.prefix_warm(prefix)
        )

    def _order_key(self, req: FrontDoorRequest):
        """Queue order: priority first (live — a mid-run demotion
        reorders the queue), then prefix-cache-aware placement (warm
        prefixes batch together onto snapshot-reusing slots), then
        arrival order."""
        return (
            -self.effective_priority(req.tenant),
            0 if self._prefix_warm(req.prefix) else 1,
            req.request_id,
        )

    def submit(
        self,
        prompt: str,
        tenant: str = "default",
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        prefix: str | None = None,
    ) -> int | None:
        """Enqueue a request; returns its id, or ``None`` when shed.

        Shedding is by live priority: a full queue refuses the arrival
        (``queue_full``; ``queue_full_burning`` when its tenant is
        demoted/burning — the burn engine's budget math throttles its
        own traffic) unless a strictly lower-priority queued request
        can be displaced instead (``displaced``).  Every shed is
        recorded as a failed outcome against the shed tenant's budget
        — load shedding is an availability hit for that tenant, never
        for the tenants it protects.
        """
        req = FrontDoorRequest(
            request_id=self._next_id,
            tenant=tenant or "default",
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            stop_at_eos=stop_at_eos,
            prefix=prefix,
            submitted_s=self._clock(),
        )
        self._next_id += 1
        if len(self._queue) >= self.max_queue:
            priority = self.effective_priority(req.tenant)
            victim = max(self._queue, key=self._order_key)
            if self.effective_priority(victim.tenant) < priority:
                self._queue.remove(victim)
                self._shed(victim, SHED_DISPLACED)
            else:
                reason = (
                    SHED_BURNING
                    if priority <= DEMOTED_PRIORITY
                    else SHED_QUEUE_FULL
                )
                self._shed(req, reason)
                return None
        self._queue.append(req)
        return req.request_id

    def _shed(self, req: FrontDoorRequest, reason: str) -> None:
        self.shed_by_reason[reason] = (
            self.shed_by_reason.get(reason, 0) + 1
        )
        self.shed_requests[req.request_id] = reason
        self._observer.shed(req.tenant, reason)
        self._record_outcome(req, status="shed")

    def _record_outcome(
        self, req: FrontDoorRequest, status: str
    ) -> None:
        if self._burn is None:
            return
        ttft_ms = 0.0
        tpot_ms = 0.0
        if (
            req.first_token_s is not None
            and req.submitted_s is not None
        ):
            ttft_ms = (req.first_token_s - req.submitted_s) * 1000.0
        if (
            req.completed_s is not None
            and req.first_token_s is not None
            and len(req.tokens) > 1
        ):
            tpot_ms = (
                (req.completed_s - req.first_token_s)
                / (len(req.tokens) - 1)
                * 1000.0
            )
        self._burn.record(
            RequestOutcome(
                tenant=req.tenant,
                ts_unix_nano=self._now_ns(),
                ttft_ms=ttft_ms,
                tpot_ms=tpot_ms,
                tokens=len(req.tokens),
                status=status,
            )
        )

    # ---- slot lifecycle -----------------------------------------------

    def _context_ids(self, req: FrontDoorRequest) -> tuple[list[int], list[int]]:
        """(prefix_ids, full prompt ids) under the joint truncation."""
        prefix_ids, suffix_ids = joint_prompt_ids(
            self.target, self.draft, req.prompt, req.prefix
        )
        return prefix_ids, prefix_ids + suffix_ids

    def _complete(self, req: FrontDoorRequest, now_s: float) -> None:
        req.completed_s = now_s
        self.results[req.request_id] = req.tokens
        self._finished[req.request_id] = req
        self.emitted_tokens += len(req.tokens)
        self._observer.completed(req.tenant, len(req.tokens))
        self._record_outcome(req, status="ok")

    def _admit(self, slot: int, req: FrontDoorRequest) -> None:
        """Place one request into ``slot`` at a round boundary.

        Three entry paths: a PARKED request re-injects its KV snapshot
        (bit-identical resume, no recompute); a snapshot-RESTORED
        request teacher-forces ``prompt + emitted[:-1]`` back through
        prefill; a fresh request ingests its prompt (prefix-cache
        aware) and emits its first token from the prefill logits.
        """
        now_s = self._clock()
        if req.parked is not None:
            if isinstance(req.parked, _PagedParked):
                self._resume_paged(slot, req)
                return
            row_t, row_d, current, start = req.parked
            req.parked = None
            self._install(slot, req, row_t, row_d, current, start)
            self.resumes += 1
            self._observer.resumed(req.tenant)
            return

        prefix_ids, ids = self._context_ids(req)
        # Budget clamp: every round writes k+1 KV slots at the
        # frontier, and the front door has no single-token tail path —
        # the last emittable token must leave the round's write window
        # inside the joint capacity.
        cap = max(
            1,
            min(
                self.target.decode_cap_tokens(len(ids)),
                self.draft.decode_cap_tokens(len(ids)),
                self._joint_seq
                    - self.rounds_per_step * (self.k + 1)
                    - len(ids),
            ),
        )
        req.max_new_tokens = max(1, min(req.max_new_tokens, cap))

        if req.tokens:
            # Snapshot-restored mid-stream request: KV did not survive
            # the restart; rebuild it by teacher-forcing the already-
            # emitted prefix.  Greedy decode makes the continuation
            # identical to the uninterrupted stream.
            self.snapshot_resumes += 1
            self._observer.resumed(req.tenant)
            context = ids + [int(t) for t in req.tokens[:-1]]
            current = int(req.tokens[-1])
            req.admitted_s = req.admitted_s or now_s
            req.first_token_s = req.first_token_s or now_s
            if (
                len(req.tokens) >= req.max_new_tokens
                or (req.stop_at_eos and current == EOS)
                or len(context) + 1 >= self._limit
            ):
                self._complete(req, now_s)
                return
            (_logits, row_t), (_logits_d, row_d) = self._admit_both(
                lambda adm: adm.ingest_ids(context, req.prefix, prefix_ids)
            )
            self._install(
                slot, req, row_t,
                _rehome_draft_cache(self.target, self.draft, row_d),
                current, len(context),
            )
            return

        (logits, row_t), (_logits_d, row_d) = self._admit_both(
            lambda adm: adm.ingest_ids(ids, req.prefix, prefix_ids)
        )
        first_token = logits.argmax(dim=-1)
        # The rows and the first token go into the slot at once (the
        # staged rows are overwritten by the next admission); the first
        # token is read with the fill's others (:meth:`_read_firsts`).
        # An instant completion leaves them there as a free lane's
        # garbage, as a batched admission does.
        _inject_row(self._cache_t, row_t, slot)
        _inject_row(self._cache_d, _rehome_draft_cache(self.target, self.draft, row_d), slot)
        self._tokens[slot:slot + 1].copy_(first_token)
        self._hold_first(slot, req, first_token, now_s, len(ids))

    def _admit_both(self, ingest):
        """``ingest(pieces)`` on the target's admission pieces, then on the
        draft's (:class:`~tpuslo_torch.models.serve.AdmissionGraphs`): two
        (logits, rows) in staged storage, which the caller injects at
        once.  Counts the chunks no piece served."""
        eager = sum(a.eager_chunks for a in self._adms)
        out = ingest(self._adm_t), ingest(self._adm_d)
        self.eager_admissions += sum(a.eager_chunks for a in self._adms) - eager
        return out

    def _batchable(self, req: FrontDoorRequest) -> bool:
        """Fresh plain-prompt requests lockstep-prefill together;
        parked (KV snapshot), snapshot-restored (teacher-forced) and
        prefix requests (snapshot clone + suffix append) each need
        their own ingestion path and admit individually."""
        return req.parked is None and not req.tokens and not req.prefix

    def _admit_batch(
        self, slots: list[int], reqs: list[FrontDoorRequest]
    ) -> None:
        """Admit a run of fresh requests in ONE lockstep batched
        prefill per engine plus ONE multi-row inject per pool, with a
        single read of the first tokens.  Pad rows (batch bucket
        discipline) alias a real slot and are overwritten by the
        reverse-ordered inject: its copies are queued one after the
        other, pad rows first, so the real row wins on a card too.
        """
        now_s = self._clock()
        all_ids: list[list[int]] = []
        for req in reqs:
            _prefix_ids, ids = self._context_ids(req)
            cap = max(
                1,
                min(
                    self.target.decode_cap_tokens(len(ids)),
                    self.draft.decode_cap_tokens(len(ids)),
                    self._joint_seq
                    - self.rounds_per_step * (self.k + 1)
                    - len(ids),
                ),
            )
            req.max_new_tokens = max(1, min(req.max_new_tokens, cap))
            all_ids.append(ids)
        bucket = _bucket(len(reqs), self._admit_buckets)
        padded = all_ids + [[BOS]] * (bucket - len(reqs))
        (logits_t, rows_t), (_logits_d, rows_d) = self._admit_both(
            lambda adm: adm.prefill_rows(padded)
        )
        rows_d = _rehome_draft_cache(self.target, self.draft, rows_d)
        first_tokens = logits_t.argmax(dim=-1)
        # Pad rows alias the first real slot; the reverse-ordered
        # inject writes them first, so the real row wins.
        assignment = [
            slots[i] if i < len(reqs) else slots[0]
            for i in range(bucket)
        ]
        _inject_rows(self._cache_t, rows_t, assignment)
        _inject_rows(self._cache_d, rows_d, assignment)
        real_slots = _upload(slots[: len(reqs)], torch.long, self.device)
        self._tokens[real_slots] = first_tokens[: len(reqs)]
        for i, req in enumerate(reqs):
            self._hold_first(
                slots[i], req, first_tokens[i : i + 1], now_s, len(all_ids[i])
            )

    def _hold_first(
        self,
        slot: int,
        req: FrontDoorRequest,
        token: torch.Tensor,
        now_s: float,
        start: int,
    ) -> None:
        """Keep an admission's first token (``token``, one element on the
        device) for the fill's one read.  A request that ends on its
        first token whatever it is (a one-token budget) leaves ``slot``
        free for the next admission, as it would once read; any other
        holds the slot until the read decides."""
        req.admitted_s = now_s
        req.first_token_s = now_s
        holds = req.max_new_tokens > 1
        if holds:
            self._slots[slot] = req
        self._firsts.append(
            _FirstToken(slot if holds else None, req, token, now_s, start)
        )

    def _read_firsts(self) -> None:
        """Read every held first token in ONE host read, then finish the
        admissions in their order: each request's first token, then its
        slot's frontier, or its completion where the token ends it (EOS,
        a one-token budget; an instant complete's injected row simply
        becomes a parked lane until something overwrites it)."""
        held, self._firsts = self._firsts, []
        firsts = _HostRead(torch.cat([h.token for h in held])).values()
        for h, first in zip(held, firsts):
            req = h.req
            req.tokens.append(first)
            self._observer.admitted(req.tenant)
            if (req.stop_at_eos and first == EOS) or req.max_new_tokens <= 1:
                if h.slot is not None:
                    self._slots[h.slot] = None
                self._complete(req, h.now_s)
                continue
            self._start[h.slot] = h.start
            self._current[h.slot] = first

    def _install(
        self,
        slot: int,
        req: FrontDoorRequest,
        row_t: Cache,
        row_d: Cache,
        current: int,
        start: int,
    ) -> None:
        _inject_row(self._cache_t, row_t, slot)
        _inject_row(self._cache_d, row_d, slot)
        self._tokens[slot] = int(current)
        self._start[slot] = start
        self._current[slot] = current
        self._slots[slot] = req

    def _park(self, slot: int) -> None:
        """Preempt ``slot``: snapshot its KV rows + frontier and return
        the request to the queue (it resumes bit-identically via
        re-injection when scheduled again).  The snapshot is a copy:
        the pool is written in place by every later round.

        Paged mode parks block-granular (cost ∝ blocks touched); a
        full side pool falls back to the dense full-row snapshot,
        counted in ``paged_fallback_parks`` — preemption must never
        fail just because the park pool is contended.
        """
        req = self._slots[slot]
        if req is None:
            return
        if self.paged:
            if self._park_paged(slot, req):
                return
            self.paged_fallback_parks += 1
        row_t = _extract_row(self._cache_t, slot)
        row_d = _extract_row(self._cache_d, slot)
        req.parked = (
            row_t, row_d,
            int(self._current[slot]), int(self._start[slot]),
        )
        req.preemptions += 1
        self.preemptions += 1
        self._slots[slot] = None
        self._queue.append(req)
        self._observer.preempted(req.tenant)

    def _park_paged(self, slot: int, req: FrontDoorRequest) -> bool:
        """Block-granular preemption: copy only the pow2 bucket of
        aligned blocks covering ``slot``'s frontier into the side
        pools (one indexed copy per cache leaf), so a short stream's park
        moves a few blocks, not ``max_seq_len`` positions.  Returns
        False when the free list cannot cover the bucket (caller
        falls back to the dense full-row park)."""
        frontier = int(self._start[slot])
        needed = -(-frontier // self.block_size)
        bucket = 1
        while bucket < needed:
            bucket <<= 1
        bucket = min(bucket, self._joint_seq // self.block_size)
        if len(self._free_blocks) < bucket:
            return False
        phys = tuple(self._free_blocks[:bucket])
        del self._free_blocks[:bucket]
        self._paged_pool_t = park_slot_blocks(
            self._paged_pool_t, self._cache_t, slot, phys,
            self.target.cfg, self.block_size, bucket,
        )
        self._paged_pool_d = park_slot_blocks(
            self._paged_pool_d, self._cache_d, slot, phys,
            self.draft.cfg, self.block_size, bucket,
        )
        req.parked = _PagedParked(
            phys=phys,
            current=int(self._current[slot]),
            frontier=frontier,
        )
        req.preemptions += 1
        self.preemptions += 1
        self.paged_parks += 1
        self._slots[slot] = None
        self._queue.append(req)
        self._observer.preempted(req.tenant)
        return True

    def _resume_paged(self, slot: int, req: FrontDoorRequest) -> None:
        """Re-install a block-granular park into ``slot``: gather the
        parked blocks back into the dense decode caches (one indexed
        copy per cache leaf) and free them.  Positions past the parked
        window keep stale-occupant garbage — the round kernels mask to
        the frontier and overwrite it before it is ever attended, the
        same discipline the dense slots already rely on."""
        parked = req.parked
        req.parked = None
        bucket = len(parked.phys)
        resume_slot_blocks(
            self._cache_t, self._paged_pool_t, slot, parked.phys,
            parked.frontier, self.target.cfg, self.block_size, bucket,
        )
        resume_slot_blocks(
            self._cache_d, self._paged_pool_d, slot, parked.phys,
            parked.frontier, self.draft.cfg, self.block_size, bucket,
        )
        self._free_blocks.extend(parked.phys)
        self._tokens[slot] = int(parked.current)
        self._start[slot] = parked.frontier
        self._current[slot] = parked.current
        self._slots[slot] = req
        self.resumes += 1
        self.paged_resumes += 1
        self._observer.resumed(req.tenant)

    def _materialize_parked(self, req: FrontDoorRequest) -> None:
        """Convert a block-granular park into the dense ``(row_t,
        row_d, current, frontier)`` snapshot any replicated engine's
        ``_admit`` installs directly — the cross-engine drain currency.
        O(max_seq_len) gather per cache, but only on the rare
        engine-death path; pad block ids hit null block 0 (zeros)."""
        parked = req.parked
        if not isinstance(parked, _PagedParked):
            return
        mb_t = self.target.cfg.max_seq_len // self.block_size
        mb_d = self.draft.cfg.max_seq_len // self.block_size
        pad_t = parked.phys + (0,) * (mb_t - len(parked.phys))
        pad_d = parked.phys + (0,) * (mb_d - len(parked.phys))
        row_t = gather_parked_row(
            self._paged_pool_t, pad_t, parked.frontier,
            self.target.cfg, self.block_size,
        )
        row_d = gather_parked_row(
            self._paged_pool_d, pad_d, parked.frontier,
            self.draft.cfg, self.block_size,
        )
        self._free_blocks.extend(parked.phys)
        req.parked = (row_t, row_d, parked.current, parked.frontier)

    def drain(self) -> list[FrontDoorRequest]:
        """Kill-path evacuation: park every running slot, convert
        block-granular parks to dense portable snapshots, and hand
        back EVERY live request — in-flight work first (it was
        admitted once already), then the waiting queue.  The engine
        ends empty; nothing sheds, nothing is lost.  The router
        re-homes the returned requests onto siblings via
        :meth:`adopt`."""
        for slot in range(self.max_slots):
            if self._slots[slot] is not None:
                self._park(slot)
        evacuated = list(self._queue)
        self._queue = []
        for req in evacuated:
            self._materialize_parked(req)
        evacuated.sort(
            key=lambda r: (r.parked is None, r.request_id)
        )
        return evacuated

    def adopt(self, req: FrontDoorRequest) -> int:
        """Take over a drained sibling's request under a FRESH local
        id.  Replicated engines share configs, so a dense park
        snapshot re-injects here bit-identically and an emitted-token
        prefix teacher-forces to the same continuation.  Adoption
        never sheds — rebalancing-under-failure must not lose
        requests."""
        req.request_id = self._next_id
        self._next_id += 1
        self._queue.append(req)
        return req.request_id

    def _fill_slots(self) -> None:
        """Admit (and, under pressure, preempt) at a round boundary.

        The admissions' first tokens are read once per fill
        (:meth:`_read_firsts`), not once per admission.  A read first
        token can end its request (EOS) and free its slot, so the fill
        reads before any decision that depends on the free slots it
        would give, and admits again after the read: every admission,
        shed and preemption is the one a read per admission makes.
        """
        self._admit_queued()
        while self._firsts:
            self._read_firsts()
            self._admit_queued()

    def _admit_queued(self) -> None:
        """Admit queued requests while the free slots allow; return where
        a decision needs the held first tokens read first.

        Preemption fires only for a STRICTLY higher-priority queued
        request than the lowest-priority running slot — equal
        priorities never thrash, and each park+admit raises the
        running-priority multiset, so the loop is bounded.
        """
        while self._queue:
            free = [
                i
                for i, occupant in enumerate(self._slots)
                if occupant is None
            ]
            if not free and (self._firsts or self._burn is None):
                # A full house: the held first tokens are read first (one
                # may be EOS and free its slot; a park needs its slot's
                # frontier).  Uniform priorities (no burn engine):
                # preemption can never fire, so a full house needs no
                # queue sort — this boundary is a pure decode round.
                return
            # A held first token may be EOS and free its slot, which a
            # batch the free slots cut would then take.
            may_free = any(
                h.slot is not None and h.req.stop_at_eos for h in self._firsts
            )
            self._queue.sort(key=self._order_key)
            if free:
                if self._batchable(self._queue[0]):
                    run = 0
                    while (
                        run < len(self._queue)
                        and run <= len(free)
                        and self._batchable(self._queue[run])
                    ):
                        run += 1
                    if run > len(free) and may_free:
                        return
                    run = min(run, len(free))
                    reqs = self._queue[:run]
                    del self._queue[:run]
                    self._admit_batch(free[:run], reqs)
                else:
                    self._admit(free[0], self._queue.pop(0))
                continue
            head_priority = self.effective_priority(
                self._queue[0].tenant
            )
            victim = min(
                range(self.max_slots),
                key=lambda s: (
                    self.effective_priority(self._slots[s].tenant),
                    -self._slots[s].request_id,
                ),
            )
            victim_priority = self.effective_priority(
                self._slots[victim].tenant
            )
            if head_priority <= victim_priority:
                break
            self._park(victim)

    # ---- the round loop ------------------------------------------------

    def step(self) -> bool:
        """Admit waiting requests, then run ONE multi-round dispatch
        across every occupied slot (fixed shapes, one packed device
        read).  Returns True while any work remains.

        With a ``self_tracer`` the step emits a root span with
        admit/dispatch/read/retire children and the per-dispatch
        ledger totals as span attrs.
        """
        if self._tracer is not None:
            with self._tracer.cycle(
                "frontdoor.step",
                queued=len(self._queue),
                rounds=self.rounds,
            ) as cycle:
                return self._step(cycle)
        return self._step(_NULL_CYCLE)

    def _step(self, cycle) -> bool:
        with cycle.stage("admit"):
            self._fill_slots()
        mask = np.asarray(
            [occupant is not None for occupant in self._slots]
        )
        if not mask.any():
            return bool(self._queue)
        t0 = time.perf_counter_ns()
        with cycle.stage("dispatch"):
            self._start_in.write(self._start)
            self._active_in.write(mask)
            read = _HostRead(self._dispatch())
        t1 = time.perf_counter_ns()
        with cycle.stage("read"):
            rows = read.values()  # (slots, rounds, 2k + 2)
        t2 = time.perf_counter_ns()
        k = self.k
        self.rounds += 1
        now_s = self._clock()
        appended = 0
        with cycle.stage("retire") as retire:
            for slot, req in enumerate(self._slots):
                if req is None:
                    continue
                # Consume the dispatch's sub-rounds in order; a row that
                # finishes mid-dispatch discards its remaining sub-rounds
                # (the device decoded them as parked-lane garbage).  The
                # host frontier/current mirrors advance only while the row
                # continues, so a CONTINUING row's mirrors exactly match
                # the device state — which is all parking needs.
                done = False
                for r in range(self.rounds_per_step):
                    drafts, picks, n = unpack_round(rows[slot][r], k)
                    emitted = [int(v) for v in drafts[:n]] + [
                        int(picks[n])
                    ]
                    self.slot_rounds += 1
                    self.accepted_draft_tokens += n
                    self._start[slot] += n + 1
                    self._current[slot] = emitted[-1]
                    for token in emitted:
                        req.tokens.append(token)
                        appended += 1
                        if req.stop_at_eos and token == EOS:
                            done = True
                            break
                        if len(req.tokens) >= req.max_new_tokens:
                            done = True
                            break
                    if done:
                        break
                if not done and self._start[slot] >= self._limit:
                    # Defensive: admission clamps budgets so the frontier
                    # cannot cross the dispatch-write limit mid-request.
                    done = True
                if done:
                    self._slots[slot] = None
                    self._complete(req, now_s)
            # Per dispatch: the host's time to queue the chained rounds,
            # then the wait of the packed read for what the device
            # still owed (see tpuslo_torch.deviceplane.dispatch).
            # Totals ride the span, built only when a tracer is wired;
            # the untraced hot loop pays the three perf_counter reads
            # and nothing else.
            self.dispatch_ledger.note(
                t1 - t0, t2 - t1, appended, int(mask.sum())
            )
            if self._tracer is not None:
                retire.set(
                    **self.dispatch_ledger.last(),
                    device_wait_ms_total=round(
                        self.dispatch_ledger.device_wait_ms_total, 3
                    ),
                )
        return bool(self._queue) or any(
            occupant is not None for occupant in self._slots
        )

    def run(self) -> dict[int, list[int]]:
        """Drive until every admitted request completes; returns all
        finished results (cumulative across calls)."""
        while self.step():
            pass
        return self.results

    def cancel(self, request_id: int) -> None:
        """Abandon a request wherever it lives (idempotent).

        A cancelled completed request leaves BOTH result surfaces
        (``results`` and the timing records) — telemetry must never
        report a request the results table says doesn't exist."""
        self.results.pop(request_id, None)
        self._finished.pop(request_id, None)
        self._queue = [
            r for r in self._queue if r.request_id != request_id
        ]
        for slot, req in enumerate(self._slots):
            if req is not None and req.request_id == request_id:
                self._slots[slot] = None

    def partial_tokens(self, request_id: int) -> list[int] | None:
        """Tokens produced so far (``[]`` while queued, ``None`` for
        unknown/shed requests)."""
        if request_id in self.results:
            return list(self.results[request_id])
        for req in self._slots:
            if req is not None and req.request_id == request_id:
                return list(req.tokens)
        for req in self._queue:
            if req.request_id == request_id:
                return list(req.tokens)
        return None

    # ---- telemetry ------------------------------------------------------

    def request_timings(self) -> dict[int, dict[str, float]]:
        """Per-completed-request latency SLIs (seconds): queue delay,
        TTFT, TPOT, end-to-end.  Snapshot-restored requests carry no
        cross-process timestamps and are excluded."""
        out: dict[int, dict[str, float]] = {}
        for rid, req in self._finished.items():
            if (
                req.resumed_from_snapshot
                or req.submitted_s is None
                or req.admitted_s is None
                or req.first_token_s is None
            ):
                continue
            record = {
                "queue_delay_s": req.admitted_s - req.submitted_s,
                "ttft_s": req.first_token_s - req.submitted_s,
                "tenant": req.tenant,
                "tokens": float(len(req.tokens)),
                "preemptions": float(req.preemptions),
            }
            if req.completed_s is not None:
                record["e2e_s"] = req.completed_s - req.submitted_s
                if len(req.tokens) > 1:
                    record["tpot_s"] = (
                        req.completed_s - req.first_token_s
                    ) / (len(req.tokens) - 1)
            out[rid] = record
        return out

    def stats(self) -> dict[str, Any]:
        active = sum(1 for s in self._slots if s is not None)
        return {
            "active_slots": active,
            "max_slots": self.max_slots,
            "occupancy": active / self.max_slots,
            "queued": len(self._queue),
            "rounds": self.rounds,
            "slot_rounds": self.slot_rounds,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "completed": len(self.results),
            "emitted_tokens": self.emitted_tokens,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "snapshot_resumes": self.snapshot_resumes,
            "shed": dict(self.shed_by_reason),
            "paged": {
                "enabled": self.paged,
                "block_size": self.block_size if self.paged else 0,
                "pool_blocks": self._pool_blocks,
                "free_blocks": len(self._free_blocks),
                "parks": self.paged_parks,
                "resumes": self.paged_resumes,
                "fallback_parks": self.paged_fallback_parks,
            },
            "dispatch_ledger": self.dispatch_ledger.totals(),
        }

    # ---- snapshot / restore (crash-safe runtime) ------------------------

    def export_state(self) -> dict[str, Any]:
        """JSON-safe snapshot: queue + in-flight requests persist as
        their emitted-token prefixes (parked/running KV cannot ride a
        JSON snapshot; restore resumes them by re-prefill)."""
        in_flight = [
            req.persistable()
            for req in self._slots
            if req is not None
        ]
        return {
            "version": STATE_VERSION,
            "next_id": self._next_id,
            "queue": [req.persistable() for req in self._queue],
            "in_flight": in_flight,
            "results": {
                str(rid): [int(t) for t in tokens]
                for rid, tokens in self.results.items()
            },
            "shed_by_reason": dict(self.shed_by_reason),
            "shed_requests": {
                str(rid): reason
                for rid, reason in self.shed_requests.items()
            },
            "counters": {
                "emitted_tokens": self.emitted_tokens,
                "preemptions": self.preemptions,
                "slot_rounds": self.slot_rounds,
                "accepted_draft_tokens": self.accepted_draft_tokens,
            },
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        if not isinstance(state, dict):
            return
        if int(state.get("version", -1)) != STATE_VERSION:
            return
        self._next_id = int(state.get("next_id", 0))
        # In-flight requests re-enter the queue ahead of the waiting
        # ones (they were already admitted once) and resume by
        # teacher-forced re-prefill in _admit.
        self._queue = [
            FrontDoorRequest.from_persisted(raw)
            for raw in (
                list(state.get("in_flight") or [])
                + list(state.get("queue") or [])
            )
            if isinstance(raw, dict)
        ]
        self.results = {
            int(rid): [int(t) for t in tokens]
            for rid, tokens in (state.get("results") or {}).items()
        }
        for reason, count in (state.get("shed_by_reason") or {}).items():
            self.shed_by_reason[str(reason)] = int(count)
        self.shed_requests = {
            int(rid): str(reason)
            for rid, reason in (state.get("shed_requests") or {}).items()
        }
        counters = state.get("counters") or {}
        self.emitted_tokens = int(counters.get("emitted_tokens", 0))
        self.preemptions = int(counters.get("preemptions", 0))
        self.slot_rounds = int(counters.get("slot_rounds", 0))
        self.accepted_draft_tokens = int(
            counters.get("accepted_draft_tokens", 0)
        )
