"""Continuous batching (PyTorch port of ``tpuslo/models/batching.py``).

Requests join and leave a running decode batch.  The engine owns a fixed
set of ``max_slots`` KV-cache rows and decodes all of them in one
vector-length :func:`tpuslo_torch.models.llama.decode_step` per step
(``cache["length"]`` is a ``(B,)`` tensor).  A request is admitted into
a free slot at any step boundary:

1. the prompt is ingested into a fresh single-row cache by the shared
   :class:`~tpuslo_torch.models.serve.ServeEngine` (bucketed prefill,
   chunked appends, prefix snapshots);
2. the row is copied into the slot in place and the slot's length set;
3. every step decodes ALL slots; released slots keep decoding tokens
   that nobody reads until a new request overwrites them, and their
   writes past the cache end are dropped
   (:func:`tpuslo_torch.models.kv_cache.kv_write_rows`).

What differs from the JAX engine: there is no jit, so JAX's shared
``_SHARED_*`` compile caches have no counterpart and splices are
in-place copies.  Each step reads its tokens to the host once, as the
JAX engine's one ``device_get`` per step does, and nothing else.
Tensor-parallel serving (``mesh=``) belongs to the multi-device slice
and raises.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from tpuslo_torch.models.kv_cache import kv_leaf_pairs, kv_map, validate_kv_dtype
from tpuslo_torch.models.llama import (
    LlamaConfig,
    decode_step,
    init_kv_cache,
    llama_tiny,
)
from tpuslo_torch.models.serve import BOS, EOS, ServeEngine
from tpuslo_torch.otel.xla_spans import dispatch_range

Cache = dict[str, Any]


def _copy_length(lengths: torch.Tensor, slot: int, value) -> None:
    """``lengths[slot] = value`` for a host int or a device scalar, with
    no host read."""
    if isinstance(value, torch.Tensor):
        lengths[slot].copy_(value.reshape(()))
    else:
        lengths[slot:slot + 1].fill_(int(value))


def _inject_rows(pool: Cache, rows: Cache, slots: Sequence[int]) -> Cache:
    """Copy EVERY row of a batched cache into ``slots`` of the pool, in
    place (both KV representations: the batch axis is axis 1 of every
    leaf), and set each slot's length.

    The writes land in REVERSE row order, so callers may alias PAD rows
    (the tail of a bucket-padded batch) to a real row's slot: the real
    row writes later and wins.
    """
    lengths = rows["length"]
    with dispatch_range("inject_rows", rows["k"], len(slots)):
        for i in reversed(range(len(slots))):
            slot = int(slots[i])
            for side in ("k", "v"):
                for dst, src in kv_leaf_pairs(pool[side], rows[side]):
                    dst.select(1, slot).copy_(src.select(1, i))
            per_row = isinstance(lengths, torch.Tensor) and lengths.ndim == 1
            _copy_length(pool["length"], slot, lengths[i] if per_row else lengths)
    return pool


def _inject_row(cache: Cache, row: Cache, slot: int) -> Cache:
    """Copy a single-row cache into ``slot`` of the batched cache."""
    return _inject_rows(cache, row, [slot])


def _extract_row(pool: Cache, slot: int) -> Cache:
    """Copy ``slot``'s row out of a batched cache as a single-row cache
    (the inverse of :func:`_inject_row`); the pool keeps serving."""

    def take(leaf: torch.Tensor) -> torch.Tensor:
        return leaf[:, slot : slot + 1].clone()

    with dispatch_range("extract_row", pool["k"]):
        return {
            "k": kv_map(take, pool["k"]),
            "v": kv_map(take, pool["v"]),
            "length": pool["length"][slot].clone(),
        }


@dataclass
class _Request:
    request_id: int
    prompt: str
    max_new_tokens: int
    stop_at_eos: bool
    prefix: str | None = None
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    # Ingested prompt state, kept across capacity-blocked admission
    # attempts so a blocked request pays its prefill once.
    ingested: tuple | None = None
    # Lifecycle timestamps (perf_counter seconds).
    submitted_s: float | None = None
    admitted_s: float | None = None
    completed_s: float | None = None


class ContinuousBatchingEngine:
    """Greedy continuous-batching server over one Llama model.

    ``submit()`` enqueues requests; ``run()`` (or repeated ``step()``)
    drives the batch until every request completes.  Per-request output
    equals the single-request greedy stream.  ``device`` defaults to
    ``"cuda"`` and raises without a card.

    ``ingest`` and ``step_fn`` are the model-family extension points:
    another family supplies its own prompt ingester (an object with
    ``params``, ``device``, ``ingest_prompt`` and ``decode_cap_tokens``)
    and its own ``step_fn(params, tokens, cache) -> (logits, cache)``,
    and inherits the scheduler unchanged.
    """

    def __init__(
        self,
        cfg: LlamaConfig | None = None,
        params=None,
        max_slots: int = 4,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128, 256),
        quantize: bool = False,
        kv_dtype: str = "bf16",
        mesh=None,
        ingest=None,
        step_fn=None,
        device: str | torch.device = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet; the "
                "port serves on one device"
            )
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.kv_dtype = validate_kv_dtype(kv_dtype)
        self.cfg = cfg or llama_tiny(max_seq_len=512)
        self.max_slots = max_slots
        if ingest is None:
            ingest = ServeEngine(
                cfg=self.cfg, params=params, prefill_buckets=prefill_buckets,
                kv_dtype=kv_dtype, rng_seed=rng_seed,
                quantize=quantize and params is None, device=device,
            )
        self._ingest = ingest
        self.device = ingest.device
        self.params = self._ingest.params
        self._step = (
            step_fn if step_fn is not None
            else functools.partial(decode_step, cfg=self.cfg)
        )
        # The step's program name in a profiler capture.
        self._step_program = getattr(
            getattr(self._step, "func", self._step), "__name__", "step_fn"
        )

        self._cache = self._init_decode_state()
        self._tokens = torch.full(
            (max_slots,), BOS, dtype=torch.long, device=self.device
        )

        self._queue: list[_Request] = []
        self._slots: list[_Request | None] = [None] * max_slots
        self._next_id = 0
        self.steps = 0
        #: finished request id -> emitted token ids
        self.results: dict[int, list[int]] = {}
        #: finished request id -> lifecycle record (for timing SLIs)
        self._finished: dict[int, _Request] = {}

    # -- decode-state hooks (overridden by the paged engine) -------------

    def _init_decode_state(self) -> Cache:
        cache = init_kv_cache(
            self.cfg, self.max_slots, kv_dtype=self.kv_dtype, device=self.device
        )
        cache["length"] = torch.zeros(
            (self.max_slots,), dtype=torch.long, device=self.device
        )
        return cache

    def _install_row(self, slot: int, row_cache: Cache, req: _Request) -> bool:
        """Splice an ingested row into ``slot``; False = no capacity
        (the paged engine's block pool can run dry; dense never does)."""
        self._cache = _inject_row(self._cache, row_cache, slot)
        return True

    def _decode_tokens(self) -> torch.Tensor:
        with dispatch_range(self._step_program, self._tokens, self._cache):
            logits, self._cache = self._step(self.params, self._tokens, self._cache)
        return logits

    def _release_slot(self, slot: int) -> None:
        """Called when a request leaves its slot (done or cancelled)."""

    # -- submission ------------------------------------------------------

    def submit(
        self,
        prompt: str,
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        prefix: str | None = None,
    ) -> int:
        """Enqueue a request; returns its id (see ``results``).

        ``prefix`` rides the shared ingest engine's KV prefix cache (the
        effective prompt is ``prefix + prompt``; only the suffix
        prefills at admission).
        """
        req = _Request(
            self._next_id, prompt, max_new_tokens, stop_at_eos, prefix=prefix
        )
        req.submitted_s = time.perf_counter()
        self._next_id += 1
        self._queue.append(req)
        return req.request_id

    def _admit(self, slot: int, req: _Request) -> bool:
        if req.ingested is None:
            req.ingested = self._ingest.ingest_prompt(req.prompt, req.prefix)
        logits, row_cache, total_len = req.ingested
        # The budget single-request serving applies (chunk-rounded KV
        # cap): the parity contract requires identical truncation.
        cap_tokens = self._ingest.decode_cap_tokens(total_len)
        req.max_new_tokens = max(1, min(req.max_new_tokens, cap_tokens))
        first = int(logits.argmax(dim=-1)[0])
        if (req.stop_at_eos and first == EOS) or req.max_new_tokens <= 1:
            req.ingested = None
            req.tokens.append(first)
            req.done = True
            req.admitted_s = req.completed_s = time.perf_counter()
            self.results[req.request_id] = req.tokens
            self._finished[req.request_id] = req
            return True
        # A False return means no KV capacity right now: the request goes
        # back to the queue head unmodified and waits for a release.
        if not self._install_row(slot, row_cache, req):
            self._queue.insert(0, req)
            return False
        req.ingested = None
        req.admitted_s = time.perf_counter()
        req.tokens.append(first)
        self._tokens[slot] = first
        self._slots[slot] = req
        return True

    def _fill_slots(self) -> None:
        for slot in range(self.max_slots):
            # Keep admitting into this slot until something occupies it
            # (instantly-completing requests leave it free) or the queue
            # drains.
            while self._slots[slot] is None and self._queue:
                if not self._admit(slot, self._queue.pop(0)):
                    return

    # -- stepping --------------------------------------------------------

    def step(self) -> bool:
        """Admit waiting requests, decode one token for every slot.

        Returns True while any work remains.
        """
        self._fill_slots()
        if not any(s is not None for s in self._slots):
            # No active slot means no work (a capacity block is
            # impossible with every block free): never dispatch a decode
            # whose outputs nobody reads.
            return False
        logits = self._decode_tokens()
        next_tokens = logits.argmax(dim=-1)
        self._tokens = next_tokens
        self.steps += 1
        values = next_tokens.tolist()  # the step's one host read
        for slot, req in enumerate(self._slots):
            if req is None:
                continue  # released lane: decoded garbage, discarded
            token = int(values[slot])
            req.tokens.append(token)
            if (req.stop_at_eos and token == EOS) or len(
                req.tokens
            ) >= req.max_new_tokens:
                req.done = True
                req.completed_s = time.perf_counter()
                self.results[req.request_id] = req.tokens
                self._finished[req.request_id] = req
                self._slots[slot] = None
                self._release_slot(slot)
        return bool(self._queue) or any(s is not None for s in self._slots)

    def cancel(self, request_id: int) -> None:
        """Abandon a request wherever it lives: queue, slot, or results.
        Idempotent; a freed slot is re-admitted into and overwritten."""
        self.results.pop(request_id, None)
        self._queue = [r for r in self._queue if r.request_id != request_id]
        for slot, req in enumerate(self._slots):
            if req is not None and req.request_id == request_id:
                self._slots[slot] = None
                self._release_slot(slot)

    def partial_tokens(self, request_id: int) -> list[int] | None:
        """Copy of the tokens produced so far: ``[]`` while queued, the
        accumulated tokens while in a slot or finished, ``None`` for an
        unknown request."""
        if request_id in self.results:
            return list(self.results[request_id])
        for req in self._slots:
            if req is not None and req.request_id == request_id:
                return list(req.tokens)
        for req in self._queue:
            if req.request_id == request_id:
                return []
        return None

    def request_timings(self) -> dict[int, dict[str, float]]:
        """Per-completed-request lifecycle SLIs.

        ``queue_delay_s`` is submit -> admission into a decode slot
        (prefill included).  The first token comes from the prefill's
        logits and is emitted at admission, so it is also the time to
        first token.  ``e2e_s`` is submit -> final token.
        """
        out: dict[int, dict[str, float]] = {}
        for rid, req in self._finished.items():
            if req.submitted_s is None or req.admitted_s is None:
                continue
            record = {"queue_delay_s": req.admitted_s - req.submitted_s}
            if req.completed_s is not None:
                record["e2e_s"] = req.completed_s - req.submitted_s
            out[rid] = record
        return out

    def stats(self) -> dict[str, int | float]:
        """Scheduler telemetry: slot occupancy is the serving-efficiency
        SLI (empty lanes waste the decode dispatch)."""
        active = sum(1 for s in self._slots if s is not None)
        return {
            "active_slots": active,
            "max_slots": self.max_slots,
            "occupancy": active / self.max_slots,
            "queued": len(self._queue),
            "steps": self.steps,
            "completed": len(self.results),
        }

    def run(self) -> dict[int, list[int]]:
        """Drive until every submitted request completes; returns all
        finished results (cumulative across calls)."""
        while self.step():
            pass
        return self.results
