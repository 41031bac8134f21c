"""Speculative decoding: a draft model proposes, the target verifies
(PyTorch port of ``tpuslo/models/speculative.py``).

Greedy speculative decoding with the exactness guarantee: the emitted
token stream is **identical** to decoding the target model alone;
speculation only changes how many target forward passes are needed.
Each round:

1. the draft greedily proposes ``k`` tokens (``k`` decode steps on the
   small model);
2. the target scores the chunk ``[current, d1..dk]`` in ONE forward
   (:func:`tpuslo_torch.models.llama.verify_chunk`, ``k + 1`` positions);
3. the longest prefix of draft tokens matching the target's greedy
   choices is accepted, plus the target's own next token, so every round
   emits between 1 and ``k + 1`` tokens for a single target pass.

Rollback is O(1): rejected positions' KV stays in the cache but
``length`` is set to the accepted frontier, which makes stale slots
invisible (the bucketed-prefill discipline).

What differs from the JAX module, and why:

* The JAX round is one ``jax.jit`` program with donated caches, memoized
  per ``(cfg_t, cfg_d, k[, rounds])``.  Here the round is a plain
  function on tensors that queues its kernels and writes both caches in
  place.  The memoized ``_shared_*`` functions keep their names, so that
  a reader finds the counterpart; what they memoize is a closure, and it
  is the eager body the CPU runs.
* The structure that matters is kept: inside a round there is **no host
  read** and no control flow that depends on device data.  ``current``,
  the frontiers, the active mask and the accepted counts are device
  tensors; a single stream's frontier is a 0-d device tensor
  (:func:`tpuslo_torch.models.llama.init_kv_cache` says how the model
  functions take it).  Per round the host reads one packed
  ``(drafts, preds, accepted)`` tensor through
  :class:`tpuslo_torch.models.serve._HostRead`.
* On a card every dispatch is **one CUDA graph replay**, as it is one
  jitted program in JAX
  (:class:`~tpuslo_torch.models.graphs.GraphedDispatch`).  A graph bakes
  in addresses, so the engines own buffers whose storage never changes:
  the caches, ``current``, the frontiers and the mask (refilled from
  pinned host memory, :class:`~tpuslo_torch.models.graphs.StagedInput`),
  and the packed output.
  A request's prefill writes fresh caches, which are copied into the
  engine's; the single-token tail near capacity stays eager.  Each
  capture is the port's compile: it lands in the target
  ``ServeEngine``'s ``compile_events``.  On the CPU the same buffers are
  used and the round runs eagerly.
* A tp target (a :class:`ServeEngine` over a mesh) runs as one engine
  per tp rank, every rank the same rounds.  An unsharded draft is
  replicated: each rank holds the whole draft and its cache on its own
  device, which is what JAX's :func:`_rehome_draft_cache` makes of the
  draft's cache on the target's mesh.  The rounds' CUDA graphs cannot
  capture collectives that go through host memory (gloo with CUDA
  tensors): such a target is refused on the card.
"""

from __future__ import annotations

import weakref
from functools import lru_cache

import numpy as np
import torch

from tpuslo_torch.models.graphs import GraphedDispatch, StagedInput, copy_cache
from tpuslo_torch.models.kv_cache import kv_leaf_pairs
from tpuslo_torch.models.llama import decode_chunk, decode_step, init_kv_cache, verify_chunk
from tpuslo_torch.models.serve import (
    EOS,
    ServeEngine,
    _bucket,
    _HostRead,
    _upload,
    encode_bytes,
    prefix_prompt_ids,
)
from tpuslo_torch.otel.xla_spans import dispatch_range


def _spec_round_core(
    params_t, params_d, current, cache_t, cache_d, start, active,
    k, cfg_t, cfg_d,
):
    """One full speculative round, queued with no host read.

    ``start`` is the pre-round frontier as a device tensor: 0-d for the
    single-stream path or ``(B,)`` for batched speculation.  ``active``
    (batch only; ``None`` = all rows live) is a ``(B,)`` bool tensor that
    freezes finished rows' frontiers and carries, so that a done row
    never burns budget; the host passes the same mask it uses for
    emission.

    Acceptance is computed ON DEVICE (longest matching prefix via a
    cumulative product) and the draft KV hole at ``start + k`` is always
    filled (the write lands past partially-accepting rows' frontiers and
    is invisible, the stale-slot discipline; past the cache end it is
    dropped), so the round has no host-dependent control flow at all.
    Both caches are written in place; the returned dicts hold the same
    K/V tensors under the new ``length``.

    Returns ``(drafts (B, k), preds (B, k+1), accepted (B,),
    emitted_last (B,), cache_t, cache_d)``.
    """
    cache_t = {**cache_t, "length": start}
    cache_d = {**cache_d, "length": start}
    draft_toks, _last, cache_d = decode_chunk(params_d, current, cache_d, cfg_d, k)
    chunk = torch.cat([current[:, None], draft_toks], dim=1)
    logits, cache_t = verify_chunk(params_t, chunk, cache_t, cfg_t)
    preds = logits.argmax(dim=-1)  # (B, k+1)
    # Longest accepted prefix per row: position i counts iff every draft
    # token up to and including i matched the target's pick.
    matches = (draft_toks == preds[:, :k]).to(torch.long)
    accepted = matches.cumprod(dim=1).sum(dim=1)  # (B,)
    picked = preds.take_along_dim(accepted[:, None], dim=1)[:, 0]
    if active is None:
        emitted_last = picked
        advance = accepted + 1
    else:
        emitted_last = torch.where(active, picked, current)
        advance = torch.where(active, accepted + 1, torch.zeros_like(accepted))
    # A scalar (stream) frontier stays a 0-d device tensor.
    new_length = start + (advance[0] if start.ndim == 0 else advance)
    # Draft fill: the draft wrote KV for [current, d1..d_{k-1}] at
    # start..start+k-1; a fully-accepting row needs d_k's KV at start+k
    # (a hole there would make later proposals attend to zeros).  Run
    # the step for EVERY row unconditionally: the write is invisible to
    # rows whose frontier sits below it.
    cache_d = {**cache_d, "length": start + k}
    _, cache_d = decode_step(params_d, draft_toks[:, -1], cache_d, cfg_d)
    cache_t = {**cache_t, "length": new_length}
    cache_d = {**cache_d, "length": new_length}
    return draft_toks, preds, accepted, emitted_last, cache_t, cache_d


def _device_frontier(length, device: torch.device) -> torch.Tensor:
    """A cache length as a device tensor (an upload when it is a host
    int, never a read)."""
    if isinstance(length, torch.Tensor):
        return length
    return torch.tensor(int(length), dtype=torch.long, device=device)


def pack_round(draft_toks, preds, accepted) -> torch.Tensor:
    """The round's three results as one ``(..., 2k + 2)`` tensor, so that
    the host reads them in one copy: drafts, then preds, then the
    accepted count."""
    return torch.cat([draft_toks, preds, accepted[..., None]], dim=-1)


def unpack_round(values, k: int) -> tuple[list[int], list[int], int]:
    """(drafts, preds, accepted) of one row of :func:`pack_round`, read
    to the host."""
    return values[:k], values[k : 2 * k + 1], int(values[2 * k + 1])


@lru_cache(maxsize=32)
def _shared_spec_round_fn(cfg_t, cfg_d, k: int):
    """Memoized single-stream round: the frontier rides the caches' own
    0-d ``length``, so steady-state rounds upload nothing: the round's
    kernels in, one packed read out."""

    def spec_round(params_t, params_d, current, cache_t, cache_d):
        with dispatch_range("spec_round", current, k):
            start = _device_frontier(cache_t["length"], current.device)
            return _spec_round_core(
                params_t, params_d, current, cache_t, cache_d,
                start, None, k, cfg_t, cfg_d,
            )

    return spec_round


@lru_cache(maxsize=32)
def _shared_spec_round_batch_fn(cfg_t, cfg_d, k: int):
    """Memoized batched round: per-row ``(B,)`` frontiers and the active
    mask are re-imposed by the host each round (finished rows freeze),
    so they arrive as explicit arguments."""

    def spec_round_batch(
        params_t, params_d, current, cache_t, cache_d, start, active
    ):
        with dispatch_range("spec_round_batch", current, k):
            return _spec_round_core(
                params_t, params_d, current, cache_t, cache_d,
                start, active, k, cfg_t, cfg_d,
            )

    return spec_round_batch


@lru_cache(maxsize=32)
def _shared_spec_multi_round_fn(cfg_t, cfg_d, k: int, rounds: int):
    """Memoized MULTI-round function: ``rounds`` consecutive batched
    speculative rounds chained on the device with no read in between.

    The front-door engine reads after every dispatch (emission and
    admission need the host); chaining rounds amortizes that read over
    ``rounds * (k+1)`` tokens per slot.  The frontier chain is purely
    device-side: round ``r+1`` starts from round ``r``'s ``new_length``
    (carried in the caches' own ``length``).  Semantics per active row
    are EXACTLY ``rounds`` sequential :func:`_spec_round_core` calls; a
    row that finishes mid-dispatch keeps decoding garbage for the
    remaining sub-rounds (the parked-lane discipline: its writes past
    the cache end are dropped, and the host discards tokens past
    EOS/budget exactly as it would across two dispatches).

    Returns stacked ``(drafts (B, rounds, k), preds (B, rounds, k+1),
    accepted (B, rounds))`` plus the final carries.
    """

    def spec_multi_round(
        params_t, params_d, current, cache_t, cache_d, start, active
    ):
        with dispatch_range("spec_multi_round", current, k, rounds):
            return _chain(params_t, params_d, current, cache_t, cache_d, start, active)

    def _chain(params_t, params_d, current, cache_t, cache_d, start, active):
        drafts_all, preds_all, accepted_all = [], [], []
        for _ in range(rounds):
            draft_toks, preds, accepted, current, cache_t, cache_d = (
                _spec_round_core(
                    params_t, params_d, current, cache_t, cache_d,
                    start, active, k, cfg_t, cfg_d,
                )
            )
            start = cache_t["length"]
            drafts_all.append(draft_toks)
            preds_all.append(preds)
            accepted_all.append(accepted)
        return (
            torch.stack(drafts_all, dim=1),
            torch.stack(preds_all, dim=1),
            torch.stack(accepted_all, dim=1),
            current,
            cache_t,
            cache_d,
        )

    return spec_multi_round


def zero_cache(cache: dict) -> None:
    """Put a cache's K/V back to the zeros it was allocated with."""
    for side in ("k", "v"):
        for leaf, _ in kv_leaf_pairs(cache[side], cache[side]):
            leaf.zero_()


class _RoundState:
    """A speculative engine's buffers for one dispatch shape: caches of
    ``batch`` rows on both models, ``current``, and for the batched round
    the staged frontiers and mask; ``dispatch`` runs the round over them.
    Every request loads whole caches, so the capture's warm-up leaves
    nothing behind that a round could read."""

    def __init__(self, engine: "SpeculativeEngine", batch: int | None):
        t, d = engine.target, engine.draft
        dev = engine.device
        rows = 1 if batch is None else batch
        self.cache_t = init_kv_cache(t.cfg, rows, kv_dtype=t.kv_dtype, device=dev, tp=t.tp)
        self.cache_d = init_kv_cache(d.cfg, rows, kv_dtype=d.kv_dtype, device=dev, tp=d.tp)
        self.current = torch.zeros((rows,), dtype=torch.long, device=dev)
        if batch is None:
            # One stream: the frontier rides the caches as a 0-d tensor.
            self.frontier = torch.ones((), dtype=torch.long, device=dev)
            self.cache_t["length"] = self.frontier
            self.cache_d["length"] = self.frontier
            module, key, body = "spec_round", "spec_round:1", self._stream_body
        else:
            self.start = StagedInput((rows,), torch.long, dev)
            self.active = StagedInput((rows,), torch.bool, dev)
            module, key, body = "spec_round_batch", f"spec_round_batch:{rows}", self._batch_body
        self._engine = weakref.proxy(engine)  # the engine holds the state
        self.dispatch = GraphedDispatch(
            body, module, (self.current, engine.k), dev, key, owner=engine,
            pool=engine._graph_pool, compile_events=t.compile_events,
        )

    def _stream_body(self) -> torch.Tensor:
        e = self._engine
        d, p, a, cur, ct, _cd = e._round(
            e.target.params, e.draft.params, self.current, self.cache_t, self.cache_d
        )
        self.current.copy_(cur)
        self.frontier.copy_(ct["length"])
        return pack_round(d, p, a)[0]

    def _batch_body(self) -> torch.Tensor:
        e = self._engine
        d, p, a, cur, _ct, _cd = e._round_batch(
            e.target.params, e.draft.params, self.current, self.cache_t,
            self.cache_d, self.start.tensor, self.active.tensor,
        )
        self.current.copy_(cur)
        return pack_round(d, p, a)

    def load(self, cache_t: dict, cache_d: dict, current: torch.Tensor) -> None:
        """Take a request's freshly ingested caches and first tokens."""
        copy_cache(self.cache_t, cache_t)
        copy_cache(self.cache_d, cache_d)
        self.current.copy_(current)


def joint_prompt_ids(
    target: ServeEngine, draft: ServeEngine, prompt: str,
    prefix: str | None = None,
) -> tuple[list[int], list[int]]:
    """(prefix_ids, suffix_ids) both engines must ingest IDENTICALLY.

    The ONE definition of two-engine prompt truncation: target and draft
    caches desync (and the exactness guarantee dies) unless both ingest
    the same id sequence, so the cap is the JOINT KV capacity, ``min``
    of the two ``max_seq_len``s, minus the prefill token and one decode
    slot.  Plain prompts come back as ``([], ids)``; prefix requests
    split exactly as :func:`tpuslo_torch.models.serve.prefix_prompt_ids`
    does, so prefix streams stay identical to the target-only prefix
    streams.  Shared by :class:`SpeculativeEngine` and the front-door
    engine.
    """
    joint_seq = min(target.cfg.max_seq_len, draft.cfg.max_seq_len)
    if prefix:
        return prefix_prompt_ids(prefix, prompt, joint_seq)
    return [], encode_bytes(prompt, max(1, joint_seq - 2))


def _rehome_draft_cache(target: ServeEngine, draft: ServeEngine, cache_d):
    """The draft's KV cache where the round will use it.

    In the JAX package this replicates an unsharded draft's cache onto a
    sharded target's mesh.  In the port every tp rank holds a replica of
    an unsharded draft on its own device (:func:`_check_pair`), so the
    cache is already where the round reads it."""
    return cache_d


def _check_pair(target: ServeEngine, draft: ServeEngine) -> None:
    if target.device != draft.device:
        raise ValueError(
            f"target serves on {target.device}, draft on {draft.device}; "
            "a speculative pair shares one device"
        )
    t_mesh, d_mesh = getattr(target, "mesh", None), getattr(draft, "mesh", None)
    if d_mesh is not None and d_mesh is not t_mesh:
        raise ValueError("a sharded draft must share the target's mesh")
    if target.device.type == "cuda" and t_mesh is not None and not t_mesh.graph_capturable:
        raise ValueError(
            f"speculative rounds replay CUDA graphs, which cannot capture collectives "
            f"that go through host memory ({t_mesh}): serve over NCCL on the card, or "
            "over gloo on the CPU"
        )


class SpeculativeEngine:
    """Greedy speculative serving over two :class:`ServeEngine`s.

    ``target`` and ``draft`` must share the tokenizer (they do: the byte
    tokenizer is model-independent) and the device, which the engine
    takes from them; the draft should be a much smaller config for real
    speedup, but any pair is *correct*.
    """

    def __init__(self, target: ServeEngine, draft: ServeEngine, k: int = 4):
        if k < 1:
            raise ValueError("k must be >= 1")
        _check_pair(target, draft)
        self.target = target
        self.draft = draft
        self.device = target.device
        self.k = k
        self._round = _shared_spec_round_fn(target.cfg, draft.cfg, k)
        self._round_batch = _shared_spec_round_batch_fn(
            target.cfg, draft.cfg, k
        )
        self.rounds = 0
        self.accepted_draft_tokens = 0
        self.emitted_tokens = 0
        # Buffers and graphs per dispatch shape (None: one stream; B: a
        # batch bucket), built at their first use, like a jit's compile.
        self._states: dict[int | None, _RoundState] = {}
        self._graph_pool = (
            torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        )

    def _state(self, batch: int | None) -> _RoundState:
        state = self._states.get(batch)
        if state is None:
            state = self._states[batch] = _RoundState(self, batch)
        return state

    def _dispatch(self, state: _RoundState) -> torch.Tensor:
        """One round over ``state``'s buffers: its packed output."""
        return state.dispatch()

    def _target_step(self, params, token, cache):
        return decode_step(params, token, cache, self.target.cfg)

    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens per proposed draft token."""
        proposed = self.rounds * self.k
        return self.accepted_draft_tokens / proposed if proposed else 0.0

    def generate(
        self,
        prompt: str,
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        prefix: str | None = None,
    ) -> list[int]:
        """Greedy generation; returns the emitted token ids.

        Exactness guarantee (tested): the stream equals greedy decoding
        of the *target model alone* for as many tokens as the KV budget
        allows.  Near capacity the engine falls back to plain
        single-token target steps, so the guarantee holds all the way to
        the last free cache slot.
        """
        return list(
            self.stream(
                prompt, max_new_tokens, stop_at_eos=stop_at_eos,
                prefix=prefix,
            )
        )

    def stream(
        self,
        prompt: str,
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        prefix: str | None = None,
    ):
        """Generator form of :meth:`generate`: tokens yield as emitted
        (the first right after the target prefill, then 1..k+1 per
        round), so a streaming server's TTFT measures prefill latency.

        ``prefix`` mirrors :meth:`ServeEngine.generate`'s prefix
        semantics (same id-level truncation rules, so the stream is
        identical to the target-only prefix stream).  Both engines
        ingest ``prefix + suffix`` as one sequence.
        """
        t, d = self.target, self.draft
        # Both engines must ingest the IDENTICAL id sequence or their
        # caches desync, so encode once with the joint cap (NOT minus k:
        # the tail fallback handles prompts too long for a speculative
        # round, and extra truncation would break exactness vs the
        # target-only stream near capacity).
        prefix_ids, suffix_ids = joint_prompt_ids(t, d, prompt, prefix)
        ids = prefix_ids + suffix_ids

        logits_t, cache_t = t._ingest_ids(ids)
        _logits_d, cache_d = d._ingest_ids(ids)
        cache_d = _rehome_draft_cache(t, d, cache_d)
        # Same emission budget the target-only engine would grant, so
        # the streams are identical at every capacity.
        max_new_tokens = max(
            1,
            min(
                max_new_tokens,
                t.decode_cap_tokens(len(ids)),
                d.decode_cap_tokens(len(ids)),
            ),
        )

        current = logits_t.argmax(dim=-1)  # (1,)
        state = self._state(None)
        state.load(cache_t, cache_d, current)
        first = int(_HostRead(current).values()[0])
        emitted_count = 1
        self.emitted_tokens += 1
        yield first
        if (stop_at_eos and first == EOS) or max_new_tokens <= 1:
            return

        # Budget: each round writes k+1 target KV slots from `start`.
        # The host tracks a MIRROR of the frontier (from the accepted
        # counts it already reads) purely for loop bounds; the device
        # carries the real one in the state's 0-d frontier, set once
        # here, so steady-state rounds upload nothing and read one
        # packed tensor.
        start = len(ids)
        state.frontier.fill_(start)
        limit = min(t.cfg.max_seq_len, d.cfg.max_seq_len) - (self.k + 1)
        k = self.k
        while emitted_count < max_new_tokens and start < limit:
            # One device read per round: proposals, target picks and
            # the device-computed accepted count, packed.
            drafts, picks, n = unpack_round(
                _HostRead(self._dispatch(state)).values(), k
            )
            emitted = [int(x) for x in drafts[:n]] + [int(picks[n])]

            self.rounds += 1
            self.accepted_draft_tokens += n
            start += n + 1
            for token in emitted:
                emitted_count += 1
                self.emitted_tokens += 1
                yield int(token)
                if stop_at_eos and token == EOS:
                    return
                if emitted_count >= max_new_tokens:
                    break

        # Tail: fewer than k+1 free KV slots left; finish with plain
        # single-token target decode so near-capacity requests still
        # match the target-only greedy stream instead of stopping early.
        # It runs eagerly on the state's cache from the device frontier.
        current = state.current
        cache_t = {**state.cache_t, "length": state.frontier}
        while (
            emitted_count < max_new_tokens
            and start < t.cfg.max_seq_len - 1
        ):
            logits, cache_t = self._target_step(t.params, current, cache_t)
            current = logits.argmax(dim=-1)
            start += 1
            emitted_count += 1
            self.emitted_tokens += 1
            value = int(_HostRead(current).values()[0])
            yield value
            if stop_at_eos and value == EOS:
                return

    def generate_batch(
        self,
        prompts: list[str],
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        batch_buckets: tuple[int, ...] = (1, 2, 4, 8),
        prefix: str | None = None,
    ) -> list[list[int]]:
        """Batched speculative decoding: one stream per prompt, each
        identical to the target-only greedy stream.

        Rows verify from their OWN cache frontiers (the vector-length
        :func:`tpuslo_torch.models.llama.verify_chunk` path), so per-row
        acceptance counts diverge freely while every device call stays
        fixed-shape.  Per round the whole batch pays ONE draft chunk,
        ONE verify and ONE draft fill step; rows that accepted fewer
        draft tokens simply advance their frontier less.
        """
        if not prompts:
            return []
        t, d = self.target, self.draft
        if len(prompts) > batch_buckets[-1]:
            # Oversized requests split into largest-bucket sub-batches
            # (the ServeEngine.generate_batch discipline).
            cap = batch_buckets[-1]
            outputs: list[list[int]] = []
            for i in range(0, len(prompts), cap):
                outputs.extend(
                    self.generate_batch(
                        prompts[i : i + cap],
                        max_new_tokens=max_new_tokens,
                        stop_at_eos=stop_at_eos,
                        batch_buckets=batch_buckets,
                        prefix=prefix,
                    )
                )
            return outputs
        # Shared truncation helper: per-row streams must equal the
        # target-only prefix streams id for id (both engines re-prefill
        # prefix+suffix, as in stream()).
        ids = []
        for p in prompts:
            prefix_ids, suffix_ids = joint_prompt_ids(t, d, p, prefix)
            ids.append(prefix_ids + suffix_ids)
        n_real = len(ids)
        # Pad the batch to a bucket so that each shape runs once; pad
        # rows start done.
        B = _bucket(n_real, batch_buckets)
        ids = ids + [[ids[0][0]]] * (B - n_real)

        logits_t, cache_t = t._prefill_rows(ids, 0)
        _logits_d, cache_d = d._prefill_rows(ids, 0)
        cache_d = _rehome_draft_cache(t, d, cache_d)
        lens = np.asarray([len(row) for row in ids], np.int64)
        # The longest row bounds every row's budget (the same rule as
        # ServeEngine.generate_batch), keeping the loop uniform.
        max_new_tokens = max(
            1,
            min(
                max_new_tokens,
                t.decode_cap_tokens(int(lens.max())),
                d.decode_cap_tokens(int(lens.max())),
            ),
        )

        current = logits_t.argmax(dim=-1)
        state = self._state(B)
        state.load(cache_t, cache_d, current)
        first = _HostRead(current).values()
        outputs = [[int(v)] for v in first]
        done = [
            r >= n_real or (stop_at_eos and outputs[r][-1] == EOS)
            for r in range(B)
        ]
        start = lens.copy()
        limit = min(t.cfg.max_seq_len, d.cfg.max_seq_len) - (self.k + 1)
        k = self.k

        def active_mask() -> np.ndarray:
            return np.asarray(
                [
                    not done[r] and len(outputs[r]) < max_new_tokens
                    for r in range(B)
                ]
            )

        # Loop guards range over ACTIVE rows only, and finished rows'
        # frontiers freeze: a fast-accepting (or done) row must not burn
        # the shared budget and truncate slow rows below their granted
        # max_new_tokens.  Per round the host stages only the
        # re-imposed frontiers and the active mask and reads one packed
        # (drafts, preds, accepted) tensor.
        while True:
            mask = active_mask()
            if not mask.any() or int(start[mask].max()) >= limit:
                break
            state.start.write(start)
            state.active.write(mask)
            rows = _HostRead(self._dispatch(state)).values()
            acc = np.zeros(B, np.int64)
            for r in range(B):
                drafts, picks, n = unpack_round(rows[r], k)
                acc[r] = n
                if not mask[r]:
                    continue
                emitted = [int(v) for v in drafts[:n]] + [int(picks[n])]
                for token in emitted:
                    if done[r] or len(outputs[r]) >= max_new_tokens:
                        break
                    outputs[r].append(token)
                    if stop_at_eos and token == EOS:
                        done[r] = True
                self.rounds += 1
                self.accepted_draft_tokens += n

            # Frontiers advance for active rows only, mirroring the
            # device-side update (frozen rows keep re-decoding their
            # frozen window; outputs ignored).
            start = start + np.where(mask, acc + 1, 0).astype(np.int64)

        # Tail: finish near-capacity rows with plain batched target
        # steps at per-row frontiers, eagerly on the state's cache.
        current = state.current
        cache_t = state.cache_t
        while True:
            mask = active_mask() & (start < t.cfg.max_seq_len - 1)
            if not mask.any():
                break
            cache_t = {**cache_t, "length": _upload(start, torch.long, self.device)}
            logits, cache_t = self._target_step(t.params, current, cache_t)
            current = logits.argmax(dim=-1)
            start = start + np.where(mask, 1, 0).astype(np.int64)
            for r, value in enumerate(_HostRead(current).values()):
                if not mask[r] or len(outputs[r]) >= max_new_tokens:
                    continue
                outputs[r].append(int(value))
                if stop_at_eos and value == EOS:
                    done[r] = True

        self.emitted_tokens += sum(len(o) for o in outputs[:n_real])
        return [o[:max_new_tokens] for o in outputs[:n_real]]
