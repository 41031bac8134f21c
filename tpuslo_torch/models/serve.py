"""Llama serving engine (PyTorch port of ``tpuslo/models/serve.py``).

The same serving shape as the JAX engine: a byte-level tokenizer,
prompts padded to power-of-two prefill buckets, prompts past the largest
bucket ingested as a head prefill plus chunked appends, decode in chunks
over a preallocated KV cache with one host read per chunk, and a FIFO
prefix cache of KV snapshots.

What differs, and why:

* PyTorch runs eagerly, so there is no jit, donation or memoized
  compiled callable.  KV writes happen in place; prefix snapshots are
  cloned before every use so that no request writes into one.
* Dispatching a decode chunk costs host time here (every step's kernels
  are queued from Python), where JAX's dispatch was asynchronous and
  cheap.  ``generate`` therefore reads and yields the first token before
  it queues the first chunk, and chunk N+1 is queued before chunk N is
  read, through a pinned-memory copy and an event, so that the host
  queues while the card computes.
* Sampled decoding draws from ``torch.Generator``s; greedy streams are
  the JAX engine's exactly (tests hold them so).
* Tensor-parallel serving (``mesh=``) and sequence-parallel ingestion
  (``ingest_prompt_sp``) belong to the multi-device slice and raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tpuslo_torch.device import resolve_device, synchronize
from tpuslo_torch.models.kv_cache import kv_map, validate_kv_dtype
from tpuslo_torch.models.llama import (
    GREEDY,
    LlamaConfig,
    SamplingConfig,
    decode_chunk,
    init_kv_cache,
    init_params,
    llama_tiny,
    prefill,
    quantize_params,
    sample_from_logits,
    verify_chunk,
)

BOS = 256
EOS = 257


def suffix_prefill(params, tokens, kv, start: int, true_length, cfg):
    """Append a (padded) suffix to KV already holding ``start`` tokens.

    ``verify_chunk`` scores the suffix against the whole cache (prefix
    KV included) and writes its KV at ``start`` in place; the next-token
    logits are gathered at the suffix's true last position and the
    returned cache has ``length = start + true_length`` (``true_length``
    an int or a per-row tensor).  The write raises if the padded chunk
    would run past the cache end.
    """
    B = tokens.shape[0]
    logits, cache = verify_chunk(
        params, tokens, {"k": kv["k"], "v": kv["v"], "length": int(start)}, cfg
    )
    dev = tokens.device
    if isinstance(true_length, torch.Tensor):
        true_length = true_length.to(device=dev, dtype=torch.long)
        last_pos = true_length - 1
    else:
        true_length = int(true_length)
        last_pos = torch.full((B,), true_length - 1, dtype=torch.long, device=dev)
    last = logits[torch.arange(B, device=dev), last_pos]
    return last, {**cache, "length": int(start) + true_length}


def forced_logits(engine, ids: list[int]) -> torch.Tensor:
    """Next-token f32 logits ``(vocab,)`` after teacher-forcing ``ids``
    through the engine's own prefill path."""
    if len(ids) > engine.prefill_buckets[-1]:
        raise ValueError(
            f"forced sequence of {len(ids)} ids exceeds the largest "
            f"prefill bucket {engine.prefill_buckets[-1]}; parity "
            "checking past one bucket is not supported"
        )
    logits, _cache = engine.prefill_ids(list(ids))
    return logits[0].float()


def _generation_prompt_ids(engine, prompt: str) -> list[int]:
    """The exact prompt ids ``engine.generate`` decodes from."""
    return encode_bytes(prompt, engine.generation_prompt_cap())


def stream_parity(
    candidate,
    reference,
    prompt: str,
    max_new_tokens: int = 6,
    atol: float = 7.5e-2,
) -> dict:
    """Parity of two engines' greedy streams, in logit space.

    Teacher-forces the candidate's tokens through both engines' prefill
    and requires per-position logits within ``atol``; a token divergence
    is accepted only where the reference's top-2 margin is under
    ``2 * atol``, a genuine tie.  The engines may live on different
    devices.  Returns a report dict; ``ok`` is the verdict.
    """
    c_tokens = [
        e.token_id
        for e in candidate.generate(prompt, max_new_tokens, stop_at_eos=False)
    ]
    r_tokens = [
        e.token_id
        for e in reference.generate(prompt, max_new_tokens, stop_at_eos=False)
    ]
    ids = _generation_prompt_ids(reference, prompt)
    if _generation_prompt_ids(candidate, prompt) != ids:
        raise ValueError(
            "engines truncate the prompt differently; parity over "
            "mismatched contexts is meaningless"
        )
    ok = True
    max_diff = 0.0
    diverged_at = None
    tie_margin = None
    for k in range(len(c_tokens)):
        forced = ids + c_tokens[:k]
        lc = forced_logits(candidate, forced).cpu()
        lr = forced_logits(reference, forced).cpu()
        diff = float((lc - lr).abs().max())
        max_diff = max(max_diff, diff)
        if diff >= atol:
            ok = False
        if diverged_at is None and k < len(r_tokens) and c_tokens[k] != r_tokens[k]:
            diverged_at = k
            top2 = torch.sort(lr).values[-2:]
            tie_margin = float(top2[1] - top2[0])
            if tie_margin >= 2 * atol:
                ok = False  # a decisive margin must not flip
    return {
        "ok": ok,
        "tokens_candidate": c_tokens,
        "tokens_reference": r_tokens,
        "max_logit_diff": round(max_diff, 5),
        "diverged_at": diverged_at,
        "tie_margin": None if tie_margin is None else round(tie_margin, 5),
    }


@dataclass
class PrefixEntry:
    """Cached KV snapshot of a shared prompt prefix (system prompt)."""

    text: str
    ids: list[int]
    cache: dict  # full KV snapshot; cloned before every use
    logits: torch.Tensor  # next-token logits after the prefix alone


def prefix_prompt_ids(
    prefix: str, prompt: str, max_seq_len: int
) -> tuple[list[int], list[int]]:
    """The one definition of prefix+suffix id-level truncation:
    (prefix_ids, suffix_ids) exactly as ``cache_prefix`` +
    ``ingest_prompt(prefix=...)`` produce them."""
    prefix_ids = encode_bytes(prefix, max(1, max_seq_len - 3))
    room = max_seq_len - 2 - len(prefix_ids)
    suffix_ids = list(prompt.encode("utf-8"))[: max(0, room)]
    return prefix_ids, suffix_ids


def encode_bytes(text: str, max_len: int) -> list[int]:
    """Byte-level encode with BOS, truncated to max_len."""
    ids = [BOS] + [b for b in text.encode("utf-8")]
    return ids[:max_len]


def decode_bytes(ids: list[int]) -> str:
    return bytes(b for b in ids if 0 <= b < 256).decode("utf-8", errors="replace")


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket holding n; callers truncate to buckets[-1] first."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class TokenEvent:
    token_id: int
    index: int
    ttft_ms: float | None = None


class _HostRead:
    """One device-to-host read of a token tensor, started now and waited
    for later: a copy into pinned memory plus an event, so that work
    queued after it does not delay it (a plain ``.tolist()`` would wait
    for everything queued on the stream)."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def values(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


def _sub_batch_seed(seed: int, index: int) -> int:
    """A seed for sub-batch ``index`` that collides neither with plain
    user seeds nor with other sub-batches' (hashed, not linear)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


class ServeEngine:
    """Greedy or sampled streaming generation with bucketed prefill.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to serve through the plain PyTorch path.
    """

    def __init__(
        self,
        cfg: LlamaConfig | None = None,
        params=None,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128, 256),
        decode_chunk_size: int = 64,
        quantize: bool = False,
        mesh=None,
        kv_dtype: str = "bf16",
        device: str | torch.device = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet; the "
                "port serves on one device"
            )
        self.device = resolve_device(device)
        self.kv_dtype = validate_kv_dtype(kv_dtype)
        self.cfg = cfg or llama_tiny(max_seq_len=512)
        if params is None:
            params = init_params(rng_seed, self.cfg, self.device)
        else:
            embed = params["embed"]
            where = (embed["q"] if isinstance(embed, dict) else embed).device
            if where != self.device:
                raise ValueError(
                    f"params live on {where}, the engine serves on {self.device}"
                )
        if quantize and not isinstance(params.get("output"), dict):
            params = quantize_params(params)
        self.quantized = isinstance(params.get("output"), dict)
        self.params = params
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= self.cfg.max_seq_len
        )
        if not self.prefill_buckets:
            self.prefill_buckets = (self.cfg.max_seq_len,)
        # One host read per chunk of tokens, not per token.  Decode
        # writes start at the prompt's true length, so capacity is per
        # request; one chunk must fit a short-prompt request at all.
        chunk_cap = (self.cfg.max_seq_len - 2) // 2
        self.decode_chunk_size = max(1, min(decode_chunk_size, chunk_cap))
        self.compile_events: list[dict] = []
        # Prefix caching: KV snapshots of shared prompt prefixes keyed by
        # text.  Bounded FIFO: each entry pins a full-size KV buffer.
        self._prefix_cache: dict[str, PrefixEntry] = {}
        # Shapes that have run once: the telemetry records first hits only.
        self._seen_shapes: set[tuple[str, int]] = set()
        self.prefix_cache_max = 4

    def _new_cache(self, batch: int) -> dict:
        return init_kv_cache(self.cfg, batch, kv_dtype=self.kv_dtype, device=self.device)

    def _tokens(self, rows: list[list[int]]) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long, device=self.device)

    def _generator(self, sampling: SamplingConfig, seed: int):
        if sampling.greedy:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

    def warmup(self, bucket: int | None = None) -> float:
        """Run one prefill bucket and one decode chunk (building the
        kernels at first use); returns ms."""
        start = time.perf_counter()
        bucket = bucket or self.prefill_buckets[0]
        tokens = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        logits, cache = prefill(self.params, tokens, self._new_cache(1), self.cfg)
        tok = logits.argmax(dim=-1)
        decode_chunk(self.params, tok, cache, self.cfg, self.decode_chunk_size)
        synchronize(self.device)
        return (time.perf_counter() - start) * 1000.0

    def decode_cap_tokens(self, longest_prompt_len: int) -> int:
        """Token cap :meth:`_decode_budget` grants."""
        chunk = self.decode_chunk_size
        avail = self.cfg.max_seq_len - longest_prompt_len - 1
        if avail < chunk:
            return max(1, avail)
        return max(1, (avail // chunk) * chunk)

    def _decode_budget(self, longest_prompt_len: int) -> tuple[int, int]:
        """(chunk, cap_tokens) for a request whose longest prompt row has
        ``longest_prompt_len`` ids.

        Every chunk writes ``chunk`` KV slots from each row's true
        length, so the budget past the longest prompt is chunk-rounded;
        under one chunk of budget, single-token chunks use the remaining
        slots instead of rounding the request away.
        """
        cap = self.decode_cap_tokens(longest_prompt_len)
        if cap < self.decode_chunk_size:
            return 1, cap
        return self.decode_chunk_size, cap

    def generate_batch(
        self,
        prompts: list[str],
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        batch_buckets: tuple[int, ...] = (1, 2, 4, 8),
        prefix: str | None = None,
        sampling: SamplingConfig | None = None,
        seed: int = 0,
    ) -> list[list[int]]:
        """Batched decode; one list of token ids per prompt.

        All prompts prefill in lockstep chunks (sized by the longest) and
        share one decode stream; per-row prompt lengths ride the vector
        ``cache["length"]`` path.  The batch pads to ``batch_buckets``;
        larger requests split into sub-batches.  ``prefix`` serves a
        shared prefix from the KV prefix cache, tiled across the rows,
        and prefills only the per-row suffixes (which must be non-empty).
        """
        if not prompts:
            return []
        if prefix and any(not p for p in prompts):
            raise ValueError(
                "generate_batch(prefix=...) needs non-empty per-row "
                "suffixes; use generate() for prefix-only requests"
            )
        sampling = sampling or GREEDY
        if len(prompts) > batch_buckets[-1]:
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
                        sampling=sampling,
                        seed=_sub_batch_seed(seed, i // cap + 1),
                    )
                )
            return outputs
        rng = self._generator(sampling, seed)
        if prefix:
            entry = self.cache_prefix(prefix)
            start = len(entry.ids)
            room = self.cfg.max_seq_len - 2 - start
            ids = [list(p.encode("utf-8"))[: max(1, room)] for p in prompts]
        else:
            entry = None
            start = 0
            ids = [encode_bytes(p, max(1, self.cfg.max_seq_len - 2)) for p in prompts]
        n_real = len(ids)
        batch = _bucket(n_real, batch_buckets)
        ids += [[0 if prefix else BOS]] * (batch - n_real)

        lens = [len(row) for row in ids]
        chunk, cap_tokens = self._decode_budget(start + max(lens))
        max_new_tokens = max(1, min(max_new_tokens, cap_tokens))

        if entry is not None:
            def tile(a):
                return a.repeat_interleave(batch, dim=1)

            kv = {"k": kv_map(tile, entry.cache["k"]), "v": kv_map(tile, entry.cache["v"])}
            logits, cache = self._prefill_rows(ids, start, kv=kv)
        else:
            logits, cache = self._prefill_rows(ids, 0)
        token = sample_from_logits(logits, rng, sampling)
        first = _HostRead(token)
        pending = None
        if max_new_tokens > 1:
            toks, token, cache = decode_chunk(
                self.params, token, cache, self.cfg, chunk, sampling, rng
            )
            pending = _HostRead(toks)
        outputs = [[int(t)] for t in first.values()]
        done = [stop_at_eos and t[0] == EOS for t in outputs]

        produced = 1
        while produced < max_new_tokens and not all(done[:n_real]):
            # Queue chunk N+1 before reading chunk N.
            next_read = next_token = None
            if produced + chunk < max_new_tokens:
                next_toks, next_token, cache = decode_chunk(
                    self.params, token, cache, self.cfg, chunk, sampling, rng
                )
                next_read = _HostRead(next_toks)
            for row, values in enumerate(pending.values()):
                for value in values:
                    if done[row] or len(outputs[row]) >= max_new_tokens:
                        break
                    outputs[row].append(int(value))
                    if stop_at_eos and value == EOS:
                        done[row] = True
            produced += chunk
            pending, token = next_read, next_token
        return outputs[:n_real]

    def _prefill_rows(self, rows: list[list[int]], start: int, kv=None):
        """Batched chunked ingestion of encoded rows at scalar ``start``.

        Every row chunk-prefills in lockstep through the bucket shapes;
        each chunk passes per-row true lengths clamped into the chunk,
        each row's next-token logits are kept from the chunk it ends in,
        and the returned cache's ``length`` is the per-row
        ``start + len(row)``.  KV written past a row's true length sits
        above its ``length``: decode masks it and overwrites it.  ``kv``
        carries a tiled prefix snapshot for the prefix path.
        """
        B = len(rows)
        lens = [len(r) for r in rows]
        maxlen = max(lens)
        if start + maxlen > self.cfg.max_seq_len:
            raise ValueError(
                f"{start + maxlen} positions exceed the cache "
                f"({self.cfg.max_seq_len})"
            )
        final_logits = None
        cache = None
        pos = 0
        while pos < maxlen:
            take = min(self.prefill_buckets[-1], maxlen - pos)
            bucket = self._chunk_bucket(take, self.cfg.max_seq_len - (start + pos))
            take = min(take, bucket)
            chunk_rows = [row[pos : pos + take] for row in rows]
            tokens = self._tokens([cr + [0] * (bucket - len(cr)) for cr in chunk_rows])
            tl = torch.tensor(
                [min(max(length - pos, 1), take) for length in lens],
                dtype=torch.long, device=self.device,
            )
            if pos == 0 and start == 0 and kv is None:
                logits, cache = prefill(
                    self.params, tokens, self._new_cache(B), self.cfg, true_length=tl
                )
            else:
                kv_now = kv if pos == 0 else {"k": cache["k"], "v": cache["v"]}
                logits, cache = suffix_prefill(
                    self.params, tokens, kv_now, start + pos, tl, self.cfg
                )
            ends = torch.tensor(
                [pos < length <= pos + take for length in lens], device=self.device
            )
            if final_logits is None:
                final_logits = logits
            else:
                final_logits = torch.where(ends[:, None], logits, final_logits)
            pos += take
        lengths = torch.tensor(lens, dtype=torch.long, device=self.device) + start
        return final_logits, {**cache, "length": lengths}

    def generation_prompt_cap(self) -> int:
        """Max prompt ids :meth:`generate` decodes from."""
        return max(1, self.cfg.max_seq_len - 2)

    def prefill_ids(self, ids: list[int]):
        """Bucketed single-row prefill of already-encoded ids.

        Returns (logits (1, vocab), cache with ``length=len(ids)``).
        """
        bucket = _bucket(len(ids), self.prefill_buckets)
        tokens = self._tokens([ids + [0] * (bucket - len(ids))])
        return prefill(
            self.params, tokens, self._new_cache(1), self.cfg, true_length=len(ids)
        )

    def cache_prefix(self, text: str) -> PrefixEntry:
        """Prefill a shared prefix once; later requests clone its KV and
        prefill only their suffix.  Bounded FIFO eviction."""
        entry = self._prefix_cache.get(text)
        if entry is not None:
            return entry
        ids, _ = prefix_prompt_ids(text, "", self.cfg.max_seq_len)
        logits, cache = self._ingest_ids(ids)
        entry = PrefixEntry(text=text, ids=ids, cache=cache, logits=logits)
        if self.prefix_cache_max > 0:
            while len(self._prefix_cache) >= self.prefix_cache_max:
                self._prefix_cache.pop(next(iter(self._prefix_cache)))
            self._prefix_cache[text] = entry
        return entry

    def _clone_cache(self, cache: dict) -> dict:
        """Fresh buffers, so that in-place writes never reach a snapshot."""
        length = cache["length"]
        return {
            "k": kv_map(torch.clone, cache["k"]),
            "v": kv_map(torch.clone, cache["v"]),
            "length": length.clone() if isinstance(length, torch.Tensor) else length,
        }

    def _chunk_bucket(self, take: int, remaining: int) -> int:
        """Chunk bucket that never crosses the cache end while reusing
        the standard shapes: the natural bucket, else the largest bucket
        that fits, else exactly ``remaining``."""
        bucket = _bucket(take, self.prefill_buckets)
        if bucket <= remaining:
            return bucket
        fitting = [b for b in self.prefill_buckets if b <= remaining]
        return fitting[-1] if fitting else remaining

    def _record_compile(self, kind: str, bucket: int, elapsed_ms: float) -> None:
        """Record the first hit on a shape when it took over 100 ms (the
        JAX engine's compile heuristic; here it catches kernel builds and
        library set-up on the first call of a shape)."""
        first_hit = (kind, bucket) not in self._seen_shapes
        self._seen_shapes.add((kind, bucket))
        if first_hit and elapsed_ms > 100.0:
            self.compile_events.append({"bucket": bucket, "compile_ms": elapsed_ms})

    def _append_ids(self, cache: dict, ids: list[int], start: int):
        """Chunk-prefill ``ids`` into a cache holding ``start`` tokens,
        each chunk padded to a prefill bucket that fits the cache.
        Returns (next-token logits, cache)."""
        logits = None
        pos = 0
        while pos < len(ids):
            take = min(self.prefill_buckets[-1], len(ids) - pos)
            bucket = self._chunk_bucket(take, self.cfg.max_seq_len - (start + pos))
            take = min(take, bucket)
            chunk = ids[pos : pos + take] + [0] * (bucket - take)
            first_hit = ("suffix", bucket) not in self._seen_shapes
            if first_hit:
                synchronize(self.device)  # time this chunk alone
            t0 = time.perf_counter()
            logits, cache = suffix_prefill(
                self.params, self._tokens([chunk]),
                {"k": cache["k"], "v": cache["v"]}, start + pos, take, self.cfg,
            )
            if first_hit:
                synchronize(self.device)
                self._record_compile(
                    "suffix", bucket, (time.perf_counter() - t0) * 1000.0
                )
            pos += take
        return logits, cache

    def _ingest_ids(self, ids: list[int]):
        """Head prefill on the largest bucket + chunked appends, with
        first-hit timing."""
        head = ids[: self.prefill_buckets[-1]]
        head_bucket = _bucket(len(head), self.prefill_buckets)
        first_hit = ("prefill", head_bucket) not in self._seen_shapes
        t0 = time.perf_counter()
        logits, cache = self.prefill_ids(head)
        if first_hit:
            synchronize(self.device)
            self._record_compile(
                "prefill", head_bucket, (time.perf_counter() - t0) * 1000.0
            )
        if len(ids) > len(head):
            logits, cache = self._append_ids(cache, ids[len(head):], len(head))
        return logits, cache

    def ingest_ids(
        self,
        ids: list[int],
        prefix: str | None = None,
        prefix_ids: list[int] | None = None,
    ):
        """Id-level ingestion: (next-token logits, single-row cache
        holding ``len(ids)`` tokens).  Never encodes or truncates.  When
        ``prefix``/``prefix_ids`` name a leading span of ``ids`` that this
        engine's cached truncation produced exactly, the snapshot is
        cloned and only the tail prefills."""
        if prefix and prefix_ids:
            entry = self.cache_prefix(prefix)
            if entry.ids == prefix_ids and ids[: len(prefix_ids)] == prefix_ids:
                tail = ids[len(prefix_ids):]
                cache = self._clone_cache(entry.cache)
                if not tail:
                    return entry.logits, cache
                return self._append_ids(cache, tail, len(prefix_ids))
        return self._ingest_ids(ids)

    def prefix_warm(self, prefix: str) -> bool:
        """True when ``prefix`` already has a KV snapshot cached."""
        return prefix in self._prefix_cache

    def ingest_prompt(self, prompt: str, prefix: str | None = None):
        """(logits, single-row cache, total_len) for a text prompt: a head
        prefill on the largest bucket plus chunked appends, or, with
        ``prefix``, a clone of the cached prefix KV plus the suffix."""
        if prefix:
            entry = self.cache_prefix(prefix)
            _, suffix_ids = prefix_prompt_ids(prefix, prompt, self.cfg.max_seq_len)
            total_len = len(entry.ids) + len(suffix_ids)
            cache = self._clone_cache(entry.cache)
            if suffix_ids:
                logits, cache = self._append_ids(cache, suffix_ids, len(entry.ids))
            else:
                logits = entry.logits
        else:
            ids = encode_bytes(prompt, max(1, self.cfg.max_seq_len - 2))
            total_len = len(ids)
            logits, cache = self._ingest_ids(ids)
        return logits, cache, total_len

    def ingest_prompt_sp(self, prompt: str, sp_mesh, axis_name: str = "sp",
                         pad_quantum: int = 64):
        """Sequence-parallel ingestion belongs to the multi-device slice."""
        raise NotImplementedError(
            "ingest_prompt_sp (sequence-parallel prefill) is not ported yet; "
            "use ingest_prompt"
        )

    def generate(
        self,
        prompt: str,
        max_new_tokens: int = 32,
        stop_at_eos: bool = True,
        sampling: SamplingConfig | None = None,
        seed: int = 0,
        prefix: str | None = None,
    ) -> Iterator[TokenEvent]:
        """Decode one TokenEvent per generated token.

        Greedy by default; ``sampling`` selects temperature/top-k/top-p
        sampling, reproducible by ``seed``.  The first token comes from
        the prefill logits; it is read and yielded (with its TTFT) before
        the first decode chunk is queued.  ``prefix`` names a shared
        prompt prefix served from the KV prefix cache.
        """
        sampling = sampling or GREEDY
        rng = self._generator(sampling, seed)
        request_start = time.perf_counter()
        logits, cache, total_len = self.ingest_prompt(prompt, prefix)
        chunk, cap_tokens = self._decode_budget(total_len)
        max_new_tokens = max(1, min(max_new_tokens, cap_tokens))

        token = sample_from_logits(logits, rng, sampling)
        first = int(token[0])
        yield TokenEvent(first, 0, ttft_ms=(time.perf_counter() - request_start) * 1000.0)
        if (stop_at_eos and first == EOS) or max_new_tokens <= 1:
            return

        toks, last, cache = decode_chunk(
            self.params, token, cache, self.cfg, chunk, sampling, rng
        )
        pending = _HostRead(toks[0])
        idx = 1
        while idx < max_new_tokens:
            # Queue chunk N+1 from the on-device last token of chunk N
            # (only when tokens beyond this chunk are still needed), then
            # read chunk N.
            next_read = next_last = None
            if idx + chunk < max_new_tokens:
                next_toks, next_last, cache = decode_chunk(
                    self.params, last, cache, self.cfg, chunk, sampling, rng
                )
                next_read = _HostRead(next_toks[0])
            for value in pending.values():
                yield TokenEvent(int(value), idx)
                idx += 1
                if stop_at_eos and value == EOS:
                    return
                if idx >= max_new_tokens:
                    return
            pending, last = next_read, next_last
