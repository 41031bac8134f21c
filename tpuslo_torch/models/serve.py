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
* A front door's admissions go through the engine's
  :class:`AdmissionGraphs` (on a card one CUDA graph replay per prefill
  piece over staged storage, where JAX jits every prefill); the engine's
  own calls stay eager.  Both cut a prompt into chunks by one
  :meth:`ServeEngine._schedule`.
* Tensor-parallel serving (``mesh=``, a mesh with a ``tp`` axis over an
  initialized process group, :mod:`tpuslo_torch.parallel.mesh`) runs one
  engine per tp rank, each holding its rank's shards
  (:class:`~tpuslo_torch.models.llama.ShardedParams`) and a cache of its
  ``n_kv_heads / tp`` heads; every rank runs the same calls in the same
  order (the layers' collectives pair up across ranks), and every rank
  gathers the whole logits and samples the same tokens.  With
  ``params=None`` the weights are drawn leaf by leaf and each rank keeps
  only its shard, as JAX's sharded init does.  A front door's
  admissions replay CUDA graphs, which cannot capture collectives that
  go through host memory (gloo with CUDA tensors): such a mesh is
  refused there.
* Sequence-parallel ingestion (``ingest_prompt_sp``, a mesh with an
  ``sp`` axis) runs on an engine without a tp mesh on every sp rank: the
  ring prefill is split over the ranks, and each rank's engine gets the
  whole dense cache and decodes alone.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tpuslo_torch.device import resolve_device, synchronize
from tpuslo_torch.models.bridge import shard_leaf, shard_serve_params
from tpuslo_torch.models.graphs import GraphedDispatch, StagedInput, copy_cache
from tpuslo_torch.models.kv_cache import kv_map, validate_kv_dtype
from tpuslo_torch.models.llama import (
    GREEDY,
    LlamaConfig,
    SamplingConfig,
    ShardedParams,
    _quantize_leaf,
    _set_leaf,
    decode_chunk,
    init_kv_cache,
    init_leaves,
    init_params,
    kv_cache_bytes,
    llama_tiny,
    prefill,
    quantize_params,
    sample_from_logits,
    verify_chunk,
)
from tpuslo_torch.otel.xla_spans import dispatch_range

BOS = 256
EOS = 257


def suffix_prefill(params, tokens, kv, start, true_length, cfg):
    """Append a (padded) suffix to KV already holding ``start`` tokens.

    ``verify_chunk`` scores the suffix against the whole cache (prefix
    KV included), with a prefill's weight products, and writes its KV at
    ``start`` in place; the next-token
    logits are gathered at the suffix's true last position and the
    returned cache has ``length = start + true_length`` (``true_length``
    an int or a per-row tensor).  ``start`` is a Python int, whose write
    raises if the padded chunk would run past the cache end, or a 0-d
    device tensor, whose positions and cache writes the card computes
    (one CUDA graph then serves every start: :class:`AdmissionGraphs`);
    both give the same bits.
    """
    B = tokens.shape[0]
    if not isinstance(start, torch.Tensor):
        start = int(start)
    logits, cache = verify_chunk(
        params, tokens, {"k": kv["k"], "v": kv["v"], "length": start}, cfg,
        prompt_chunk=True,
    )
    dev = tokens.device
    if isinstance(true_length, torch.Tensor):
        true_length = true_length.to(device=dev, dtype=torch.long)
        last_pos = true_length - 1
    else:
        true_length = int(true_length)
        last_pos = torch.full((B,), true_length - 1, dtype=torch.long, device=dev)
    last = logits[torch.arange(B, device=dev), last_pos]
    return last, {**cache, "length": start + true_length}


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
    for everything queued on the stream).  ``reads`` counts every read
    started, in the whole process: tests and the smoke run take its
    difference over a round to show one read per dispatch."""

    reads = 0
    #: Called at every read when set (the serving benches' audit).
    on_read = None

    def __init__(self, t: torch.Tensor):
        _HostRead.reads += 1
        if _HostRead.on_read is not None:
            _HostRead.on_read()
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            with torch.cuda.device(t.device):
                self._event.record()
        else:
            self._host, self._event = t, None

    def values(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


def _to_device(tree, device: torch.device):
    """A (nested dict) tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _upload(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values (a list or a numpy array) as a new tensor on
    ``device``, never a view of ``values``.  To a card the copy goes
    from pinned memory and does not make the host wait, so a serving
    step can hand the device its per-slot frontiers and masks without a
    synchronizing call."""
    host = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _sub_batch_seed(seed: int, index: int) -> int:
    """A seed for sub-batch ``index`` that collides neither with plain
    user seeds nor with other sub-batches' (hashed, not linear)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def check_serving_mesh(mesh, cfg) -> int:
    """The tp degree of a serving mesh, with the JAX engine's
    ``ValueError``s: a mesh without a ``tp`` axis, a tp that does not
    divide ``n_heads`` and ``n_kv_heads``.  The port also needs tp to
    divide the FFN width and the vocabulary (its shards are contiguous)
    and the tp axis to span the mesh."""
    if "tp" not in mesh.axis_names:
        raise ValueError(f"serving mesh must have a 'tp' axis, got {mesh.axis_names}")
    tp = mesh.shape["tp"]
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} "
            f"and n_heads={cfg.n_heads} (pick a larger config "
            "or a smaller tp)"
        )
    if cfg.ffn_dim % tp or cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide ffn_dim={cfg.ffn_dim} and "
                         f"vocab_size={cfg.vocab_size}")
    if mesh.plan.n_devices != tp:
        raise ValueError(f"a serving mesh shards over tp alone, got {mesh.shape}")
    return tp


def sharded_init_params(rng_seed: int, cfg: LlamaConfig, mesh, quantize: bool) -> ShardedParams:
    """This tp rank's shards of ``init_params(rng_seed, cfg)`` (quantized
    leaf by leaf when ``quantize``), drawn one leaf at a time on the
    mesh's device: no rank holds the whole tree."""
    tp, rank = mesh.shape["tp"], mesh.rank("tp")
    tree: dict = {}
    for path, leaf in init_leaves(rng_seed, cfg, mesh.device):
        if quantize and not path.endswith("norm"):
            leaf = _quantize_leaf(leaf)
        _set_leaf(tree, path, shard_leaf(path, leaf, tp, rank))
        del leaf
    return ShardedParams(tree, mesh)


class ServeEngine:
    """Greedy or sampled streaming generation with bucketed prefill.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to serve through the plain PyTorch path.  With
    ``mesh`` the engine is one tp rank's and serves on the mesh's device.
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
        self.kv_dtype = validate_kv_dtype(kv_dtype)
        self.cfg = cfg or llama_tiny(max_seq_len=512)
        self.mesh = mesh
        self.tp = 1 if mesh is None else check_serving_mesh(mesh, self.cfg)
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and params is None:
            params = sharded_init_params(rng_seed, self.cfg, mesh, quantize)
        elif mesh is not None:
            if quantize and not isinstance(params.get("output"), dict):
                params = quantize_params(params)
            shards = shard_serve_params(params, self.tp, mesh.rank("tp"))
            params = ShardedParams(_to_device(shards, self.device), mesh)
        elif params is None:
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
        self._admission: AdmissionGraphs | None = None

    def _new_cache(self, batch: int) -> dict:
        return init_kv_cache(self.cfg, batch, kv_dtype=self.kv_dtype, device=self.device,
                             tp=self.tp)

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
            toks, token, cache = self._decode_chunk(token, cache, chunk, sampling, rng)
            pending = _HostRead(toks)
        outputs = [[int(t)] for t in first.values()]
        done = [stop_at_eos and t[0] == EOS for t in outputs]

        produced = 1
        while produced < max_new_tokens and not all(done[:n_real]):
            # Queue chunk N+1 before reading chunk N.
            next_read = next_token = None
            if produced + chunk < max_new_tokens:
                next_toks, next_token, cache = self._decode_chunk(
                    token, cache, chunk, sampling, rng
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

    def _decode_chunk(self, token, cache, chunk: int, sampling, rng):
        """One decode chunk: a single dispatch in a profiler capture."""
        with dispatch_range("decode_chunk", token, chunk):
            return decode_chunk(self.params, token, cache, self.cfg, chunk, sampling, rng)

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
        for pos, take, bucket in self._schedule(maxlen, start):
            chunk_rows = [row[pos : pos + take] for row in rows]
            tokens = self._tokens([cr + [0] * (bucket - len(cr)) for cr in chunk_rows])
            tl = torch.tensor(
                [min(max(length - pos, 1), take) for length in lens],
                dtype=torch.long, device=self.device,
            )
            if pos == 0 and start == 0 and kv is None:
                with dispatch_range("prefill", tokens):
                    logits, cache = prefill(
                        self.params, tokens, self._new_cache(B), self.cfg, true_length=tl
                    )
            else:
                kv_now = kv if pos == 0 else {"k": cache["k"], "v": cache["v"]}
                with dispatch_range("suffix_prefill", tokens):
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
        with dispatch_range("prefill", tokens):
            return prefill(
                self.params, tokens, self._new_cache(1), self.cfg, true_length=len(ids)
            )

    def cache_prefix(self, text: str, ingest=None) -> PrefixEntry:
        """Prefill a shared prefix once; later requests clone its KV and
        prefill only their suffix.  Bounded FIFO eviction.  ``ingest``
        (an admission's :meth:`AdmissionGraphs.ingest`, which returns
        staged storage) prefills in place of :meth:`_ingest_ids`, and the
        entry keeps a copy of what it returns."""
        entry = self._prefix_cache.get(text)
        if entry is not None:
            return entry
        ids, _ = prefix_prompt_ids(text, "", self.cfg.max_seq_len)
        if ingest is None:
            logits, cache = self._ingest_ids(ids)
        else:
            logits, cache = ingest(ids)
            cache = self._clone_cache(cache)
        entry = PrefixEntry(text=text, ids=ids, cache=cache, logits=logits)
        if self.prefix_cache_max > 0:
            while len(self._prefix_cache) >= self.prefix_cache_max:
                self._prefix_cache.pop(next(iter(self._prefix_cache)))
            self._prefix_cache[text] = entry
        return entry

    def admission_graphs(self, batch_buckets: tuple[int, ...]) -> "AdmissionGraphs":
        """The engine's :class:`AdmissionGraphs` for admission batches of
        ``batch_buckets`` rows, built (and on a card captured) at the
        first call and kept: a later front door over this engine
        captures nothing.  A call for a batch bucket the held ones lack
        builds them all anew over larger staged storage (each such
        capture of a held key is a recapture).  The pieces return what the
        engine's eager path returns, bit for bit, but in staged storage
        that the next admission overwrites."""
        held = self._admission
        if held is None or not set(batch_buckets) <= set(held.batch_buckets):
            buckets = tuple(sorted(set(batch_buckets)
                                   | set(held.batch_buckets if held else ())))
            self._admission = None  # free the old staged storage first
            del held
            self._admission = AdmissionGraphs(self, buckets)
        return self._admission

    def _clone_cache(self, cache: dict) -> dict:
        """Fresh buffers, so that in-place writes never reach a snapshot."""
        length = cache["length"]
        return {
            "k": kv_map(torch.clone, cache["k"]),
            "v": kv_map(torch.clone, cache["v"]),
            "length": length.clone() if isinstance(length, torch.Tensor) else length,
        }

    def _schedule(self, longest: int, start: int = 0) -> list[tuple[int, int, int]]:
        """(pos, take, bucket) of each chunk that ingests ``longest`` ids
        into a cache holding ``start``: the largest bucket's worth at a
        time, each padded to a bucket that fits the cache
        (:meth:`_chunk_bucket`)."""
        chunks = []
        pos = 0
        while pos < longest:
            take = min(self.prefill_buckets[-1], longest - pos)
            bucket = self._chunk_bucket(take, self.cfg.max_seq_len - (start + pos))
            take = min(take, bucket)
            chunks.append((pos, take, bucket))
            pos += take
        return chunks

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
        for pos, take, bucket in self._schedule(len(ids), start):
            chunk = ids[pos : pos + take] + [0] * (bucket - take)
            first_hit = ("suffix", bucket) not in self._seen_shapes
            if first_hit:
                synchronize(self.device)  # time this chunk alone
            t0 = time.perf_counter()
            tokens = self._tokens([chunk])
            with dispatch_range("suffix_prefill", tokens):
                logits, cache = suffix_prefill(
                    self.params, tokens,
                    {"k": cache["k"], "v": cache["v"]}, start + pos, take, self.cfg,
                )
            if first_hit:
                synchronize(self.device)
                self._record_compile(
                    "suffix", bucket, (time.perf_counter() - t0) * 1000.0
                )
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
        """Long-prompt ingestion over a sequence-parallel mesh.

        :meth:`ingest_prompt` ingests past the largest bucket by serial
        chunked appends; this path runs one
        :func:`tpuslo_torch.models.sp_serve.sp_prefill` over the mesh (ring
        attention, O(S / p) activations per rank) and installs the KV into
        an ordinary dense cache, so decode continues on the engine's normal
        loop.  Same return contract as :meth:`ingest_prompt`: (logits,
        single-row cache, total_len).  Every rank of the mesh calls it with
        the same prompt, each on its own engine.

        The padded length snaps to ``axis_size * pad_quantum`` (the
        bucketed-prefill discipline), clipped to the largest sp-aligned
        length the cache holds.  bf16 dense caches only: the handoff
        targets the single-device decode path.
        """
        if self.mesh is not None or self.kv_dtype != "bf16" or self.quantized:
            raise ValueError(
                "ingest_prompt_sp targets the single-device bf16 decode "
                "path; serve tp/int8 engines through ingest_prompt"
            )
        from tpuslo_torch.models.sp_serve import sp_prefill_into_cache

        n_sp = sp_mesh.shape[axis_name]
        quantum = n_sp * pad_quantum
        ids = encode_bytes(prompt, max(1, self.cfg.max_seq_len - 2))
        total_len = len(ids)
        # Snap to the quantum ladder, clipped to the largest sp-aligned
        # length the cache can hold.
        aligned_cap = (self.cfg.max_seq_len // n_sp) * n_sp
        padded = min(-(-total_len // quantum) * quantum, aligned_cap)
        if padded < total_len:
            raise ValueError(
                f"cfg.max_seq_len={self.cfg.max_seq_len} cannot hold a "
                f"{total_len}-id prompt at sp axis {n_sp} (aligned "
                f"capacity {aligned_cap})"
            )
        tokens = self._tokens([ids + [0] * (padded - total_len)])
        with dispatch_range("sp_prefill", tokens):
            logits, cache = sp_prefill_into_cache(
                self.params, tokens, self._new_cache(1), self.cfg, sp_mesh,
                axis_name=axis_name, true_length=total_len,
            )
        return logits, cache, total_len

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

        toks, last, cache = self._decode_chunk(token, cache, chunk, sampling, rng)
        pending = _HostRead(toks[0])
        idx = 1
        while idx < max_new_tokens:
            # Queue chunk N+1 from the on-device last token of chunk N
            # (only when tokens beyond this chunk are still needed), then
            # read chunk N.
            next_read = next_last = None
            if idx + chunk < max_new_tokens:
                next_toks, next_last, cache = self._decode_chunk(
                    last, cache, chunk, sampling, rng
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


class _PrefillPiece:
    """A cold prefill of ``B`` rows at bucket ``S``, written into the first
    ``B`` rows of the engine's staged cache (one row: its staged row).
    Its inputs, the tokens and each row's true length, are views of one
    staged buffer: one copy from the host per replay."""

    def __init__(self, graphs: "AdmissionGraphs", B: int, S: int, owner, compile_events):
        dev = graphs.device
        self.params, self.cfg = graphs.params, graphs.cfg
        self.B, self.S = B, S
        self.staged = StagedInput((B * S + B,), torch.long, dev)
        self.tokens = self.staged.tensor[:B * S].view(B, S)
        self.lengths = self.staged.tensor[B * S:]
        self.lengths.fill_(1)
        self.cache = graphs.rows_view(B)
        self.run = GraphedDispatch(
            self.body, "prefill", (self.tokens,), dev, f"prefill:{B}x{S}",
            owner=owner, pool=graphs.pool, compile_events=compile_events,
        )

    def body(self) -> torch.Tensor:
        with dispatch_range("prefill", self.tokens):
            logits, _ = prefill(self.params, self.tokens, self.cache, self.cfg,
                                true_length=self.lengths)
        return logits

    def __call__(self, tokens: np.ndarray, lengths: list[int]) -> torch.Tensor:
        self.staged.write(np.concatenate([tokens.reshape(-1), lengths]))
        return self.run()


class _SuffixPiece:
    """One prompt chunk of bucket ``S`` appended to the engine's staged row
    at a staged 0-d start.  Its inputs, the tokens, the start and the
    chunk's true length, are views of one staged buffer."""

    def __init__(self, graphs: "AdmissionGraphs", S: int, owner, compile_events):
        dev = graphs.device
        self.params, self.cfg = graphs.params, graphs.cfg
        self.S = S
        self.staged = StagedInput((S + 2,), torch.long, dev)
        self.tokens = self.staged.tensor[:S].view(1, S)
        self.start = self.staged.tensor[S]
        self.length = self.staged.tensor[S + 1:]
        self.length.fill_(1)
        self.cache = graphs.row
        self.run = GraphedDispatch(
            self.body, "suffix_prefill", (self.tokens,), dev, f"suffix_prefill:{S}",
            owner=owner, pool=graphs.pool, compile_events=compile_events,
        )

    def body(self) -> torch.Tensor:
        with dispatch_range("suffix_prefill", self.tokens):
            logits, _ = suffix_prefill(self.params, self.tokens, self.cache,
                                       self.start, self.length, self.cfg)
        return logits

    def __call__(self, tokens: list[int], start: int, length: int) -> torch.Tensor:
        staged = np.zeros(self.S + 2, np.int64)
        staged[:len(tokens)] = tokens
        staged[self.S:] = (start, length)
        self.staged.write(staged)
        return self.run()


class AdmissionGraphs:
    """A front door's admissions on one engine: each prefill piece one
    CUDA graph replay on a card (the JAX engine jits every prefill).

    The pieces, captured when the first front door over the engine is
    built (:meth:`ServeEngine.admission_graphs`), then kept:

    * a cold prefill per (batch bucket B, prefill bucket S), writing the
      first B rows of one staged cache of the largest batch bucket (B 1:
      the staged row), with each row's true length staged;
    * a suffix chunk per prefill bucket S on one staged row, at a staged
      0-d start (:func:`suffix_prefill`): a warm prefix admission, the
      chunks past the head of a long prompt, a snapshot-restored
      request's teacher forcing.

    Inputs are refilled through :class:`~tpuslo_torch.models.graphs.StagedInput`
    (no synchronizing call).  A front door admits through these methods
    rather than the engine's.  Every method
    returns what the engine's eager path returns for the same request
    (:meth:`prefill_rows` is ``_prefill_rows(rows, 0)``, :meth:`ingest`
    is ``_ingest_ids``, :meth:`ingest_ids` is ``ingest_ids``), bit for
    bit: a replay runs the eager body's kernels.  A batched
    admission runs the chunks past its head for each row that reaches
    them, alone on the staged row: a lone chunk's products and K2's lanes
    give a row the bits it has in a batch, and rows that ended earlier
    no longer run pad chunks.  A chunk whose bucket is no prefill bucket
    (a remainder at the cache end, :meth:`ServeEngine._chunk_bucket`)
    runs eagerly, counted in ``eager_chunks``.

    The returned caches are views of staged storage, and a logits
    tensor a piece returns is the graph's: the next admission on this
    engine overwrites both.  Callers copy what they keep (the front door
    injects the rows into its pools at once; the prefix cache clones its
    snapshot, :meth:`ServeEngine.cache_prefix`).  On the CPU every piece
    runs its body eagerly over the same staged storage.
    """

    def __init__(self, engine: ServeEngine, batch_buckets: tuple[int, ...]):
        cuda = engine.device.type == "cuda"
        if cuda and engine.mesh is not None and not engine.mesh.graph_capturable:
            raise ValueError(
                f"a front door's admissions replay CUDA graphs, which cannot capture "
                f"collectives that go through host memory ({engine.mesh}): serve over "
                "NCCL on the card, or over gloo on the CPU"
            )
        self._engine = weakref.proxy(engine)  # the engine holds the graphs
        self.params, self.cfg, self.device = engine.params, engine.cfg, engine.device
        self.prefill_buckets = engine.prefill_buckets
        self.batch_buckets = tuple(batch_buckets)
        widest = self.batch_buckets[-1]
        kv = engine.kv_dtype
        #: Staged KV bytes: the row, and the batch rows when a bucket has more than one.
        tp = engine.tp
        self.staged_bytes = kv_cache_bytes(self.cfg, 1 + (widest if widest > 1 else 0), kv, tp)
        self.row = init_kv_cache(self.cfg, 1, kv_dtype=kv, device=self.device, tp=tp)
        self.rows = (init_kv_cache(self.cfg, widest, kv_dtype=kv, device=self.device, tp=tp)
                     if widest > 1 else None)
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.eager_chunks = 0
        reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
        t0 = time.perf_counter()
        events = engine.compile_events
        self.prefills = {(B, S): _PrefillPiece(self, B, S, engine, events)
                         for B in self.batch_buckets for S in self.prefill_buckets}
        self.suffixes = {S: _SuffixPiece(self, S, engine, events) for S in self.prefill_buckets}
        #: Graphs captured, their milliseconds, and the device memory the
        #: captures reserved (the graphs' pool), all 0 on the CPU.
        self.captures = sum(p.run.graph is not None
                            for p in (*self.prefills.values(), *self.suffixes.values()))
        self.capture_ms = (time.perf_counter() - t0) * 1000.0 if cuda else 0.0
        self.pool_bytes = (torch.cuda.memory_reserved(self.device) - reserved) if cuda else 0

    def rows_view(self, B: int) -> dict:
        """The staged cache a B-row piece writes (its first B rows)."""
        if B == 1:
            return self.row

        def head(a):
            return a[:, :B]

        return {"k": kv_map(head, self.rows["k"]), "v": kv_map(head, self.rows["v"])}

    def _row_of(self, cache: dict, b: int) -> dict:
        def one(a):
            return a[:, b:b + 1]

        return {"k": kv_map(one, cache["k"]), "v": kv_map(one, cache["v"])}

    def _suffix(self, ids: list[int], start: int, bucket: int, length: int) -> torch.Tensor:
        """Append one chunk of ``ids`` at ``start`` to the staged row."""
        piece = self.suffixes.get(bucket)
        if piece is not None:
            return piece(ids, start, length)
        self.eager_chunks += 1
        tokens = self._engine._tokens([ids + [0] * (bucket - len(ids))])
        with dispatch_range("suffix_prefill", tokens):
            logits, _ = suffix_prefill(self.params, tokens, self.row, start, length, self.cfg)
        return logits

    def _prefill(self, rows: list[list[int]]) -> tuple[torch.Tensor, dict]:
        """Logits (a copy) and the staged K/V of ``_prefill_rows(rows, 0)``."""
        lens = [len(r) for r in rows]
        if max(lens) > self.cfg.max_seq_len:
            raise ValueError(
                f"{max(lens)} positions exceed the cache ({self.cfg.max_seq_len})"
            )
        B = len(rows)
        chunks = self._engine._schedule(max(lens))
        _, take, S = chunks[0]
        head = self.prefills[(B, S)]
        tokens = np.zeros((B, S), np.int64)
        for b, r in enumerate(rows):
            tokens[b, :min(len(r), take)] = r[:take]
        logits = head(tokens, [min(max(n, 1), take) for n in lens]).clone()
        for b, n in enumerate(lens):
            if n <= take:
                continue
            if B > 1:
                copy_cache(self.row, self._row_of(head.cache, b))
            for pos, take_c, S_c in chunks[1:]:
                if pos >= n:
                    break
                last = self._suffix(rows[b][pos:pos + take_c], pos, S_c,
                                    min(n - pos, take_c))
            logits[b:b + 1].copy_(last)
            if B > 1:
                copy_cache(self._row_of(head.cache, b), self.row)
        return logits, head.cache

    def prefill_rows(self, rows: list[list[int]]) -> tuple[torch.Tensor, dict]:
        """A batched cold admission of ``rows`` (a batch bucket of them):
        ``ServeEngine._prefill_rows(rows, 0)``."""
        logits, kv = self._prefill(rows)
        lengths = _upload([len(r) for r in rows], torch.long, self.device)
        return logits, {**kv, "length": lengths}

    def ingest(self, ids: list[int]) -> tuple[torch.Tensor, dict]:
        """``ServeEngine._ingest_ids``: a head prefill and chunked appends."""
        logits, kv = self._prefill([ids])
        return logits, {**kv, "length": len(ids)}

    def _append(self, ids: list[int], start: int) -> tuple[torch.Tensor, dict]:
        """``ServeEngine._append_ids`` into the staged row, which holds
        ``start`` tokens."""
        last = None
        for pos, take, bucket in self._engine._schedule(len(ids), start):
            last = self._suffix(ids[pos:pos + take], start + pos, bucket, take)
        return last, {"k": self.row["k"], "v": self.row["v"], "length": start + len(ids)}

    def ingest_ids(self, ids: list[int], prefix: str | None = None,
                   prefix_ids: list[int] | None = None) -> tuple[torch.Tensor, dict]:
        """``ServeEngine.ingest_ids``: a warm prefix's snapshot is copied
        into the staged row (no new cache) and only the tail prefills; a
        cold prefix is ingested here and the engine's prefix cache keeps
        a copy (:meth:`ServeEngine.cache_prefix`)."""
        if prefix and prefix_ids:
            entry = self._engine.cache_prefix(prefix, ingest=self.ingest)
            if entry.ids == prefix_ids and ids[: len(prefix_ids)] == prefix_ids:
                tail = ids[len(prefix_ids):]
                copy_cache(self.row, entry.cache)
                if not tail:
                    return entry.logits, {"k": self.row["k"], "v": self.row["v"],
                                          "length": entry.cache["length"]}
                return self._append(tail, len(prefix_ids))
        return self.ingest(ids)
