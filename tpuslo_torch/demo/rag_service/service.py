"""RAG demo service internals (the port of ``demo/rag_service/service.py``).

Reference parity map (``demo/rag-service/main.go``):
  * pluggable ``llmBackend`` (stub | llama_cpp)  → stub | torch
    (``torch``, ``torch_spec``, ``torch_moe``, ``torch_batched``: the
    port's engines, on the card unless ``device="cpu"``)
  * ``/chat`` NDJSON streaming with warmup+cadence → same wire format
  * ``simulateRetrieval`` seeded DNS/net/vectordb sleeps → same
  * inline ``EnrichDNSAttributes`` self-correlation demo → same, via
    :class:`tpuslo_torch.otel.processor.correlator.Correlator`
  * Prometheus histograms ``llm_slo_ttft_ms`` etc. → same series names

The model backends take the JAX demo's ``TPUSLO_SERVE_*`` knobs.  Each
serves in this one process on one device: ``TPUSLO_SERVE_TP`` or
``TPUSLO_SERVE_EP`` above 1 raises, naming the visible devices (tp and
ep serving run one rank per process, through the engines' ``mesh=``
inside :func:`tpuslo_torch.parallel.mesh.run_ranks`).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Iterator

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

from tpuslo_torch import semconv
from tpuslo_torch.correlation.matcher import SignalRef, SpanRef
from tpuslo_torch.otel.processor.correlator import Correlator
from tpuslo_torch.slo.calculator import RetrievalBreakdown

# --- request profiles ---------------------------------------------------
# (dns_ms, network_ms, vectordb_ms, max_new_tokens, warmup_ms, cadence_ms)
PROFILES: dict[str, tuple[float, float, float, int, float, float]] = {
    "chat_short": (2, 6, 10, 24, 40, 12),
    "rag_medium": (4, 14, 30, 48, 80, 16),
    "context_long": (6, 22, 60, 64, 220, 22),
    "context_128k": (8, 30, 120, 64, 900, 30),
}

LLAMA_MODELS = ("llama_tiny", "llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b")
MIXTRAL_MODELS = ("mixtral_tiny", "mixtral_2b6", "mixtral_8x7b")


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ms": (self.end_ns - self.start_ns) / 1e6,
            "attributes": self.attributes,
        }


class SpanRecorder:
    """In-process tracer: ring buffer of finished spans + JSONL sink."""

    def __init__(self, capacity: int = 512, sink=None):
        self._spans: list[Span] = []
        self._capacity = capacity
        self._lock = threading.Lock()
        self._sink = sink

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                self._spans = self._spans[-self._capacity:]
        if self._sink is not None:
            self._sink.write(json.dumps(span.to_dict()) + "\n")
            self._sink.flush()

    def recent(self, n: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self._spans[-n:]]


class StubBackend:
    """Deterministic token stream with warmup + cadence pacing.

    Reference: the stub ``llmBackend`` that CI pins for determinism
    (``demo/llama-cpp/README.md:22-24``).
    """

    name = "stub"
    WORDS = (
        "the", "model", "served", "from", "tpu", "pods", "streams",
        "tokens", "with", "stable", "cadence", "and", "low", "latency",
    )

    def generate(
        self, prompt: str, max_new_tokens: int, warmup_ms: float, cadence_ms: float
    ) -> Iterator[str]:
        # crc32, not hash(): hash() is salted per process and would break
        # the cross-run determinism CI relies on.
        rng = random.Random(zlib.crc32(prompt.encode()))
        time.sleep(warmup_ms / 1000.0)
        for _ in range(max_new_tokens):
            yield self.WORDS[rng.randrange(len(self.WORDS))]
            time.sleep(cadence_ms / 1000.0)


def _one_device(knob: str, width: int, device) -> None:
    """Refuse a tp or ep width above 1: the demo serves in one process
    on one device."""
    import torch

    if device.type == "cuda":
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        seen = f"{len(names)} visible: " + ", ".join(
            f"cuda:{i} ({n})" for i, n in enumerate(names))
    else:
        seen = "the CPU"
    raise ValueError(
        f"{knob}={width} but the demo serves in one process on one device "
        f"({device}; {seen}); tp and ep serving run one rank per process through "
        "the engines' mesh= (tpuslo_torch.parallel.mesh.run_ranks)"
    )


def _batched_env_config():
    """(paged, kv_dtype) from the batching-engine TPUSLO_SERVE_* knobs —
    parsed here, next to the other serve knobs, so they mean the same
    thing for every backend that grows a batched path."""
    return (
        os.environ.get("TPUSLO_SERVE_PAGED", "") == "1",
        os.environ.get("TPUSLO_SERVE_KV", "bf16"),
    )


def _serve_env_config(device: str = "cuda"):
    """(cfg, device, quantize) from the TPUSLO_SERVE_* env knobs and the
    serving device (``resolve_device``'s: raises without a card unless
    ``device="cpu"``).  Shared by every Llama demo backend so the knobs
    mean the same thing everywhere."""
    from tpuslo_torch.device import resolve_device

    dev = resolve_device(device)
    tp = int(os.environ.get("TPUSLO_SERVE_TP", "0") or 0)
    if tp > 1:
        _one_device("TPUSLO_SERVE_TP", tp, dev)
    cfg = None
    model = os.environ.get("TPUSLO_SERVE_MODEL", "")
    if model:
        from tpuslo_torch.models import llama

        if model not in LLAMA_MODELS:
            hint = (
                " (mixtral_* configs serve via --backend torch_moe)"
                if model.startswith("mixtral")
                else ""
            )
            raise ValueError(
                f"TPUSLO_SERVE_MODEL={model!r}: expected one of {LLAMA_MODELS}{hint}"
            )
        cfg = getattr(llama, model)()
    quantize = os.environ.get("TPUSLO_SERVE_INT8", "") == "1"
    return cfg, dev, quantize


def _sampling_env_config():
    """SamplingConfig from TPUSLO_SERVE_TEMPERATURE / _TOP_K / _TOP_P,
    or None (greedy) when none are set.  Shared by the torch backends so
    the knobs mean the same thing everywhere."""
    temp = os.environ.get("TPUSLO_SERVE_TEMPERATURE", "")
    top_k = os.environ.get("TPUSLO_SERVE_TOP_K", "")
    top_p = os.environ.get("TPUSLO_SERVE_TOP_P", "")
    if not (temp or top_k or top_p):
        return None
    from tpuslo_torch.models.llama import SamplingConfig

    return SamplingConfig(
        temperature=float(temp or 1.0),
        top_k=int(top_k or 0),
        top_p=float(top_p or 1.0),
    )


def _first_layers(layers: dict, n: int) -> dict:
    """The first ``n`` layers of a stacked layer tree (int8 leaves are
    ``{"q", "s"}`` dicts, each stacked the same way)."""
    return {
        name: ({k: v[:n] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[:n])
        for name, leaf in layers.items()
    }


class TorchBackend:
    """Llama decode via :class:`tpuslo_torch.models.serve.ServeEngine`."""

    name = "torch"

    def __init__(self, engine=None, device: str = "cuda"):
        if engine is None:
            from tpuslo_torch.models.serve import ServeEngine

            cfg, dev, quantize = _serve_env_config(device)
            engine = ServeEngine(cfg=cfg, quantize=quantize, device=dev)
            engine.warmup()
        self.engine = engine
        self.sampling = _sampling_env_config()
        # Resolved once like every other TPUSLO_SERVE_* knob: the
        # shared system prompt rides the KV prefix cache, so its
        # prefill cost is paid once, not per request.
        self.system_prompt = os.environ.get("TPUSLO_SYSTEM_PROMPT") or None

    def generate(
        self, prompt: str, max_new_tokens: int, warmup_ms: float, cadence_ms: float
    ) -> Iterator[str]:
        del warmup_ms, cadence_ms  # real compute sets the pace
        for event in self.engine.generate(
            prompt, max_new_tokens=max_new_tokens, prefix=self.system_prompt,
            sampling=self.sampling,
        ):
            yield f"tok{event.token_id}"


class TorchSpecBackend:
    """Speculative serving behind the demo: a depth-pruned draft
    proposes, the full target verifies — the stream is identical to
    the target-only greedy stream, so this backend changes LATENCY
    only (and is therefore a clean A/B for the toolkit's TTFT SLIs).

    Honesty note: the latency WIN requires trained weights (layer-skip
    drafts track trained targets; truncating a random-init model's
    depth decorrelates its features).  On random weights this backend
    exercises the machinery and the identical-stream contract, not the
    speedup.

    Knobs: the usual ``TPUSLO_SERVE_MODEL`` / ``TPUSLO_SERVE_INT8``
    pick the target; ``TPUSLO_SERVE_SPEC_K`` (default 4) sets the
    proposal depth; ``TPUSLO_SERVE_DRAFT_LAYERS`` overrides the
    draft's depth (default: half the target's layers).
    """

    name = "torch_spec"

    def __init__(self, engine=None, device: str = "cuda"):
        if engine is None:
            from dataclasses import replace

            from tpuslo_torch.models.serve import ServeEngine
            from tpuslo_torch.models.speculative import SpeculativeEngine

            cfg, dev, quantize = _serve_env_config(device)
            target = ServeEngine(cfg=cfg, quantize=quantize, device=dev)
            target.warmup()
            t_cfg = target.cfg
            draft_layers = int(
                os.environ.get("TPUSLO_SERVE_DRAFT_LAYERS", "0") or 0
            ) or max(1, t_cfg.n_layers // 2)
            if not 1 <= draft_layers <= t_cfg.n_layers:
                raise ValueError(
                    f"TPUSLO_SERVE_DRAFT_LAYERS={draft_layers} outside "
                    f"[1, {t_cfg.n_layers}]"
                )
            # TRUE depth-pruned self-speculation: the draft reuses the
            # target's embeddings/output head and its FIRST draft_layers
            # transformer layers (views of the stacked leaves) — an
            # independently initialized small model would agree with the
            # target at chance level and make speculation strictly slower.
            draft_params = {
                **target.params,
                "layers": _first_layers(target.params["layers"], draft_layers),
            }
            draft = ServeEngine(
                cfg=replace(t_cfg, n_layers=draft_layers),
                params=draft_params, device=dev,
            )
            draft.warmup()
            k = int(os.environ.get("TPUSLO_SERVE_SPEC_K", "4") or 4)
            engine = SpeculativeEngine(target, draft, k=k)
        self.engine = engine
        # Same shared-system-prompt semantics as the other torch
        # backends: the speculative stream with prefix= matches the
        # target-only prefix stream id-for-id.
        self.system_prompt = os.environ.get("TPUSLO_SYSTEM_PROMPT") or None

    def generate(
        self, prompt: str, max_new_tokens: int, warmup_ms: float, cadence_ms: float
    ) -> Iterator[str]:
        del warmup_ms, cadence_ms  # real compute sets the pace
        for token_id in self.engine.stream(
            prompt, max_new_tokens=max_new_tokens, prefix=self.system_prompt
        ):
            yield f"tok{token_id}"


class TorchMoEBackend:
    """Second model family behind the same demo: Mixtral-class MoE via
    :class:`tpuslo_torch.models.mixtral.MoEServeEngine` (greedy streaming)."""

    name = "torch_moe"

    def __init__(self, engine=None, device: str = "cuda"):
        if engine is None:
            from tpuslo_torch.device import resolve_device
            from tpuslo_torch.models import mixtral
            from tpuslo_torch.models.mixtral import MoEServeEngine

            cfg = None
            model = os.environ.get("TPUSLO_SERVE_MODEL", "")
            if model:
                # Same env knob as the llama backends; mixtral_* names
                # route here.  Anything else is a wrong-backend mistake —
                # silently serving the tiny default would hand out
                # toy-model latency numbers.
                if model not in MIXTRAL_MODELS:
                    hint = (
                        " (llama_* configs serve via --backend torch|torch_batched)"
                        if model.startswith("llama")
                        else ""
                    )
                    raise ValueError(
                        f"TPUSLO_SERVE_MODEL={model!r}: expected one of "
                        f"{MIXTRAL_MODELS}{hint}"
                    )
                cfg = getattr(mixtral, model)()
            tp = int(os.environ.get("TPUSLO_SERVE_TP", "0") or 0)
            ep = int(os.environ.get("TPUSLO_SERVE_EP", "0") or 0)
            if tp > 1 and ep > 1:
                raise ValueError(
                    "set TPUSLO_SERVE_TP or TPUSLO_SERVE_EP, not both "
                    "(MoE serving takes a single-axis mesh)"
                )
            dev = resolve_device(device)
            if tp > 1 or ep > 1:
                _one_device("TPUSLO_SERVE_TP" if tp > 1 else "TPUSLO_SERVE_EP",
                            max(tp, ep), dev)
            engine = MoEServeEngine(cfg=cfg, device=dev)
            engine.warmup()
        self.engine = engine

    def generate(
        self, prompt: str, max_new_tokens: int, warmup_ms: float, cadence_ms: float
    ) -> Iterator[str]:
        del warmup_ms, cadence_ms  # real compute sets the pace
        for event in self.engine.generate(prompt, max_new_tokens=max_new_tokens):
            yield f"tok{event.token_id}"


class TorchBatchedBackend:
    """Continuous-batching backend: concurrent requests share one slot
    pool (:class:`tpuslo_torch.models.batching.ContinuousBatchingEngine`,
    or with ``TPUSLO_SERVE_PAGED=1`` the paged pool,
    :class:`~tpuslo_torch.models.paged_kv.PagedBatchingEngine`, which
    composes with ``TPUSLO_SERVE_KV=int8``; ``TPUSLO_PAGED_PALLAS=1``
    switches its decode attention to the paged kernel, K2).

    Handler threads cooperate on one lock: whoever holds it advances
    the whole batch one step, so simultaneous requests ride the same
    weight-bandwidth-bound decode dispatches.  Tokens stream per decode
    step via ``partial_tokens`` so TTFT and tokens/s reflect the real
    decode cadence (a completion-time burst would make the tokens/s SLI
    meaningless).
    """

    name = "torch_batched"

    def __init__(self, engine=None, max_slots: int = 4, device: str = "cuda"):
        if engine is None:
            cfg, dev, quantize = _serve_env_config(device)
            paged, kv_dtype = _batched_env_config()
            if paged:
                # Paged pool: concurrency decoupled from max_seq_len at
                # equal KV memory; composes with int8 KV.
                from tpuslo_torch.models.paged_kv import PagedBatchingEngine

                engine_cls = PagedBatchingEngine
            else:
                from tpuslo_torch.models.batching import ContinuousBatchingEngine

                engine_cls = ContinuousBatchingEngine
            engine = engine_cls(
                cfg=cfg, max_slots=max_slots, quantize=quantize,
                kv_dtype=kv_dtype, device=dev,
            )
            # Front-load the prefill-bucket and per-row decode first
            # calls (TorchBackend's warmup() equivalent).
            engine.submit("warmup", max_new_tokens=2, stop_at_eos=False)
            engine.run()
            engine.results.clear()
        self.engine = engine
        self._lock = threading.Lock()
        self._last_stats: dict[str, float] = dict(engine.stats())
        self.system_prompt = os.environ.get("TPUSLO_SYSTEM_PROMPT") or None

    def scheduler_stats(self) -> dict[str, float]:
        """Engine scheduler stats for the /metrics scrape path.

        The engine's host-side bookkeeping is mutated under the step
        lock, which a handler thread can hold for seconds (a cold
        prefill bucket).  A scrape must not miss its timeout exactly
        while the service is busy, so this tries the lock briefly and
        falls back to the last-known snapshot — stale-but-present beats
        absent for the SLIs this exports.
        """
        if self._lock.acquire(timeout=0.05):
            try:
                self._last_stats = dict(self.engine.stats())
            finally:
                self._lock.release()
        return self._last_stats

    def generate(
        self, prompt: str, max_new_tokens: int, warmup_ms: float, cadence_ms: float
    ) -> Iterator[str]:
        del warmup_ms, cadence_ms  # real compute sets the pace
        with self._lock:
            rid = self.engine.submit(
                prompt,
                max_new_tokens=max_new_tokens,
                stop_at_eos=True,
                prefix=self.system_prompt,
            )
        emitted = 0
        try:
            while True:
                with self._lock:
                    done = rid in self.engine.results
                    tokens = self.engine.partial_tokens(rid)
                    if tokens is None:
                        # Another thread's step() raised mid-admission
                        # and dropped our request: surface it, don't
                        # spin.
                        raise RuntimeError(
                            f"request {rid} lost by the batching engine "
                            "(admission failure in a concurrent step?)"
                        )
                    if done:
                        self.engine.results.pop(rid)
                    elif len(tokens) == emitted:
                        self.engine.step()
                        tokens = self.engine.partial_tokens(rid) or tokens
                        done = rid in self.engine.results
                        if done:
                            self.engine.results.pop(rid)
                for token in tokens[emitted:]:
                    yield f"tok{token}"
                emitted = len(tokens)
                if done:
                    return
        finally:
            # Client disconnects close this generator mid-stream
            # (GeneratorExit at a yield): release the slot/queue entry
            # and any unowned result so ghosts don't accumulate.
            with self._lock:
                self.engine.cancel(rid)


BACKENDS = {
    "stub": StubBackend,
    "torch": TorchBackend,
    "torch_batched": TorchBatchedBackend,
    "torch_moe": TorchMoEBackend,
    "torch_spec": TorchSpecBackend,
}


class DemoMetrics:
    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        buckets_ms = (25, 50, 100, 200, 400, 800, 1600, 3200)
        self.ttft_ms = Histogram(
            "llm_slo_ttft_ms", "Time to first token (ms)",
            buckets=buckets_ms, registry=self.registry,
        )
        self.request_latency_ms = Histogram(
            "llm_slo_request_latency_ms", "Full request latency (ms)",
            buckets=buckets_ms, registry=self.registry,
        )
        self.tokens_per_sec = Histogram(
            "llm_slo_tokens_per_sec", "Decode throughput",
            buckets=(1, 5, 10, 20, 40, 80, 160), registry=self.registry,
        )
        self.retrieval_ms = Histogram(
            "llm_slo_retrieval_latency_ms", "Simulated retrieval latency (ms)",
            buckets=(5, 10, 25, 50, 100, 250), registry=self.registry,
        )
        # The LLMSLOCorrelationDegraded alert watches this: it must
        # track the confidence of every span<->signal join the service
        # performs, not exist only as a span attribute.  Labeled so no
        # series exists before the first join — an unlabeled gauge
        # exports 0.0 from startup and would fire the avg()<0.70 alert
        # on a healthy idle service.
        self.correlation_confidence = Gauge(
            "llm_slo_correlation_confidence",
            "Confidence of the latest kernel-signal span correlation",
            ["signal"],
            registry=self.registry,
        )
        self.requests = Counter(
            "llm_slo_requests_total", "Requests", ["profile", "backend"],
            registry=self.registry,
        )
        # Serving-scheduler SLIs (batched backends): one labeled gauge
        # refreshed from ``engine.stats()`` at scrape time, so every
        # stat the engine publishes (occupancy, queue depth, paged
        # block utilization, shared-prefix reuse, ...) becomes a series
        # without this class chasing the engines' telemetry surface.
        self.engine_stat = Gauge(
            "llm_slo_engine_stat",
            "Batching-engine scheduler stat (labeled by stats() key)",
            ["stat"],
            registry=self.registry,
        )
        self.errors = Counter(
            "llm_slo_requests_errors_total", "Request errors",
            registry=self.registry,
        )


@dataclass
class ChatResult:
    request_id: str
    trace_id: str
    tokens: list[str]
    ttft_ms: float
    latency_ms: float
    tokens_per_sec: float
    retrieval: RetrievalBreakdown
    correlation_attrs: dict[str, float]


class RagService:
    """Backend-agnostic chat pipeline; HTTP layer lives in server.py."""

    def __init__(
        self,
        backend=None,
        metrics: DemoMetrics | None = None,
        recorder: SpanRecorder | None = None,
        seed: int = 42,
        service_name: str = "rag-service",
        node: str = "tpu-vm-0",
        sleep=time.sleep,
        vector_store=None,
    ):
        self.backend = backend or StubBackend()
        self.metrics = metrics or DemoMetrics()
        self.recorder = recorder or SpanRecorder()
        self.correlator = Correlator()
        self.seed = seed
        self.service_name = service_name
        self.node = node
        self._sleep = sleep
        # Optional tpuslo_torch.demo.vectordb.VectorStore: the vectordb
        # retrieval phase becomes a measured search instead of a seeded
        # sleep.
        self.vector_store = vector_store

    def refresh_engine_stats(self) -> dict[str, float]:
        """Pull the backend's scheduler stats into the labeled gauge.

        Called by the /metrics handler at scrape time so Prometheus
        sees the CURRENT queue depth / occupancy / pool state, not a
        snapshot from the last completed request.  Backends without a
        batching engine (stub, single-request torch) export nothing.
        """
        stats_fn = getattr(self.backend, "scheduler_stats", None)
        if stats_fn is None:
            return {}
        stats = {
            k: float(v)
            for k, v in stats_fn().items()
            if isinstance(v, (int, float))
        }
        for key, value in stats.items():
            self.metrics.engine_stat.labels(stat=key).set(value)
        return stats

    def _simulate_retrieval(
        self, profile: str, request_seed: int, query: str = ""
    ) -> tuple[RetrievalBreakdown, list]:
        """Seeded DNS/network sleeps; vectordb phase is a seeded sleep
        by default, or a *measured* search when a vector store is
        attached.

        Reference: ``demo/rag-service/main.go:641-671`` (all-simulated).
        """
        dns_ms, net_ms, vdb_ms, *_ = PROFILES[profile]
        rng = random.Random(self.seed ^ request_seed)
        jitter = lambda v: v * rng.uniform(0.8, 1.2)  # noqa: E731
        dns = jitter(dns_ms)
        net = jitter(net_ms)
        hits: list = []
        if self.vector_store is not None and len(self.vector_store):
            self._sleep((dns + net) / 1000.0)
            t0 = time.perf_counter()
            hits = self.vector_store.search(query or "llm slo", k=3)
            vdb = (time.perf_counter() - t0) * 1000.0
        else:
            vdb = jitter(vdb_ms)
            self._sleep((dns + net + vdb) / 1000.0)
        return RetrievalBreakdown(dns_ms=dns, network_ms=net, vectordb_ms=vdb), hits

    def chat(self, query: str, profile: str = "rag_medium") -> Iterator[dict]:
        """Run one chat request; yields NDJSON-able event dicts.

        Event stream: {"type":"token",...}* then {"type":"summary",...}.
        """
        if profile not in PROFILES:
            raise ValueError(f"unknown profile {profile!r}")
        _, _, _, max_new, warmup_ms, cadence_ms = PROFILES[profile]
        request_id = f"req-{uuid.uuid4().hex[:12]}"
        trace_id = uuid.uuid4().hex
        request_seed = int(trace_id[:8], 16)
        self.metrics.requests.labels(profile=profile, backend=self.backend.name).inc()

        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        root = Span("chat.request", trace_id, uuid.uuid4().hex[:16], start_ns=t0_ns)

        # --- retrieval span --------------------------------------------
        retr_span = Span(
            "chat.retrieval", trace_id, uuid.uuid4().hex[:16],
            parent_span_id=root.span_id, start_ns=time.time_ns(),
        )
        retrieval, hits = self._simulate_retrieval(profile, request_seed, query)
        retr_span.end_ns = time.time_ns()
        retr_span.attributes = {
            semconv.ATTR_RETRIEVAL_DNS_MS: retrieval.dns_ms,
            semconv.ATTR_RETRIEVAL_NETWORK_MS: retrieval.network_ms,
            semconv.ATTR_RETRIEVAL_VECTORDB_MS: retrieval.vectordb_ms,
        }
        if hits:
            retr_span.attributes["retrieval.doc_ids"] = ",".join(
                h.doc_id for h in hits
            )

        # Self-correlation demo: join a synthetic DNS kernel signal onto
        # the retrieval span (reference ``main.go:408-441``).
        now = datetime.now(timezone.utc)
        span_ref = SpanRef(
            timestamp=now, trace_id=trace_id,
            service=self.service_name, node=self.node,
        )
        signal_ref = SignalRef(
            signal="dns_latency_ms", timestamp=now, trace_id=trace_id,
            service=self.service_name, node=self.node,
            value=retrieval.dns_ms,
        )
        attrs, _decision = self.correlator.enrich_dns_attributes(
            dict(retr_span.attributes), span_ref, signal_ref
        )
        retr_span.attributes = attrs
        confidence = attrs.get(semconv.ATTR_CORRELATION_CONF)
        if confidence is not None:
            self.metrics.correlation_confidence.labels(
                signal="dns_latency_ms"
            ).set(float(confidence))
        self.recorder.record(retr_span)
        self.metrics.retrieval_ms.observe(
            retrieval.dns_ms + retrieval.network_ms + retrieval.vectordb_ms
        )

        # --- generation span -------------------------------------------
        gen_span = Span(
            "chat.generation", trace_id, uuid.uuid4().hex[:16],
            parent_span_id=root.span_id, start_ns=time.time_ns(),
        )
        tokens: list[str] = []
        first_token_at = last_token_at = None
        for token in self.backend.generate(query, max_new, warmup_ms, cadence_ms):
            ts = time.perf_counter()
            if first_token_at is None:
                first_token_at = ts
            last_token_at = ts
            tokens.append(token)
            yield {
                "type": "token",
                "request_id": request_id,
                "index": len(tokens) - 1,
                "token": token,
            }
        gen_span.end_ns = time.time_ns()

        ttft_ms = ((first_token_at or time.perf_counter()) - t0) * 1000.0
        latency_ms = (time.perf_counter() - t0) * 1000.0
        window_s = (
            (last_token_at - first_token_at)
            if first_token_at and last_token_at
            else 0.0
        )
        tps = len(tokens) / window_s if window_s > 0 else float(len(tokens))

        gen_span.attributes = {
            semconv.ATTR_SLO_TTFT_MS: ttft_ms,
            semconv.ATTR_SLO_TOKENS_PER_SEC: tps,
            "token_count": len(tokens),
            "backend": self.backend.name,
        }
        self.recorder.record(gen_span)
        root.end_ns = time.time_ns()
        root.attributes = {"profile": profile, "request_id": request_id}
        self.recorder.record(root)

        self.metrics.ttft_ms.observe(ttft_ms)
        self.metrics.request_latency_ms.observe(latency_ms)
        self.metrics.tokens_per_sec.observe(tps)

        yield {
            "type": "summary",
            "request_id": request_id,
            "trace_id": trace_id,
            "profile": profile,
            "backend": self.backend.name,
            "token_count": len(tokens),
            "ttft_ms": round(ttft_ms, 3),
            "latency_ms": round(latency_ms, 3),
            "tokens_per_sec": round(tps, 3),
            "retrieval": {
                "dns_ms": round(retrieval.dns_ms, 3),
                "network_ms": round(retrieval.network_ms, 3),
                "vectordb_ms": round(retrieval.vectordb_ms, 3),
                **(
                    {"doc_ids": [h.doc_id for h in hits]}
                    if hits
                    else {}
                ),
            },
            "correlation": {
                k: round(v, 4)
                for k, v in retr_span.attributes.items()
                if k.startswith("llm.ebpf.")
            },
        }
