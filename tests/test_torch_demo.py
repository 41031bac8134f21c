"""The port's demo workload (``tpuslo_torch.demo.rag_service``) against the
JAX demo (``demo.rag_service``).

Over the stub backend, with both packages drawing the same request and
span ids, the two services yield the same event streams and record the
same spans (names, parents and attributes; times left out), and their
``/metrics`` bodies carry the same names, labels, buckets and counts.
The model backends serve ``llama_tiny`` (and ``mixtral_tiny``) in f32 on
the CPU over JAX-initialised weights carried across as numpy
(``bridge.params_from_numpy``): ``torch``, ``torch_batched`` (dense and
paged, two concurrent requests), ``torch_spec`` and ``torch_moe`` stream
the same token ids as ``jax``, ``jax_batched``, ``jax_spec`` and
``jax_moe``.  The port's plain copies of the correlator and the SLO
calculator give the JAX package's results.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request
import uuid
from datetime import datetime, timedelta, timezone

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402

from demo.rag_service import service as jsvc  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import mixtral as jm  # noqa: E402
from tpuslo_torch.demo.rag_service import server as tserver  # noqa: E402
from tpuslo_torch.demo.rag_service import service as tsvc  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402

CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)
MOE_J = dataclasses.replace(jm.mixtral_tiny(max_seq_len=128), dtype=jnp.float32)
MOE_T = dataclasses.replace(tm.mixtral_tiny(max_seq_len=128), dtype=torch.float32)
PROMPTS = ("what broke first in the serving tier?", "x",
           "a longer question that lands in the second prefill bucket of the engine")
TIMES = {"ttft_ms", "latency_ms", "tokens_per_sec", "llm.slo.ttft_ms",
         "llm.slo.tokens_per_sec", "start_ns", "end_ns", "duration_ms"}
IDS = {"request_id", "trace_id", "span_id", "parent_span_id"}

_WEIGHTS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small models run in many processes at
    once under the suite's workers, where torch's default of one thread a
    core oversubscribes the box."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _llama_weights():
    """(JAX params, port params) of f32 llama_tiny, drawn once."""
    if "llama" not in _WEIGHTS:
        pj = jl.init_params(jax.random.PRNGKey(0), CFG_J)
        _WEIGHTS["llama"] = (pj, bridge.params_from_numpy(
            jax.tree.map(np.asarray, pj), CFG_T, "cpu"))
    return _WEIGHTS["llama"]


class FastStub(tsvc.StubBackend):
    """The stub without its pacing sleeps."""

    def generate(self, prompt, max_new_tokens, warmup_ms, cadence_ms):
        yield from super().generate(prompt, max_new_tokens, 0.0, 0.0)


class JaxFastStub(jsvc.StubBackend):
    def generate(self, prompt, max_new_tokens, warmup_ms, cadence_ms):
        yield from super().generate(prompt, max_new_tokens, 0.0, 0.0)


@pytest.fixture
def same_ids(monkeypatch):
    """Make ``uuid.uuid4`` a seeded sequence; calling the fixture's value
    restarts it, so each package's run draws the same ids."""
    state = {}

    def restart():
        rng = np.random.default_rng(1234)
        state["next"] = lambda: uuid.UUID(bytes=rng.bytes(16), version=4)

    restart()
    monkeypatch.setattr(uuid, "uuid4", lambda: state["next"]())
    return restart


def _scrub(value):
    """``value`` with times and ids left out."""
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k not in TIMES | IDS}
    if isinstance(value, list):
        return [_scrub(v) for v in value]
    return value


def _run(svc_mod, backend, queries):
    service = svc_mod.RagService(backend=backend, seed=7, sleep=lambda s: None)
    events = [list(service.chat(q, p)) for q, p in queries]
    return service, events


QUERIES = [("what is an slo?", "chat_short"), ("why is ttft high", "rag_medium"),
           ("dns timeouts", "context_long")]


def test_stub_events_and_spans_match_jax(same_ids):
    service_t, events_t = _run(tsvc, FastStub(), QUERIES)
    same_ids()
    service_j, events_j = _run(jsvc, JaxFastStub(), QUERIES)
    assert _scrub(events_t) == _scrub(events_j)
    # the ids are the same draws, too
    assert [e[-1]["trace_id"] for e in events_t] == [e[-1]["trace_id"] for e in events_j]
    spans_t, spans_j = service_t.recorder.recent(), service_j.recorder.recent()
    assert _scrub(spans_t) == _scrub(spans_j)
    for spans in (spans_t, spans_j):  # one tree per request, in the JAX order
        assert [s["name"] for s in spans] == ["chat.retrieval", "chat.generation",
                                              "chat.request"] * len(QUERIES)
    for a, b in zip(spans_t, spans_j):
        assert (a["parent_span_id"] == "") == (b["parent_span_id"] == "")


def _metric_lines(text: str) -> dict[str, str]:
    """Sample lines by name and labels; times (``_created``, ``_sum`` and
    the time histograms' buckets) are kept by name only."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out[line] = ""
            continue
        key, value = line.rsplit(" ", 1)
        timed = ("_created" in key or key.endswith("_sum") or "_sum{" in key
                 or key.startswith(("llm_slo_ttft_ms_bucket", "llm_slo_request_latency_ms_bucket",
                                    "llm_slo_tokens_per_sec_bucket")))
        out[key] = "" if timed else value
    return out


def test_metrics_text_matches_jax(same_ids):
    service_t, _ = _run(tsvc, FastStub(), QUERIES)
    service_t.metrics.errors.inc()
    same_ids()
    service_j, _ = _run(jsvc, JaxFastStub(), QUERIES)
    service_j.metrics.errors.inc()
    text_t = generate_latest(service_t.metrics.registry).decode()
    text_j = generate_latest(service_j.metrics.registry).decode()
    assert _metric_lines(text_t) == _metric_lines(text_j)
    assert 'llm_slo_requests_total{backend="stub",profile="rag_medium"} 1.0' in text_t
    assert "llm_slo_ttft_ms_count 3.0" in text_t


def test_unknown_profile_raises():
    service = tsvc.RagService(backend=FastStub(), sleep=lambda s: None)
    with pytest.raises(ValueError, match="unknown profile"):
        list(service.chat("x", "warp"))


class TestHTTPServer:
    @pytest.fixture
    def url(self):
        service = tsvc.RagService(backend=FastStub(), sleep=lambda s: None)
        srv = tserver.serve(service, 0, host="127.0.0.1")
        yield f"http://127.0.0.1:{srv.server_address[1]}"
        srv.shutdown()
        srv.server_close()

    @staticmethod
    def _post(url, payload):
        req = urllib.request.Request(f"{url}/chat", data=json.dumps(payload).encode(),
                                     method="POST")
        return urllib.request.urlopen(req, timeout=30)

    def test_healthz(self, url):
        body = json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
        assert body == {"status": "ok", "backend": "stub"}

    def test_chat_streamed_ndjson(self, url):
        lines = self._post(url, {"query": "hi", "profile": "chat_short"}).read().decode()
        events = [json.loads(line) for line in lines.strip().splitlines()]
        assert [e["type"] for e in events] == ["token"] * 24 + ["summary"]
        assert events[-1]["correlation"]["llm.ebpf.correlation_confidence"] == 1.0

    def test_chat_not_streamed(self, url):
        body = json.loads(self._post(url, {"query": "hi", "profile": "chat_short",
                                           "stream": False}).read())
        assert body["token_count"] == len(body["tokens"]) == 24

    def test_spans_and_metrics(self, url):
        self._post(url, {"query": "x", "stream": False}).read()
        spans = json.loads(urllib.request.urlopen(f"{url}/spans", timeout=30).read())["spans"]
        assert {s["name"] for s in spans} == {"chat.request", "chat.retrieval",
                                              "chat.generation"}
        body = urllib.request.urlopen(f"{url}/metrics", timeout=30).read().decode()
        assert "llm_slo_ttft_ms_bucket" in body and "llm_slo_ttft_ms_count 1.0" in body

    @pytest.mark.parametrize("path,payload", [("/chat", {"query": "x", "profile": "warp"}),
                                              ("/chat", "not json")])
    def test_bad_request_400(self, url, path, payload):
        body = payload if isinstance(payload, str) else json.dumps(payload)
        req = urllib.request.Request(f"{url}{path}", data=body.encode(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400

    def test_unknown_path_404(self, url):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/nope", timeout=30)
        assert err.value.code == 404


def test_entry_exits_2_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert tserver.main(["--backend", "torch"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# --- the model backends, held to the JAX demo's ---------------------------------


def _engines():
    from tpuslo.models.serve import ServeEngine as JServe
    from tpuslo_torch.models.serve import ServeEngine as TServe

    pj, pt = _llama_weights()
    return JServe(CFG_J, pj), TServe(CFG_T, pt, device="cpu")


@pytest.mark.parametrize("system", [None, "demo system preamble "])
def test_torch_backend_matches_jax_backend(system, monkeypatch):
    if system:
        monkeypatch.setenv("TPUSLO_SYSTEM_PROMPT", system)
    else:
        monkeypatch.delenv("TPUSLO_SYSTEM_PROMPT", raising=False)
    ej, et = _engines()
    jb, tb = jsvc.JaxBackend(engine=ej), tsvc.TorchBackend(engine=et)
    for prompt in PROMPTS:
        assert list(tb.generate(prompt, 10, 0.0, 0.0)) == list(jb.generate(prompt, 10, 0.0, 0.0))


def _concurrent(backend, prompts, n_tokens: int) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    errors: list[BaseException] = []

    def drive(p):
        try:
            out[p] = list(backend.generate(p, n_tokens, 0.0, 0.0))
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=drive, args=(p,), daemon=True) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "the batched backend deadlocked"
    assert not errors, errors
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_torch_batched_matches_jax_batched(paged, monkeypatch):
    from tpuslo.models.batching import ContinuousBatchingEngine as JCont
    from tpuslo.models.paged_kv import PagedBatchingEngine as JPaged
    from tpuslo_torch.models.batching import ContinuousBatchingEngine as TCont
    from tpuslo_torch.models.paged_kv import PagedBatchingEngine as TPaged

    monkeypatch.delenv("TPUSLO_SYSTEM_PROMPT", raising=False)
    pj, pt = _llama_weights()
    kw = dict(max_slots=2, block_size=16) if paged else dict(max_slots=2)
    jb = jsvc.JaxBatchedBackend(engine=(JPaged if paged else JCont)(cfg=CFG_J, params=pj, **kw))
    tb = tsvc.TorchBatchedBackend(engine=(TPaged if paged else TCont)(
        cfg=CFG_T, params=pt, device="cpu", **kw))
    prompts = PROMPTS[:2]
    got, want = _concurrent(tb, prompts, 8), _concurrent(jb, prompts, 8)
    assert got == want
    stats = tsvc.RagService(backend=tb, sleep=lambda s: None).refresh_engine_stats()
    assert {"occupancy", "queued", "completed"} <= set(stats)
    if paged:
        assert {"block_utilization", "pool_blocks", "shared_prefix_blocks"} <= set(stats)


def test_torch_spec_matches_jax_spec(monkeypatch):
    """The depth-pruned self-draft of both backends (the target's first
    half of its layers) over the same weights streams the same ids, which
    are the target-only stream's."""
    from tpuslo.models.serve import ServeEngine as JServe
    from tpuslo.models.speculative import SpeculativeEngine as JSpec
    from tpuslo_torch.models.serve import ServeEngine as TServe
    from tpuslo_torch.models.speculative import SpeculativeEngine as TSpec

    monkeypatch.delenv("TPUSLO_SYSTEM_PROMPT", raising=False)
    pj, pt = _llama_weights()
    half = CFG_J.n_layers // 2
    dj = {**pj, "layers": jax.tree.map(lambda leaf: leaf[:half], pj["layers"])}
    dt = {**pt, "layers": tsvc._first_layers(pt["layers"], half)}
    jspec = jsvc.JaxSpecBackend(engine=JSpec(
        JServe(CFG_J, pj), JServe(dataclasses.replace(CFG_J, n_layers=half), dj), k=3))
    tspec = tsvc.TorchSpecBackend(engine=TSpec(
        TServe(CFG_T, pt, device="cpu"),
        TServe(dataclasses.replace(CFG_T, n_layers=half), dt, device="cpu"), k=3))
    _, et = _engines()
    plain = tsvc.TorchBackend(engine=et)
    for prompt in PROMPTS[:2]:
        got = list(tspec.generate(prompt, 10, 0.0, 0.0))
        assert got == list(jspec.generate(prompt, 10, 0.0, 0.0))
        assert got == list(plain.generate(prompt, 10, 0.0, 0.0))
    assert tspec.engine.rounds > 0


def test_torch_spec_backend_from_env_matches_torch_backend(monkeypatch):
    """Built from the knobs alone (the port's own seed-0 weights, bf16
    llama_tiny): the speculative stream is the plain backend's."""
    monkeypatch.delenv("TPUSLO_SYSTEM_PROMPT", raising=False)
    monkeypatch.delenv("TPUSLO_SERVE_MODEL", raising=False)
    plain = tsvc.TorchBackend(device="cpu")
    spec = tsvc.TorchSpecBackend(device="cpu")
    assert spec.engine.draft.cfg.n_layers == plain.engine.cfg.n_layers // 2
    prompt = "speculative demo stream"
    assert list(spec.generate(prompt, 8, 0.0, 0.0)) == list(plain.generate(prompt, 8, 0.0, 0.0))


def test_torch_moe_matches_jax_moe():
    from tpuslo.models.mixtral import MoEServeEngine as JMoE
    from tpuslo_torch.models.mixtral import MoEServeEngine as TMoE

    pj = jm.init_params(jax.random.PRNGKey(0), MOE_J)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), MOE_T, "cpu")
    jb = jsvc.JaxMoEBackend(engine=JMoE(MOE_J, pj))
    tb = tsvc.TorchMoEBackend(engine=TMoE(MOE_T, pt, device="cpu"))
    for prompt in PROMPTS[:2]:
        assert list(tb.generate(prompt, 8, 0.0, 0.0)) == list(jb.generate(prompt, 8, 0.0, 0.0))


def test_torch_backend_sampling_env_knobs(monkeypatch):
    monkeypatch.delenv("TPUSLO_SYSTEM_PROMPT", raising=False)
    _, et = _engines()
    greedy = tsvc.TorchBackend(engine=et)
    assert greedy.sampling is None
    monkeypatch.setenv("TPUSLO_SERVE_TEMPERATURE", "1.3")
    monkeypatch.setenv("TPUSLO_SERVE_TOP_K", "50")
    warm = tsvc.TorchBackend(engine=et)
    assert (warm.sampling.temperature, warm.sampling.top_k) == (1.3, 50)
    assert len(list(warm.generate("sampled demo", 8, 0.0, 0.0))) == 8


# --- the knobs' validation --------------------------------------------------------


def _jax_message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("model", ["mixtral_2b6", "llama3_9b"])
def test_llama_model_knob_messages(model, monkeypatch):
    monkeypatch.setenv("TPUSLO_SERVE_MODEL", model)
    want = _jax_message(jsvc._serve_env_config).replace("jax_moe", "torch_moe")
    assert _jax_message(lambda: tsvc._serve_env_config("cpu")) == want


@pytest.mark.parametrize("model", ["mixtral2b6", "llama3_8b"])
def test_moe_model_knob_messages(model, monkeypatch):
    monkeypatch.setenv("TPUSLO_SERVE_MODEL", model)
    want = _jax_message(jsvc.JaxMoEBackend).replace(
        "jax|jax_batched", "torch|torch_batched")
    assert _jax_message(lambda: tsvc.TorchMoEBackend(device="cpu")) == want


def test_moe_both_mesh_knobs_rejected(monkeypatch):
    monkeypatch.setenv("TPUSLO_SERVE_TP", "2")
    monkeypatch.setenv("TPUSLO_SERVE_EP", "2")
    assert "not both" in _jax_message(lambda: tsvc.TorchMoEBackend(device="cpu"))


@pytest.mark.parametrize("knob,backend", [("TPUSLO_SERVE_TP", "torch"),
                                          ("TPUSLO_SERVE_TP", "torch_spec"),
                                          ("TPUSLO_SERVE_TP", "torch_batched"),
                                          ("TPUSLO_SERVE_EP", "torch_moe")])
def test_mesh_knobs_name_the_one_device(knob, backend, monkeypatch):
    monkeypatch.setenv(knob, "2")
    msg = _jax_message(lambda: tsvc.BACKENDS[backend](device="cpu"))
    assert msg.startswith(f"{knob}=2 but the demo serves in one process on one device (cpu")
    assert "run_ranks" in msg


def test_spec_draft_layers_knob_out_of_range(monkeypatch):
    monkeypatch.delenv("TPUSLO_SERVE_MODEL", raising=False)
    monkeypatch.setenv("TPUSLO_SERVE_DRAFT_LAYERS", "9")
    assert "outside [1, 2]" in _jax_message(lambda: tsvc.TorchSpecBackend(device="cpu"))


def test_backends_need_a_card_by_default():
    assert not torch.cuda.is_available()
    for name in ("torch", "torch_spec", "torch_batched", "torch_moe"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsvc.BACKENDS[name]()


# --- the plain copies: correlator and SLO calculator ---------------------------


def test_correlator_process_batch_matches_jax():
    from tpuslo.correlation.matcher import SignalRef as JSignal
    from tpuslo.otel.processor.correlator import Correlator as JCorr
    from tpuslo.otel.processor.correlator import SpanRecord as JSpan
    from tpuslo_torch.correlation.matcher import SignalRef as TSignal
    from tpuslo_torch.otel.processor.correlator import Correlator as TCorr
    from tpuslo_torch.otel.processor.correlator import SpanRecord as TSpan

    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    rng = np.random.default_rng(5)
    names = ["dns_latency_ms", "tcp_retransmits_total", "xla_compile_ms",
             "hbm_alloc_stall_ms", "ici_collective_latency_ms", "not_a_signal"]

    def batch(span_cls, signal_cls):
        spans = [span_cls(trace_id=f"t{i % 3}", span_id=f"s{i}", service="rag", node="n0",
                          timestamp=t0 + timedelta(milliseconds=int(rng_s[i])))
                 for i in range(6)]
        signals = [signal_cls(signal=names[j % len(names)], timestamp=t0 + timedelta(
            milliseconds=int(rng_v[j, 0])), trace_id=f"t{j % 4}", service="rag",
            node="n0" if j % 2 else "n1", value=float(rng_v[j, 1])) for j in range(12)]
        return spans, signals

    rng_s = rng.integers(0, 2000, 6)
    rng_v = np.column_stack([rng.integers(0, 4000, 12), rng.uniform(0, 90, 12)])
    got = TCorr().process_batch(*batch(TSpan, TSignal))
    want = JCorr().process_batch(*batch(JSpan, JSignal))
    assert [s.attributes for s in got.spans] == [s.attributes for s in want.spans]
    assert dataclasses.asdict(got.debug) == dataclasses.asdict(want.debug)


def test_slo_calculator_matches_jax():
    from tpuslo.slo import calculator as jc
    from tpuslo_torch.slo import calculator as tc

    rng = np.random.default_rng(3)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    rows = [(float(a), float(b), int(n)) for a, b, n in zip(
        rng.uniform(1, 900, 40), rng.uniform(0, 5000, 40), rng.integers(1, 200, 40))]

    def snaps(mod):
        return [mod.calculate(mod.Timing(t0, t0 + timedelta(milliseconds=a),
                                         t0 + timedelta(milliseconds=a + b), n),
                              mod.RetrievalBreakdown(a / 10, b / 100, n / 7))
                for a, b, n in rows]

    assert dataclasses.asdict(tc.aggregate(snaps(tc))) == dataclasses.asdict(
        jc.aggregate(snaps(jc)))
    values = [r[0] for r in rows] + [float("nan")]
    for q in (-1.0, 0.0, 0.5, 0.95, 0.99, 2.0):
        assert tc.quantile(values, q) == jc.quantile(values, q)
    assert tc.aggregate([]) == tc.Percentiles()
    with pytest.raises(ValueError):
        tc.tokens_per_second(t0, t0, 0)


def test_stub_ids_fixture_restarts(same_ids):
    first = [uuid.uuid4() for _ in range(3)]
    same_ids()
    assert [uuid.uuid4() for _ in range(3)] == first
    assert first[0].version == 4
