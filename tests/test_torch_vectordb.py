"""The port's demo vector store (``tpuslo_torch.demo.vectordb``) against the
JAX demo's (``demo.vectordb``), both on the CPU.

Embeddings are bitwise the JAX store's; a search's ids are the JAX
store's and its scores within 1e-6, at corpus sizes that fill power-of-two
buckets from 8 to 256 rows.  The HTTP face, the cache invalidation and
the bulk-load path (``add_embedded``) are held as the JAX tests hold
theirs; without a card the store refuses to start unless the CPU is asked
for.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from demo.vectordb import store as jstore  # noqa: E402
from tpuslo_torch.demo.rag_service.server import DEFAULT_CORPUS  # noqa: E402
from tpuslo_torch.demo.vectordb import store as tstore  # noqa: E402
from tpuslo_torch.demo.vectordb.server import serve  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORDS = ("ici link retries slow collectives hbm pressure stalls allocation dns "
         "timeouts node tokens per second prefill decode kernel queue latency "
         "slice host straggler retrieval vector search compile storm cache").split()
QUERIES = ["time to first token latency", "ici link retries", "hbm allocation stalls",
           "dns timeouts on a node", "xla recompile storm", "retrieval vector search"]


def _texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"doc {i}: " + " ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
            for i in range(n)]


def test_embeddings_are_bitwise_jax():
    texts = _texts(64, 0) + ["", "ÜnïcØde — text", "The quick brown fox.", "a" * 500]
    got, want = tstore.embed_texts(texts), jstore.embed_texts(texts)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert tstore.embed_texts([]).shape == jstore.embed_texts([]).shape == (0, 256)


@pytest.mark.parametrize("n_docs", [3, 8, 9, 16, 31, 64, 100, 129, 256])
def test_search_matches_jax_store(n_docs):
    docs = list(zip((f"d{i}" for i in range(n_docs)), _texts(n_docs, n_docs)))
    got_store, want_store = tstore.VectorStore(device="cpu"), jstore.VectorStore()
    got_store.add_many(docs)
    want_store.add_many(docs)
    k = 5
    got = got_store.search_batch(QUERIES, k=k)
    want = want_store.search_batch(QUERIES, k=k)
    assert tstore._bucket(n_docs) == jstore._bucket(n_docs)
    for g, w in zip(got, want):
        assert len(g) == len(w) == min(k, n_docs)
        assert [h.doc_id for h in g] == [h.doc_id for h in w]
        assert [h.text for h in g] == [h.text for h in w]
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w], rtol=0,
                                   atol=1e-6)


def test_empty_store_and_k_clamping():
    store = tstore.VectorStore(device="cpu")
    assert store.search("anything") == []
    assert store.search_batch([]) == []
    store.add("only", "the only document")
    hits = store.search("document", k=10)
    assert [h.doc_id for h in hits] == ["only"]


def test_from_corpus_fixture_is_the_demo_corpus():
    assert json.loads(Path(DEFAULT_CORPUS).read_text()) == json.loads(
        (REPO / "demo/rag_service/fixtures/corpus.json").read_text())
    store = tstore.VectorStore.from_corpus(DEFAULT_CORPUS, device="cpu")
    assert len(store) >= 10
    assert store.search("time to first token latency", k=3)[0].doc_id == "doc-ttft"


def test_add_after_search_invalidates_the_cached_corpus():
    store = tstore.VectorStore(device="cpu")
    store.add("a", "alpha document about tpu scheduling")
    assert store.search("tpu scheduling", k=1)[0].doc_id == "a"
    store.add("b", "beta document about dns resolution")
    assert store.search("dns resolution", k=1)[0].doc_id == "b"
    store.add_many([("c", "gamma document about hbm pressure")])
    assert store.search("hbm pressure", k=1)[0].doc_id == "c"


def test_add_embedded_bulk_load():
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((40, 256), dtype=np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    store = tstore.VectorStore(device="cpu")
    store.add_embedded([f"v{i}" for i in range(40)], [""] * 40, vectors)
    assert store.doc_ids() == [f"v{i}" for i in range(40)]
    assert store.matrix().tobytes() == vectors.tobytes()
    q = tstore.embed_texts(QUERIES)
    want = np.argsort(-(q @ vectors.T), axis=1, kind="stable")[:, :4]
    got = [[int(h.doc_id[1:]) for h in row] for row in store.search_batch(QUERIES, k=4)]
    assert got == want.tolist()
    with pytest.raises(ValueError, match="expected 2 texts"):
        store.add_embedded(["x", "y"], ["", ""], vectors[:3])


def test_store_needs_a_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.VectorStore()


def test_rag_service_with_the_store():
    from tpuslo_torch.demo.rag_service.service import RagService, StubBackend

    store = tstore.VectorStore.from_corpus(DEFAULT_CORPUS, device="cpu")
    service = RagService(backend=StubBackend(), sleep=lambda s: None, vector_store=store)
    summary = list(service.chat("why is time to first token slow", "chat_short"))[-1]
    assert summary["retrieval"]["doc_ids"][0] == "doc-ttft"
    assert summary["retrieval"]["vectordb_ms"] >= 0
    span = next(s for s in service.recorder.recent() if s["name"] == "chat.retrieval")
    assert "retrieval.doc_ids" in span["attributes"]


def _post(base: str, path: str, payload) -> urllib.request.Request:
    return urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                  method="POST")


@pytest.fixture
def base():
    store = tstore.VectorStore(device="cpu")
    store.add("doc-a", "tcp retransmits inflate network latency")
    server = serve(store, port=0, host="127.0.0.1")
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_http_server_roundtrip(base):
    with urllib.request.urlopen(f"{base}/healthz", timeout=5) as resp:
        assert json.load(resp)["docs"] == 1
    with urllib.request.urlopen(_post(base, "/add", {"id": "doc-b",
                                                     "text": "tls handshake latency spikes"}),
                                timeout=5) as resp:
        assert json.load(resp)["docs"] == 2
    with urllib.request.urlopen(_post(base, "/search", {"query": "tls handshake", "k": 1}),
                                timeout=5) as resp:
        payload = json.load(resp)
    assert payload["hits"][0]["id"] == "doc-b" and payload["latency_ms"] >= 0
    with urllib.request.urlopen(f"{base}/metrics", timeout=5) as resp:
        metrics = resp.read().decode()
    assert "vectordb_searches_total 1.0" in metrics
    assert "vectordb_search_latency_ms_count 1.0" in metrics


@pytest.mark.parametrize("path,bad", [
    ("/search", {"query": "x", "k": "abc"}), ("/search", {"query": 5}),
    ("/search", {"query": "x", "k": 0}), ("/search", {}),
    ("/add", {"id": "x", "text": 123}), ("/add", {"id": 5, "text": "t"}), ("/add", {"id": "x"}),
])
def test_http_server_rejects_malformed_requests(base, path, bad):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(_post(base, path, bad), timeout=5)
    assert err.value.code == 400
    with urllib.request.urlopen(f"{base}/metrics", timeout=5) as resp:
        assert "vectordb_errors_total 1.0" in resp.read().decode()


def test_server_entry_exits_2_without_a_card(capsys):
    from tpuslo_torch.demo.vectordb.server import main

    assert main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
