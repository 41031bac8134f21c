"""HTTP face of the demo vector store: /search, /add, /metrics, /healthz
(the port of ``demo/vectordb/server.py``; the store searches on the card
unless ``--device cpu`` is passed).

Shares the demo HTTP conventions via :mod:`tpuslo_torch.demo.common`.  Run:

    python -m tpuslo_torch.demo.vectordb --port 18081 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import torch
from prometheus_client import CollectorRegistry, Counter, Histogram

from tpuslo_torch.demo.common import DemoHTTPHandler, serve_threaded
from tpuslo_torch.demo.vectordb.store import VectorStore

DEFAULT_CORPUS = str(
    Path(__file__).resolve().parent.parent / "rag_service/fixtures/corpus.json"
)


class VectorDBMetrics:
    def __init__(self) -> None:
        self.registry = CollectorRegistry()
        self.search_ms = Histogram(
            "vectordb_search_latency_ms",
            "Vector search latency (ms)",
            buckets=(0.5, 1, 2, 5, 10, 25, 50, 100, 250),
            registry=self.registry,
        )
        self.searches = Counter(
            "vectordb_searches_total", "Search requests", registry=self.registry
        )
        self.errors = Counter(
            "vectordb_errors_total", "Request errors", registry=self.registry
        )


def make_handler(store: VectorStore, metrics: VectorDBMetrics):
    class Handler(DemoHTTPHandler):
        def do_GET(self):
            if self.path.startswith("/metrics"):
                self.send_metrics(metrics.registry)
            elif self.path in ("/healthz", "/readyz"):
                self.send_json(200, {"status": "ok", "docs": len(store)})
            else:
                self.send_json(404, {"error": "not found"})

        def do_POST(self):
            try:
                payload = self.read_json_body()
            except (ValueError, json.JSONDecodeError) as exc:
                metrics.errors.inc()
                self.send_json(400, {"error": str(exc)})
                return
            if self.path == "/search":
                try:
                    query = payload.get("query", "")
                    k = int(payload.get("k", 3) or 0)
                    if not isinstance(query, str) or not query:
                        raise ValueError("query must be a non-empty string")
                    if k < 1:
                        raise ValueError("k must be >= 1")
                except (ValueError, TypeError) as exc:
                    metrics.errors.inc()
                    self.send_json(400, {"error": str(exc)})
                    return
                t0 = time.perf_counter()
                hits = store.search(query, k=k)
                elapsed_ms = (time.perf_counter() - t0) * 1000.0
                metrics.searches.inc()
                metrics.search_ms.observe(elapsed_ms)
                self.send_json(
                    200,
                    {
                        "hits": [
                            {"id": h.doc_id, "score": h.score, "text": h.text}
                            for h in hits
                        ],
                        "latency_ms": round(elapsed_ms, 3),
                    },
                )
            elif self.path == "/add":
                doc_id = payload.get("id", "")
                text = payload.get("text", "")
                if (
                    not isinstance(doc_id, str)
                    or not isinstance(text, str)
                    or not doc_id
                    or not text
                ):
                    metrics.errors.inc()
                    self.send_json(
                        400, {"error": "id and text must be non-empty strings"}
                    )
                    return
                store.add(doc_id, text)
                self.send_json(200, {"status": "ok", "docs": len(store)})
            else:
                self.send_json(404, {"error": "not found"})

    return Handler


def serve(
    store: VectorStore,
    port: int,
    host: str = "0.0.0.0",
    metrics: VectorDBMetrics | None = None,
):
    metrics = metrics or VectorDBMetrics()
    return serve_threaded(make_handler(store, metrics), port, host)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vectordb", description=__doc__)
    parser.add_argument("--port", type=int, default=18081)
    parser.add_argument(
        "--corpus",
        default=DEFAULT_CORPUS,
        help="corpus.json to preload (pass '' for an empty store)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the store searches (default: the card)")
    args = parser.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("vectordb: no CUDA device; pass --device cpu to search on the CPU",
              file=sys.stderr)
        return 2
    store = (
        VectorStore.from_corpus(args.corpus, device=args.device) if args.corpus
        else VectorStore(device=args.device)
    )
    server = serve(store, args.port)
    print(
        f"vectordb: {len(store)} docs on {store.device} listening on :{args.port} "
        "(/search /add /metrics /healthz)",
        file=sys.stderr,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
