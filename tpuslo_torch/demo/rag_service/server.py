"""HTTP layer for the RAG demo: /chat (NDJSON stream), /metrics,
/healthz, /spans (the port of ``demo/rag_service/server.py``).

    python -m tpuslo_torch.demo.rag_service --backend torch [--device cpu]

A model backend serves on the card unless ``--device cpu`` is passed;
without a card it exits 2 naming the reason (``--backend stub`` needs
no device).

Reference: ``demo/rag-service/main.go:272-295,346-481``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from pathlib import Path

import torch

from tpuslo_torch.demo.common import DemoHTTPHandler, serve_threaded
from tpuslo_torch.demo.rag_service.service import BACKENDS, PROFILES, RagService, StubBackend
from tpuslo_torch.ops.launch_counts import kernel_launches

DEFAULT_CORPUS = str(Path(__file__).resolve().parent / "fixtures/corpus.json")


def make_handler(service: RagService):
    class Handler(DemoHTTPHandler):
        def do_GET(self):
            if self.path.startswith("/metrics"):
                service.refresh_engine_stats()
                self.send_metrics(service.metrics.registry)
            elif self.path in ("/healthz", "/readyz"):
                self.send_json(
                    200, {"status": "ok", "backend": service.backend.name}
                )
            elif self.path.startswith("/spans"):
                self.send_json(200, {"spans": service.recorder.recent()})
            else:
                self.send_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/chat":
                self.send_json(404, {"error": "not found"})
                return
            try:
                payload = self.read_json_body()
                query = payload.get("query", "")
                profile = payload.get("profile", "rag_medium")
                stream = bool(payload.get("stream", True))
                if profile not in PROFILES:
                    raise ValueError(f"unknown profile {profile!r}")
            except (ValueError, json.JSONDecodeError) as exc:
                service.metrics.errors.inc()
                self.send_json(400, {"error": str(exc)})
                return

            events = service.chat(query, profile)
            if not stream:
                tokens, summary = [], None
                for event in events:
                    if event["type"] == "token":
                        tokens.append(event["token"])
                    else:
                        summary = event
                self.send_json(200, {"tokens": tokens, **(summary or {})})
                return

            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for event in events:
                    chunk = (json.dumps(event) + "\n").encode()
                    self.wfile.write(f"{len(chunk):x}\r\n".encode())
                    self.wfile.write(chunk + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                service.metrics.errors.inc()

    return Handler


def serve(service: RagService, port: int, host: str = "0.0.0.0"):
    return serve_threaded(make_handler(service), port, host)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rag-service", description=__doc__)
    parser.add_argument("--port", type=int, default=18080)
    parser.add_argument("--backend", default="stub", choices=sorted(BACKENDS))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where a model backend and the vector store run "
                        "(default: the card)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--node", default="tpu-vm-0")
    parser.add_argument(
        "--retrieval",
        default="simulated",
        choices=["simulated", "vectordb"],
        help="vectordb = measured in-process search over --corpus",
    )
    parser.add_argument("--corpus", default=DEFAULT_CORPUS)
    args = parser.parse_args(argv)

    backend_cls = BACKENDS[args.backend]
    on_device = backend_cls is not StubBackend or args.retrieval == "vectordb"
    if on_device and args.device == "cuda" and not torch.cuda.is_available():
        print("rag-service: no CUDA device; pass --device cpu to serve on the CPU "
              "(--backend stub needs no device)", file=sys.stderr)
        return 2
    backend = (backend_cls() if backend_cls is StubBackend
               else backend_cls(device=args.device))
    vector_store = None
    if args.retrieval == "vectordb":
        from tpuslo_torch.demo.vectordb import VectorStore

        vector_store = VectorStore.from_corpus(args.corpus, device=args.device)
        # Copy the corpus to the device and run the product once now,
        # so the first request's measured vectordb_ms is search time.
        vector_store.search("warmup", k=3)
    service = RagService(
        backend=backend,
        seed=args.seed,
        node=args.node,
        vector_store=vector_store,
    )
    server = serve(service, args.port)
    print(
        f"rag-service: backend={backend.name} listening on :{server.server_address[1]} "
        f"(/chat /metrics /spans /healthz)",
        file=sys.stderr,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
    # What served: the port's kernels launched in this process (a stub
    # backend launches none).
    print(f"rag-service: kernel launches {json.dumps(kernel_launches())}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
