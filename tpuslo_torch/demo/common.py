"""Shared HTTP plumbing for the demo services (rag_service, vectordb; the
port's copy of ``demo/common.py``).

One place for the JSON/metrics/health handler conventions so the wire
format can't drift between the two servers.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from prometheus_client import generate_latest
from prometheus_client.exposition import CONTENT_TYPE_LATEST


class DemoHTTPHandler(BaseHTTPRequestHandler):
    """Quiet HTTP/1.1 handler with JSON + Prometheus helpers."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # demo services log via their own paths
        pass

    def send_json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def send_metrics(self, registry) -> None:
        body = generate_latest(registry)
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE_LATEST)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def read_json_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")


def serve_threaded(handler_cls, port: int, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start a ThreadingHTTPServer on a daemon thread and return it."""
    server = ThreadingHTTPServer((host, port), handler_cls)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
