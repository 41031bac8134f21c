"""Fault-injection sinks: scripted failure schedules for chaos tests.

Two shapes, one schedule grammar:

* :class:`FlakySink` — an in-process :class:`~tpuslo.delivery.channel.Sink`
  for deterministic unit tests (no sockets, injectable sleep).
* :class:`FaultInjectingHTTPServer` — a real localhost HTTP endpoint the
  agent's OTLP exporters can point at (``tpuslo agent --chaos-sink``),
  so chaos tests and demos exercise the full urllib → exporter →
  channel → spool path.

Schedule grammar: comma-separated ``behavior[:count]`` phases, consumed
one request at a time; after the last phase the sink stays healthy.

    ok:3,refuse:4,5xx:2,hang:1,flap:6,ok

Behaviors: ``ok`` (2xx), ``refuse`` (connection dropped before any
response), ``5xx`` (retryable server error), ``4xx`` (non-retryable
client error → dead-letter), ``hang`` (stall past the client timeout,
then fail), ``flap`` (alternate ok/5xx per request).

The port's own copy of ``tpuslo/delivery/faultsink.py``.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from tpuslo_torch.delivery.channel import SinkError

BEHAVIOR_OK = "ok"
BEHAVIOR_REFUSE = "refuse"
BEHAVIOR_5XX = "5xx"
BEHAVIOR_4XX = "4xx"
BEHAVIOR_HANG = "hang"
BEHAVIOR_FLAP = "flap"

_BEHAVIORS = frozenset(
    {BEHAVIOR_OK, BEHAVIOR_REFUSE, BEHAVIOR_5XX, BEHAVIOR_4XX,
     BEHAVIOR_HANG, BEHAVIOR_FLAP}
)
_ALIASES = {"500": BEHAVIOR_5XX, "400": BEHAVIOR_4XX, "down": BEHAVIOR_REFUSE}


@dataclass
class Phase:
    behavior: str
    count: int


def parse_schedule(spec: str) -> list[Phase]:
    """Parse ``behavior[:count],...`` into phases (count defaults to 1)."""
    phases: list[Phase] = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        name, _, count_s = token.partition(":")
        name = _ALIASES.get(name.strip(), name.strip())
        if name not in _BEHAVIORS:
            raise ValueError(
                f"unknown fault behavior {name!r} "
                f"(expected one of {sorted(_BEHAVIORS)})"
            )
        count = int(count_s) if count_s else 1
        if count < 1:
            raise ValueError(f"phase count must be >= 1: {token!r}")
        phases.append(Phase(name, count))
    if not phases:
        raise ValueError("empty fault schedule")
    return phases


class FaultSchedule:
    """Thread-safe per-request behavior cursor over a phase list."""

    def __init__(self, phases: list[Phase] | str):
        if isinstance(phases, str):
            phases = parse_schedule(phases)
        self._phases = phases
        self._lock = threading.Lock()
        self._phase_idx = 0
        self._used_in_phase = 0
        self._flap_toggle = False
        self.requests = 0

    def next_behavior(self) -> str:
        with self._lock:
            self.requests += 1
            while self._phase_idx < len(self._phases):
                phase = self._phases[self._phase_idx]
                if self._used_in_phase < phase.count:
                    self._used_in_phase += 1
                    if phase.behavior == BEHAVIOR_FLAP:
                        self._flap_toggle = not self._flap_toggle
                        return BEHAVIOR_OK if self._flap_toggle else BEHAVIOR_5XX
                    return phase.behavior
                self._phase_idx += 1
                self._used_in_phase = 0
            return BEHAVIOR_OK  # schedule exhausted: healthy forever


class FlakySink:
    """In-process Sink that fails per its schedule; records deliveries."""

    def __init__(
        self,
        schedule: FaultSchedule | str,
        hang_s: float = 0.05,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.schedule = (
            schedule if isinstance(schedule, FaultSchedule)
            else FaultSchedule(schedule)
        )
        self._hang_s = hang_s
        self._sleep = sleep
        self.received: list[tuple[str, list[dict]]] = []
        self.calls = 0

    def send(self, kind: str, payloads: list[dict]) -> None:
        self.calls += 1
        behavior = self.schedule.next_behavior()
        if behavior == BEHAVIOR_OK:
            self.received.append((kind, payloads))
            return
        if behavior == BEHAVIOR_REFUSE:
            raise SinkError("connection refused", retryable=True)
        if behavior == BEHAVIOR_5XX:
            raise SinkError("HTTP 503", retryable=True)
        if behavior == BEHAVIOR_4XX:
            raise SinkError("HTTP 400", retryable=False)
        if behavior == BEHAVIOR_HANG:
            self._sleep(self._hang_s)
            raise SinkError("timed out", retryable=True)
        raise SinkError(f"unhandled behavior {behavior}", retryable=True)

    def received_payloads(self) -> list[dict]:
        return [p for _, batch in self.received for p in batch]


class _FaultHandler(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        server: FaultInjectingHTTPServer = self.server  # type: ignore[assignment]
        behavior = server.schedule.next_behavior()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if behavior == BEHAVIOR_REFUSE:
            # Drop the connection with no status line: the client sees a
            # reset / bad status, i.e. the collector pod is gone.  Swap
            # in an in-memory wfile so the server's own post-request
            # flush doesn't stack-trace over the closed socket.
            import io

            self.close_connection = True
            self.connection.close()
            self.wfile = io.BytesIO()
            return
        if behavior == BEHAVIOR_HANG:
            time.sleep(server.hang_s)
            self.send_response(503)
            self.end_headers()
            return
        if behavior == BEHAVIOR_5XX:
            self.send_response(503)
            self.end_headers()
            return
        if behavior == BEHAVIOR_4XX:
            self.send_response(400)
            self.end_headers()
            return
        server.record(body)
        self.send_response(202)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *args):
        pass


class FaultInjectingHTTPServer(ThreadingHTTPServer):
    """Localhost OTLP-shaped endpoint with scripted failures."""

    daemon_threads = True

    def __init__(
        self,
        schedule: FaultSchedule | str,
        host: str = "127.0.0.1",
        port: int = 0,
        # Must exceed the OTLP client's 5s default timeout, or "hang"
        # degrades into a slow 5xx and never drives the client's
        # timeout-classification path.
        hang_s: float = 6.0,
    ):
        super().__init__((host, port), _FaultHandler)
        self.schedule = (
            schedule if isinstance(schedule, FaultSchedule)
            else FaultSchedule(schedule)
        )
        self.hang_s = hang_s
        self._record_lock = threading.Lock()
        self.bodies: list[bytes] = []
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}/v1/logs"

    def record(self, body: bytes) -> None:
        with self._record_lock:
            self.bodies.append(body)

    def accepted_log_records(self) -> list[dict]:
        """Flatten every accepted OTLP logs payload into log records."""
        records: list[dict] = []
        with self._record_lock:
            bodies = list(self.bodies)
        for body in bodies:
            try:
                payload = json.loads(body)
            except json.JSONDecodeError:
                continue
            for rl in payload.get("resourceLogs", []):
                for sl in rl.get("scopeLogs", []):
                    records.extend(sl.get("logRecords", []))
        return records

    def start(self) -> "FaultInjectingHTTPServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name="fault-sink", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
