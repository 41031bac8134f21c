"""The port's agent, ``python -m tpuslo_torch agent``, held to ``python -m
tpuslo agent``.

Both agents' ``main`` run in this process on the CPU with the same argv,
each with its own Prometheus registry.  The synthetic loop's rows must
be equal for every synthetic scenario, with the burn engine, and with
remediation on, masking only the fields that carry the wall clock
(:data:`CLOCK_FIELDS`, which both packages must show to be exactly the
fields two runs of one agent disagree on).  With the agents' clocks
frozen to one stepping instant, the OTLP bodies and the webhook bodies
and HMAC headers they send to a local stub server must be equal.  The
port's deferred lanes exit 2 naming the slice that brings them, a
device lane under ``--device cuda`` exits 2 without a card, the active
collective prober over a one-rank gloo group (``--device cpu``) emits
JAX's prober rows (values aside), the synthetic loop imports no
``torch``, and SIGTERM drains and exits 0 with the final snapshot.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from tpuslo.cli import agent as jagent
from tpuslo.collector import supported_synthetic_scenarios
from tpuslo_torch.cli import agent as tagent

ROOT = Path(__file__).resolve().parents[1]
AGENTS = {"jax": jagent, "port": tagent}
# The fields that carry the wall clock: an SLO event's timestamp and a
# probe event's nanosecond stamp.  Nothing else may differ.
CLOCK_FIELDS = {"timestamp", "ts_unix_nano"}
COMMON = ["--interval-s", "0", "--metrics-port", "0", "--max-overhead-pct", "1000"]


def run_agent(side: str, argv: list[str], tmp_path: Path, name: str):
    """One agent's ``main`` in this process: (exit code, rows, stderr)."""
    out = tmp_path / f"{side}-{name}.jsonl"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = AGENTS[side].main([*argv, *COMMON, "--output", "jsonl",
                                "--jsonl-path", str(out)])
    rows = ([json.loads(line) for line in out.read_text().splitlines() if line.strip()]
            if out.exists() else [])
    return rc, rows, err.getvalue()


def differing(a, b, prefix: str = "") -> set[str]:
    """The dotted paths at which two rows differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out: set[str] = set()
        for key in set(a) | set(b):
            out |= differing(a.get(key), b.get(key), f"{prefix}{key}.")
        return out
    return set() if a == b else {prefix.rstrip(".")}


def masked(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in row.items() if k not in CLOCK_FIELDS} for row in rows]


@pytest.mark.parametrize("side", sorted(AGENTS))
def test_the_clock_fields_are_the_only_ones_two_runs_disagree_on(side, tmp_path):
    argv = ["--scenario", "tpu_mixed", "--count", "3", "--event-kind", "both"]
    _, first, _ = run_agent(side, argv, tmp_path, "first")
    time.sleep(0.002)
    _, second, _ = run_agent(side, argv, tmp_path, "second")
    assert len(first) == len(second) > 0
    assert set().union(*(differing(a, b) for a, b in zip(first, second))) == CLOCK_FIELDS


@pytest.mark.parametrize("scenario", supported_synthetic_scenarios())
def test_synthetic_rows_equal_jax(scenario, tmp_path):
    argv = ["--scenario", scenario, "--count", "3", "--event-kind", "both"]
    jrc, jrows, _ = run_agent("jax", argv, tmp_path, scenario)
    trc, trows, _ = run_agent("port", argv, tmp_path, scenario)
    assert jrc == trc == 0
    assert len(jrows) == len(trows) > 0
    assert masked(trows) == masked(jrows)


def _stderr_lines(text: str, *needles: str) -> list[str]:
    return [ln for ln in text.splitlines() if any(n in ln for n in needles)]


@pytest.mark.parametrize("extra", [
    ["--burn-engine"],
    ["--burn-engine", "--remediate", "--webhook-url", "STUB"],
], ids=["burn_engine", "remediation"])
def test_burn_engine_and_remediation_rows_and_decisions_equal_jax(extra, tmp_path, stub):
    extra = [f"{stub.url}/hook" if a == "STUB" else a for a in extra]
    argv = ["--scenario", "ici_drop", "--count", "12", "--event-kind", "both", *extra]
    jrc, jrows, jerr = run_agent("jax", argv, tmp_path, "burn")
    trc, trows, terr = run_agent("port", argv, tmp_path, "burn")
    assert jrc == trc == 0
    assert masked(trows) == masked(jrows)
    needles = ("burn engine on", "burn alert", "remediation")
    decisions = _stderr_lines(jerr, *needles)
    assert decisions and _stderr_lines(terr, *needles) == decisions
    if "--remediate" in extra:
        assert any("agent: remediation: " in ln for ln in decisions)


class _Stub:
    """A local HTTP sink that records every POST and answers 200."""

    def __init__(self):
        self.requests: list[tuple[str, dict, bytes]] = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server's name
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                stub.requests.append((self.path, dict(self.headers), body))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def take(self) -> list[tuple[str, dict, bytes]]:
        taken, self.requests = self.requests, []
        return taken

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def stub():
    s = _Stub()
    yield s
    s.close()


T0 = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)


def freeze_clocks(monkeypatch):
    """Both agents read one stepping instant (1 ms a call, from T0) and both
    exporters one fixed nanosecond stamp."""
    for side, pkg in (("jax", "tpuslo"), ("port", "tpuslo_torch")):
        calls = [0]

        class Clock(datetime):
            @classmethod
            def now(cls, tz=None, calls=calls):
                calls[0] += 1
                return T0 + timedelta(milliseconds=calls[0])

        monkeypatch.setattr(AGENTS[side], "datetime", Clock)
        exporters = sys.modules[f"{pkg}.otel.exporters"]
        monkeypatch.setattr(exporters, "time",
                            types.SimpleNamespace(time_ns=lambda: 1_767_323_045_000_000_000))


def _run_posting(side: str, argv: list[str]) -> int:
    with contextlib.redirect_stderr(io.StringIO()):
        return AGENTS[side].main([*argv, *COMMON])


def test_otlp_bodies_equal_jax(stub, monkeypatch):
    freeze_clocks(monkeypatch)
    argv = ["--scenario", "hbm_pressure", "--count", "3", "--event-kind", "both",
            "--output", "otlp", "--otlp-endpoint", f"{stub.url}/v1/logs"]
    sent = {}
    for side in ("jax", "port"):
        assert _run_posting(side, argv) == 0
        sent[side] = stub.take()
    assert len(sent["jax"]) == 6  # an SLO and a probe batch a cycle
    assert [(p, body) for p, _, body in sent["port"]] == [
        (p, body) for p, _, body in sent["jax"]]
    assert [h["Content-Type"] for _, h, _ in sent["port"]] == [
        h["Content-Type"] for _, h, _ in sent["jax"]]


@pytest.mark.parametrize("fmt", ["generic", "pagerduty", "opsgenie"])
def test_webhook_bodies_and_hmac_headers_equal_jax(stub, monkeypatch, fmt):
    freeze_clocks(monkeypatch)
    argv = ["--scenario", "xla_recompile_storm", "--count", "3", "--event-kind", "probe",
            "--output", "stdout", "--webhook-url", f"{stub.url}/hook",
            "--webhook-secret", "s3cret", "--webhook-format", fmt, "--burn-engine"]
    sent = {}
    for side in ("jax", "port"):
        with contextlib.redirect_stdout(io.StringIO()):
            assert _run_posting(side, argv) == 0
        sent[side] = stub.take()
    assert len(sent["jax"]) == 3
    for (jp, jh, jb), (tp, th, tb) in zip(sent["jax"], sent["port"], strict=True):
        assert (tp, tb) == (jp, jb)
        assert th["X-Webhook-Signature"] == jh["X-Webhook-Signature"]
        assert {k: v for k, v in th.items() if k != "Host"} == {
            k: v for k, v in jh.items() if k != "Host"}


@pytest.mark.parametrize("argv, item", [
    (["--columnar"], "17b"),
    (["--fleet-upstream", "up.jsonl"], "17b"),
    (["--profile-device"], "17b"),
    (["--profiler-source", "synthetic"], "17b"),
    (["--chaos-telemetry", "1.0"], "17c"),
    (["--config", "INGEST"], "17b"),
], ids=["columnar", "fleet_upstream", "profile_device", "profiler_source",
        "chaos_telemetry", "ingest_config"])
def test_deferred_lanes_exit_2_and_name_their_slice(argv, item, tmp_path, capsys):
    if argv[-1] == "INGEST":
        cfg = tmp_path / "toolkit.yaml"
        cfg.write_text("ingest:\n  dedup_window: 64\n")
        argv = ["--config", str(cfg)]
    rc = tagent.main([*argv, "--count", "1", *COMMON])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"ROADMAP item {item}" in err and "not ported yet" in err


@pytest.mark.parametrize("argv, lane", [
    (["--ici-probe-interval-s", "1"], "collective prober"),
    (["--probe-source", "ring", "--signal-set", "hbm_utilization_pct"], "HBM sampler"),
], ids=["prober", "hbm_sampler"])
def test_a_device_lane_without_a_card_exits_2(argv, lane, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
    rc = tagent.main([*argv, "--count", "1", *COMMON, "--device", "cuda"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "no CUDA device" in err and lane in err


def test_prober_rows_equal_jax_values_aside(tmp_path):
    argv = ["--scenario", "ici_drop", "--count", "2", "--event-kind", "probe",
            "--ici-probe-interval-s", "3600", "--ici-probe-payload-kb", "16"]
    _, jrows, _ = run_agent("jax", argv, tmp_path, "ici")
    trc, trows, terr = run_agent("port", [*argv, "--device", "cpu"], tmp_path, "ici")
    assert trc == 0 and "prober disabled" not in terr

    def prober_rows(rows):
        return [{k: v for k, v in r.items() if k not in ("value", "status", "ts_unix_nano")}
                for r in rows if r["signal"] == "ici_collective_latency_ms"
                and r.get("pod") == "icibench"]

    want = prober_rows(jrows)
    assert len(want) == 4  # one probe round, four collectives
    assert prober_rows(trows) == want
    assert all(r["value"] > 0 for r in trows if r.get("pod") == "icibench")
    import torch.distributed as dist

    assert not dist.is_initialized()  # the agent took its group down


def test_the_synthetic_loop_imports_no_torch(tmp_path):
    code = (
        "import sys\n"
        "from tpuslo_torch.cli import agent\n"
        f"rc = agent.main(['--count', '2', '--interval-s', '0', '--metrics-port', '0', "
        f"'--output', 'jsonl', '--jsonl-path', {str(tmp_path / 'rows.jsonl')!r}, "
        "'--webhook-url', 'http://127.0.0.1:9/hook', '--scenario', 'dns_latency', "
        "'--burn-engine', '--max-overhead-pct', '1000'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'tpuslo', 'yaml'))\n"
        "print(rc, bad)\n"
        "sys.exit(0 if rc == 0 and not bad else 1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


class TestAgentSigterm:
    """SIGTERM takes the drain path: exit 0 with the final snapshot."""

    def test_sigterm_exits_zero_with_final_snapshot(self, tmp_path):
        out = tmp_path / "events.jsonl"
        state_dir = tmp_path / "state"
        cmd = [
            sys.executable, "-m", "tpuslo_torch", "agent",
            "--scenario", "dns_latency",
            "--count", "0",  # run forever; only the signal stops it
            "--interval-s", "0.05",
            "--event-kind", "both",
            "--output", "jsonl",
            "--jsonl-path", str(out),
            "--capability-mode", "bcc_degraded",
            "--metrics-port", "0",
            "--max-overhead-pct", "1000",
            "--state-dir", str(state_dir),
            "--snapshot-interval-s", "0",
        ]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            # The signal handler installs just before the loop starts, so
            # the first row means the drain path is armed.
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                if out.exists() and out.stat().st_size > 0:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("agent never started emitting")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        stderr = proc.stderr.read()
        assert rc == 0, stderr
        drain = [ln for ln in stderr.splitlines() if "drain:" in ln]
        assert drain and "reason=signal_15" in drain[0]
        assert "final_snapshot=ok" in drain[0]
        snapshot = json.loads((state_dir / "agent-state.json").read_text())
        progress = snapshot["components"]["progress"]
        cycles = {json.loads(line)["trace_id"] for line in out.read_text().splitlines()
                  if line.strip()}
        # The signal may land mid-cycle: the cycle being written when it
        # arrived is durable in the output but not yet in progress.
        assert len(cycles) > 0
        assert progress["next_cycle"] >= len(cycles) - 1
        assert progress["next_cycle"] >= 1


def test_the_dispatcher_lists_the_agent(capsys):
    from tpuslo_torch import __main__ as dispatch

    assert dispatch.main(["--help"]) == 0
    assert "agent" in capsys.readouterr().out
    assert os.path.exists(ROOT / "tpuslo_torch" / "cli" / "agent.py")


def _span_names(body: bytes) -> list[str]:
    doc = json.loads(body)
    return sorted(span["name"] for rs in doc["resourceSpans"] for ss in rs["scopeSpans"]
                  for span in ss["spans"])


def test_self_traced_cycles_export_jaxs_spans(stub):
    """``--trace``: every cycle kept (sample rate 1) is exported as OTLP
    traces with JAX's span tree (ids and times aside)."""
    argv = ["--scenario", "dns_latency", "--count", "3", "--event-kind", "both",
            "--output", "stdout", "--trace", "--trace-sample-rate", "1",
            "--trace-endpoint", f"{stub.url}/v1/traces"]
    sent = {}
    for side in ("jax", "port"):
        with contextlib.redirect_stdout(io.StringIO()):
            assert _run_posting(side, argv) == 0
        sent[side] = [(p, _span_names(b)) for p, _, b in stub.take()]
    assert sent["jax"] and all(p == "/v1/traces" for p, _ in sent["jax"])
    assert sent["port"] == sent["jax"]
