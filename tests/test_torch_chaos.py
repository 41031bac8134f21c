"""The port's fault injectors (``tpuslo_torch.chaos``) against the JAX
package's (``tpuslo.chaos`` and ``scripts/chaos/injectors``).

Both packages' delayed-host straggler runs on the same arguments give
reports of the same keys, and each of the port's launches names the
delayed host.  The straggler assertions rest on what the barrier
guarantees, not on absolute times: the delayed host arrives last, so it
has the shortest wait of its launch, and every other host waits for it,
longer than half the delay.  The contention attribution is JAX's
calibrated attributor's on the same measured p95 (domain equal,
confidence to 1e-9); the contention itself runs over 2 gloo ranks on the
CPU.  The injectors' command lines exit 2 with a ``"real": false``
report where no card answers (this box has none), and their ``--device
cpu`` reports carry JAX's keys on its CPU device.
"""

from __future__ import annotations

import functools
import json
import os
import runpy
import socket
import subprocess
import sys
import threading
from datetime import datetime, timezone
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tpuslo.chaos import run_straggler_injection as jax_straggler  # noqa: E402
from tpuslo_torch.chaos import backend_guard, ici_contention  # noqa: E402
from tpuslo_torch.chaos.injectors import hbm_pressure, xla_recompile_storm  # noqa: E402
from tpuslo_torch.chaos.injectors import ici_contention as ici_cli  # noqa: E402
from tpuslo_torch.schema.fastpath import validate_probe_payload  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_CONTENTION_KEYS = {"injector", "mechanism", "real", "n_devices", "storm_dispatches",
                       "baseline_p95_ms", "contended_p95_ms", "degradation", "events",
                       "attribution"}

_ATTRIBUTORS: dict = {}


@pytest.fixture
def cached_attributor(monkeypatch):
    """Both packages' calibrated attributors, fitted once (each fit takes
    seconds; the fit is seeded, so a cached one is the same)."""
    from tpuslo.attribution import calibrate as jc
    from tpuslo_torch.attribution import calibrate as tc

    if not _ATTRIBUTORS:
        _ATTRIBUTORS["jax"] = jc.calibrated_attributor()
        _ATTRIBUTORS["torch"] = tc.calibrated_attributor()
    monkeypatch.setattr(tc, "calibrated_attributor", lambda: _ATTRIBUTORS["torch"])
    return _ATTRIBUTORS


def _hold_barrier(report: dict, delay_ms: float, delayed: int) -> None:
    """What the barrier guarantees in every launch."""
    assert report["events_measured"] == report["n_hosts"] * report["launches"]
    assert report["correct_attributions"] == report["launches"]
    assert len(report["incidents"]) == report["launches"]
    for incident in report["incidents"]:
        assert incident["straggler_host"] == delayed
        assert incident["cause"] == "compute_straggler"
        lat = {int(h): ms for h, ms in incident["host_latencies_ms"].items()}
        assert min(lat, key=lat.get) == delayed, lat
        assert all(ms > delay_ms / 2 for h, ms in lat.items() if h != delayed), lat


def test_straggler_in_process_matches_jax_report():
    args = dict(n_hosts=3, launches=5, delay_ms=120.0, delayed_host=1, in_process=True)
    got = ici_contention.run_straggler_injection(**args)
    want = jax_straggler(**args)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("injector", "mechanism", "real", "n_hosts", "launches",
                                "delay_ms", "delayed_host", "events_measured")} == \
        {k: want[k] for k in ("injector", "mechanism", "real", "n_hosts", "launches",
                              "delay_ms", "delayed_host", "events_measured")}
    _hold_barrier(got, 120.0, 1)
    assert set(got["incidents"][0]) == set(want["incidents"][0])
    assert got["top_confidence"] >= 0.7


def test_straggler_other_delayed_host():
    report = ici_contention.run_straggler_injection(
        n_hosts=2, launches=3, delay_ms=100.0, delayed_host=0, in_process=True)
    _hold_barrier(report, 100.0, 0)


def test_straggler_host_processes():
    """The deployment shape: one OS process per host (``python -m
    tpuslo_torch.chaos.ici_contention --worker``), events over stdout
    JSONL.  The start gate releases the hosts together, so their start-up
    skew is not read as a straggler."""
    report = ici_contention.run_straggler_injection(
        n_hosts=2, launches=2, delay_ms=80.0, delayed_host=1, in_process=False)
    _hold_barrier(report, 80.0, 1)
    assert report["top_confidence"] >= 0.7


def test_straggler_events_are_schema_valid():
    result = {}

    def coordinator(server):
        ici_contention._barrier_coordinator(server, 1, 2)

    with socket.socket() as server:
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        port = server.getsockname()[1]
        t = threading.Thread(target=coordinator, args=(server,), daemon=True)
        t.start()
        result["host"] = ici_contention.barrier_host(port, 0, 2, 0.0, delayed_host=-1)
        t.join(timeout=30)
        assert not t.is_alive()
    events = result["host"].events
    assert len(events) == 2 and all(validate_probe_payload(e) for e in events)
    assert [e["tpu"]["launch_id"] for e in events] == [0, 1]


def test_recv_exact_reassembles_short_reads():
    """TCP may deliver any prefix per recv(); the barrier protocol must
    reassemble the full 8-byte message, and EOF mid-message is None."""
    a, b = socket.socketpair()
    payload = ici_contention._MSG.pack(3, 7)

    def dribble():
        for i in range(len(payload)):
            a.sendall(payload[i:i + 1])
        a.close()

    t = threading.Thread(target=dribble)
    t.start()
    raw = ici_contention._recv_exact(b, ici_contention._MSG.size)
    assert raw == payload
    assert ici_contention._MSG.unpack(raw) == (3, 7)
    assert ici_contention._recv_exact(b, ici_contention._MSG.size) is None
    t.join(timeout=10)
    assert not t.is_alive()
    b.close()


@pytest.mark.parametrize("p95_ms", [0.012, 4.5, 9.938, 31.0, 250.0])
def test_contention_attribution_matches_jax(p95_ms, cached_attributor):
    """The attribution block of ``contention_injection`` on a measured
    p95: the JAX injector's block on the same value."""
    from tpuslo.attribution.mapper import FaultSample

    got = ici_contention.contention_attribution(p95_ms)
    sample = FaultSample(
        incident_id="chaos-ici-contention", timestamp=datetime.now(timezone.utc),
        cluster="local", namespace="llm", service="icibench", fault_label="ici_drop",
        expected_domain="tpu_ici", signals={"ici_collective_latency_ms": p95_ms},
        confidence=0.9, burn_rate=2.0, window_minutes=5, request_id="chaos-req-ici",
        trace_id="chaos-trace-ici")
    want = cached_attributor["jax"].attribute_sample(sample)
    assert got["predicted_domain"] == want.predicted_fault_domain
    assert abs(got["confidence"] - round(want.confidence, 4)) <= 1e-9
    assert got["from_real_signals"] is True


def test_contention_over_two_gloo_ranks(cached_attributor):
    report = ici_contention.run_contention(payload_kb=64, reps=3, storm_size=128, cpu_ranks=2)
    assert set(report) >= JAX_CONTENTION_KEYS
    assert report["real"] is True and report["mechanism"] == "device_contention"
    assert report["n_devices"] == 2 and report["transport"] == "gloo, 2 ranks"
    assert report["device"] == "cpu" and report["storm_dispatches"] > 0
    assert report["baseline_p95_ms"] > 0 and report["contended_p95_ms"] > 0
    assert len(report["events"]) == 4
    assert all(validate_probe_payload(e) for e in report["events"])
    assert {e["signal"] for e in report["events"]} == {"ici_collective_latency_ms"}
    assert report["attribution"]["from_real_signals"] is True


def test_contention_injection_in_an_initialised_group(cached_attributor):
    """The JAX entry, ``contention_injection``, inside a group the caller
    opened (here one gloo rank in this process): the probe over every rank
    of the group, attributed."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        report = ici_contention.contention_injection(payload_kb=16, reps=2, storm_size=64)
    finally:
        dist.destroy_process_group()
    assert set(report) >= JAX_CONTENTION_KEYS
    assert report["transport"] == "gloo, one rank" and report["n_devices"] == 1
    assert report["attribution"] == ici_contention.contention_attribution(
        report["contended_p95_ms"])


def test_contention_without_a_group_names_run_ranks():
    with pytest.raises(RuntimeError, match="run_ranks"):
        ici_contention.contention_injection(payload_kb=16, reps=1)


@pytest.mark.slow
def test_contention_degrades_measured_collectives():
    """JAX's bar on the CPU: the storm degrades the measured collectives
    and the measured value alone is attributed to ``tpu_ici``.  Over 8
    gloo ranks, the shape of JAX's test (its 8-device CPU mesh), at its
    arguments."""
    report = ici_contention.run_contention(payload_kb=256, reps=5, storm_size=512, cpu_ranks=8)
    assert report["degradation"] > 1.0
    assert report["attribution"]["predicted_domain"] == "tpu_ici"


class TestBackendGuard:
    def test_forced_unreachable_writes_the_report(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", "1")
        path = tmp_path / "r.json"
        report = backend_guard.fail_fast_report("hbm_pressure", str(path))
        assert report["real"] is False and report["injector"] == "hbm_pressure"
        assert "unreachable" in report["reason"]
        assert json.loads(path.read_text()) == report

    def test_no_card_names_the_reason(self, monkeypatch):
        monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        reason = backend_guard.backend_unreachable_reason()
        assert "no CUDA device" in reason and "unreachable" in reason

    def test_a_card_that_does_not_answer_times_out(self, monkeypatch):
        hang = threading.Event()
        monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "init", lambda: hang.wait(30))
        try:
            reason = backend_guard.backend_unreachable_reason(timeout_s=0.2)
        finally:
            hang.set()
        assert reason == "CUDA device unreachable: CUDA init did not return in 0.2 s"

    def test_a_card_that_answers_passes(self, monkeypatch):
        monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "init", lambda: None)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1, 2))
        assert backend_guard.backend_unreachable_reason(timeout_s=5) is None
        assert backend_guard.fail_fast_report("x") is None


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("cli", [ici_cli, hbm_pressure, xla_recompile_storm],
                         ids=["ici_contention", "hbm_pressure", "xla_recompile_storm"])
def test_injector_help(cli, capsys):
    with pytest.raises(SystemExit) as done:
        cli.main(["--help"])
    assert done.value.code == 0
    assert "usage" in capsys.readouterr().out


@pytest.mark.parametrize("cli,argv,name", [
    (hbm_pressure, [], "hbm_pressure"),
    (xla_recompile_storm, [], "xla_recompile_storm"),
    (ici_cli, ["--mode", "contention"], "ici_contention"),
], ids=["hbm_pressure", "xla_recompile_storm", "ici_contention"])
def test_injector_without_a_card_exits_2(cli, argv, name, capsys, tmp_path, monkeypatch):
    """This box has no card: each injector reports ``real: false`` with
    the reason and exits 2, never carrying on on the CPU."""
    monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
    assert not torch.cuda.is_available()
    report_path = tmp_path / "r.json"
    extra = [] if cli is ici_cli else ["--report", str(report_path)]
    assert cli.main(argv + extra) == 2
    report = _last_json(capsys.readouterr().out)
    if cli is ici_cli:
        assert report["real"] is False
        report = report["contention"]
    else:
        assert json.loads(report_path.read_text()) == report
    assert report == {"injector": name, "real": False,
                      "reason": "CUDA device unreachable: no CUDA device "
                                "(torch.cuda.is_available() is False)"}


def test_injector_module_entry_exits_2_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "tpuslo_torch.chaos.injectors.xla_recompile_storm"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "TPUSLO_FORCE_BACKEND_UNREACHABLE": "1"})
    assert proc.returncode == 2, proc.stderr
    assert _last_json(proc.stdout)["real"] is False


def _jax_script(name: str, argv: list[str], capsys) -> tuple[int, dict]:
    """A JAX injector script run in this process (JAX on the CPU here)."""
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        with pytest.raises(SystemExit) as done:
            runpy.run_path(str(REPO / "scripts/chaos/injectors" / name), run_name="__main__")
    finally:
        sys.argv = saved
    return done.value.code, _last_json(capsys.readouterr().out)


def test_hbm_pressure_cpu_report_is_jax_cpu_report(capsys, monkeypatch):
    monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
    want_rc, want = _jax_script("hbm_pressure.py", ["--hold-s", "0"], capsys)
    assert hbm_pressure.main(["--device", "cpu", "--hold-s", "0"]) == want_rc == 2
    assert _last_json(capsys.readouterr().out) == want


def test_recompile_storm_cpu_report_keys_are_jax_keys(capsys, monkeypatch):
    monkeypatch.delenv("TPUSLO_FORCE_BACKEND_UNREACHABLE", raising=False)
    want_rc, want = _jax_script("xla_recompile_storm.py", ["--steps", "3", "--base", "16"],
                                capsys)
    assert xla_recompile_storm.main(["--device", "cpu", "--steps", "3", "--base", "16"]) \
        == want_rc == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) | {"mechanism"}
    assert got["mechanism"] == "first_call"
    assert {k: got[k] for k in ("injector", "real", "steps", "backend")} == \
        {k: want[k] for k in ("injector", "real", "steps", "backend")}
    assert 0 < got["compile_ms_p50"] <= got["compile_ms_max"]


def test_ici_cli_straggler_mode_needs_no_card(capsys, monkeypatch, tmp_path):
    """``--mode straggler`` needs no device: exit 0 here (its hosts run as
    threads in this test; the host processes are held above)."""
    monkeypatch.setattr(ici_contention, "run_straggler_injection", functools.partial(
        ici_contention.run_straggler_injection, in_process=True))
    path = tmp_path / "r.json"
    assert ici_cli.main(["--mode", "straggler", "--hosts", "2", "--launches", "2",
                         "--delay-ms", "80", "--report", str(path)]) == 0
    report = _last_json(capsys.readouterr().out)
    assert report["real"] is True and "contention" not in report
    assert report["straggler"]["correct_attributions"] == 2
    assert json.loads(path.read_text()) == report
