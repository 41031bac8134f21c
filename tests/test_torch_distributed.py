"""The port's multi-process straggler prober
(``tpuslo_torch.parallel.distributed``, ``python -m tpuslo_torch icibench
--multiprocess N``): N OS processes in one gloo group on the CPU, timing
real cross-process all_reduce launches, as JAX's workers do in one
``jax.distributed`` runtime (``tests/test_distributed.py``).

The physics is real: the collective holds the punctual hosts until the
delayed one arrives, so the port's ``SliceJoiner`` names the delayed
host.  A crashed worker kills the survivors under one deadline, and two
slices measure a cross-slice (dcn) component.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest

pytest.importorskip("torch")

from tpuslo_torch.parallel import distributed as tdist  # noqa: E402
from tpuslo_torch.schema.fastpath import validate_probe_payload  # noqa: E402


def test_the_delayed_host_is_attributed():
    """3 hosts, host 1 delayed 200 ms per launch: every incident names it,
    the punctual hosts measured about the delay, the straggler sailed
    through."""
    report = tdist.run_distributed_probe(n_processes=3, launches=4, delay_ms=200.0,
                                         delayed_host=1, timeout_s=240.0)
    assert report["errors"] == []
    assert report["mechanism"] == "torch_distributed_gloo"
    assert report["events_measured"] == 12
    assert report["correct_attributions"] == 4
    assert report["incidents"] and all(i["straggler_host"] == 1 for i in report["incidents"])
    assert report["top_confidence"] >= 0.7
    lat = report["incidents"][0]["host_latencies_ms"]
    assert lat["0"] > 150.0 and lat["2"] > 150.0 and lat["1"] < 50.0
    assert all(validate_probe_payload(e) for e in report["events"])
    assert {e["tpu"]["program_id"] for e in report["events"]} == {tdist.PROGRAM_ID}


@pytest.mark.slow  # as JAX's: a descheduled process under load reads as a straggler
def test_a_healthy_run_has_no_incident():
    report = tdist.run_distributed_probe(n_processes=2, launches=3, timeout_s=240.0)
    assert report["errors"] == []
    assert report["events_measured"] == 6
    assert report["incidents"] == []


def test_crashed_worker_kills_survivors_under_one_deadline(monkeypatch):
    """JAX's test: the survivors would block forever in the collective,
    so the probe kills them as soon as the crash is seen (one shared
    deadline), not after N sequential timeouts."""

    class FakeProc:
        def __init__(self, rc, out="", err="", exits_after=0.0):
            self._rc, self._out, self._err = rc, out, err
            self._born = time.monotonic()
            self._exits_after = exits_after
            self.killed = False
            self.returncode = None

        def poll(self):
            if self.killed:
                self.returncode = -9
                return self.returncode
            if time.monotonic() - self._born >= self._exits_after:
                self.returncode = self._rc
                return self.returncode
            return None

        def kill(self):
            self.killed = True
            self.returncode = -9

        def communicate(self, timeout=None):
            return self._out, self._err

    crasher = FakeProc(rc=1, err="boom: gloo rendezvous failed", exits_after=0.1)
    hung = FakeProc(rc=0, exits_after=3600.0)
    procs = iter([crasher, hung])
    monkeypatch.setattr(tdist, "subprocess",
                        types.SimpleNamespace(Popen=lambda *a, **k: next(procs), PIPE=-1))
    t0 = time.monotonic()
    report = tdist.run_distributed_probe(n_processes=2, timeout_s=300.0)
    assert time.monotonic() - t0 < 10.0
    assert hung.killed
    assert any("peer exited nonzero" in e for e in report["errors"])
    assert any("boom" in e for e in report["errors"])


def test_a_real_crashed_worker_kills_the_survivor():
    """A worker that exits before joining (an unknown flag ends it) leaves
    its peer waiting at the group's rendezvous: the probe kills it at
    once."""
    t0 = time.monotonic()
    report = tdist.run_distributed_probe(n_processes=2, launches=2, n_slices=3,
                                         timeout_s=120.0)
    assert time.monotonic() - t0 < 60.0
    assert report["events_measured"] == 0 and report["errors"]


def test_two_slices_measure_the_dcn_component():
    """2 hosts as 2 slices, host 1 delayed: the punctual host's
    cross-slice component carries the stall, the intra-slice rounds
    (one host each) stay clean, and the join blames the dcn path of
    host 1's slice."""
    report = tdist.run_distributed_probe(n_processes=2, launches=3, delay_ms=200.0,
                                         delayed_host=1, n_slices=2, timeout_s=240.0)
    assert report["errors"] == []
    assert report["n_slices"] == 2 and report["dcn_events"] == 6
    dcn = [e for e in report["events"] if e["signal"] == "dcn_transfer_latency_ms"]
    intra = [e for e in report["events"] if e["signal"] == "ici_collective_latency_ms"]
    assert max(e["value"] for e in dcn if e["tpu"]["host_index"] == 0) > 150.0
    assert all(e["value"] < 50.0 for e in intra)
    assert {e["tpu"]["slice_id"] for e in dcn} == {"dist-slice-0", "dist-slice-1"}
    assert report["correct_attributions"] == 3
    assert report["incidents"][0]["cause"] == "dcn_path"
    assert report["incidents"][0]["straggler_slice"] == "dist-slice-1"
    assert report["dcn_transfer_ms_max"] > 0


def test_four_hosts_two_slices_attribute_at_slice_level():
    report = tdist.run_distributed_probe(n_processes=4, launches=2, delay_ms=200.0,
                                         delayed_host=1, n_slices=2, timeout_s=240.0)
    assert report["errors"] == []
    dcn_incidents = [i for i in report["incidents"] if i["cause"] == "dcn_path"]
    assert dcn_incidents and all(i["straggler_slice"] == "dist-slice-0"
                                 for i in dcn_incidents)
    intra = [i for i in report["incidents"]
             if i["cause"] != "dcn_path" and i["slice_id"] == "dist-slice-0"]
    assert intra and all(i["straggler_host"] == 1 for i in intra)


def test_icibench_multiprocess_cli(tmp_path):
    out, report_path = tmp_path / "dist.jsonl", tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpuslo_torch", "icibench", "--multiprocess", "2",
         "--reps", "2", "--delay-host", "0", "--delay-ms", "120",
         "--output", str(out), "--report", str(report_path)],
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(events) == 4
    assert all(validate_probe_payload(e) and e["signal"] == "ici_collective_latency_ms"
               for e in events)
    report = json.loads(report_path.read_text())
    assert report["correct_attributions"] == 2
    assert "events" not in report
    assert "cross-process events" in proc.stderr


@pytest.mark.parametrize("argv,message", [
    (["--multiprocess", "2", "--delay-host", "2"], "out of range"),
    (["--multiprocess", "2", "--n-slices", "3"], "must divide"),
])
def test_icibench_multiprocess_flag_validation(argv, message, tmp_path, capsys, monkeypatch):
    from tpuslo_torch.cli import icibench

    def refuse(*a, **k):
        raise AssertionError("workers were started")

    monkeypatch.setattr(tdist, "run_distributed_probe", refuse)
    out = tmp_path / "x.jsonl"
    assert icibench.main(argv + ["--output", str(out)]) == 2
    assert message in capsys.readouterr().err
    assert not out.exists()
