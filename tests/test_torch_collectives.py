"""The port's collectives over a mesh (``tpuslo_torch.parallel.mesh``'s
wrappers), its active prober (``tpuslo_torch.parallel.collectives``) and
``python -m tpuslo_torch icibench``, on gloo ranks on the CPU.

* each wrapper over 2 and 4 spawned ranks against numpy on the same
  seeded inputs (exact: f32 sums of small integers, and a bf16 sum);
* the prober's measurements over 2 ranks (ops, shapes, quantiles);
* the same probe numbers through JAX's ``probes_to_events`` and the
  port's give the same dicts field by field;
* the CLI writes schema-valid JSONL over ``--force-cpu-devices``, refuses
  unknown ops (exit 2) before any process group starts, and without a
  card and without that flag exits 2;
* ``ActiveICIProber``'s interval, disable and timeout behaviour
  (``tests/test_collectives.py``), over a one-rank gloo group in the test
  process.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import test_torch_tp_ranks as ranks  # noqa: E402
from tpuslo.parallel import collectives as jc  # noqa: E402
from tpuslo_torch.cli import icibench  # noqa: E402
from tpuslo_torch.parallel import collectives as tc  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402
from tpuslo_torch.schema.fastpath import validate_probe_event, validate_probe_payload  # noqa: E402


@pytest.mark.parametrize("world", [2, 4])
def test_each_collective_equals_numpy(world):
    rng = np.random.default_rng(world)
    x = rng.integers(-8, 8, size=(world, 2 * world, 3)).astype(np.float32)
    got = tmesh.run_ranks(ranks.collective_ops, world, timeout_s=ranks.RANK_TIMEOUT_S,
                          args=(x,))
    total = x.sum(axis=0)
    chunk = x.shape[1] // world
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["all_reduce"], total)
        np.testing.assert_array_equal(out["all_reduce_bf16"], total)  # exact in bf16
        np.testing.assert_array_equal(out["all_gather"], x.reshape(-1, 3))
        np.testing.assert_array_equal(out["reduce_scatter"], total[r * chunk:(r + 1) * chunk])
        np.testing.assert_array_equal(out["shift"], x[(r - 1) % world])
        np.testing.assert_array_equal(
            out["all_to_all"], np.concatenate([x[j, r * chunk:(r + 1) * chunk]
                                               for j in range(world)]))
        assert out["calls"] == {"all_reduce": 2, "all_gather": 1, "reduce_scatter": 1,
                                "shift": 1, "all_to_all": 1}


def test_bench_collectives_over_two_ranks():
    for probes in tmesh.run_ranks(ranks.probe_suite, 2, timeout_s=ranks.RANK_TIMEOUT_S):
        assert [p["op"] for p in probes] == list(tc.DEFAULT_OPS) == list(jc.DEFAULT_OPS)
        for p in probes:
            assert p["n_devices"] == 2
            assert p["payload_bytes_per_device"] == 16 * 1024
            assert p["reps"] == 2
            assert 0 < p["min_ms"] <= p["p50_ms"] <= p["p95_ms"]


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown collective"):
        tc._collective_fn("alltofoo", None, "tp")


def test_probe_events_equal_jax_field_by_field():
    """JAX's test probes (a healthy psum, an erroring all_gather) through
    both packages' ``probes_to_events`` at one instant."""
    fields = [dict(op="psum", n_devices=8, payload_bytes_per_device=1024, reps=5,
                   mean_ms=2.0, p50_ms=1.8, p95_ms=2.5, min_ms=1.5),
              dict(op="all_gather", n_devices=8, payload_bytes_per_device=1024, reps=5,
                   mean_ms=40.0, p50_ms=38.0, p95_ms=45.0, min_ms=30.0),
              dict(op="ppermute", n_devices=2, payload_bytes_per_device=262144, reps=3,
                   mean_ms=12.34567, p50_ms=11.11111, p95_ms=20.0, min_ms=9.87654)]
    now = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    kw = dict(slice_id="slice-0", host_index=1, now=now)
    want = jc.probes_to_events([jc.CollectiveProbe(**f) for f in fields], **kw)
    got = tc.probes_to_events([tc.CollectiveProbe(**f) for f in fields], **kw)
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    assert [tc.CollectiveProbe(**f).to_dict() for f in fields] == [
        jc.CollectiveProbe(**f).to_dict() for f in fields]
    assert all(validate_probe_event(e) for e in got)
    assert [e.status for e in got[:2]] == ["ok", "error"]  # 2.5 ms under 10, 45 over 30
    assert got[0].tpu.module_name == "collective:psum"


def test_icibench_cli_writes_valid_jsonl(tmp_path, capsys):
    out = tmp_path / "ici.jsonl"
    rc = icibench.main(["--force-cpu-devices", "2", "--payload-kb", "64", "--reps", "2",
                        "--ops", "psum,ppermute", "--output", str(out),
                        "--slice-id", "slice-7"])
    assert rc == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(lines) == 2
    assert {e["tpu"]["module_name"] for e in lines} == {"collective:psum",
                                                         "collective:ppermute"}
    assert all(e["signal"] == "ici_collective_latency_ms" for e in lines)
    assert all(e["tpu"]["slice_id"] == "slice-7" for e in lines)
    assert all(validate_probe_payload(e) for e in lines)
    assert "(gloo)" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--ops", "psumm"], ["--ops", ""],
                                  ["--multiprocess", "2", "--ops", "bogus"],
                                  ["--force-cpu-devices", "2", "--ops", "psum,nope"]])
def test_icibench_refuses_unknown_ops_before_any_group(argv, monkeypatch, capsys, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(tmesh, "run_ranks", refuse)
    from tpuslo_torch.parallel import distributed

    monkeypatch.setattr(distributed, "run_distributed_probe", refuse)
    out = tmp_path / "x.jsonl"
    assert icibench.main(argv + ["--output", str(out)]) == 2
    assert "unknown ops" in capsys.readouterr().err
    assert not out.exists()


def test_icibench_without_a_card_or_cpu_ranks_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert icibench.main(["--reps", "1"]) == 2
    assert "--force-cpu-devices" in capsys.readouterr().err


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in the test process (the prober's default
    suite runs over the initialized group)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_active_prober_interval_reuse_and_disable(one_rank_group):
    logs = []
    prober = tc.ActiveICIProber(interval_s=100.0, payload_kb=16, reps=1, log=logs.append,
                                slice_id="s0", host_index=0)
    events = prober.maybe_probe(now_monotonic=10.0)
    assert len(events) == 4
    assert all(validate_probe_event(e) for e in events)
    suite = prober._suite
    assert isinstance(suite, tc.CollectiveSuite) and suite.n_devices == 1
    assert prober.maybe_probe(now_monotonic=50.0) == []  # not due yet
    assert prober.maybe_probe(now_monotonic=111.0) != []
    assert prober._suite is suite  # built once, replayed after

    broken = tc.ActiveICIProber(interval_s=1.0, log=logs.append)

    def boom(**kw):
        raise RuntimeError("backend gone")

    orig = tc.CollectiveSuite
    tc.CollectiveSuite = boom
    try:
        assert broken.maybe_probe(0.0) == []
        assert broken._disabled
        assert any("disabled" in line for line in logs)
        tc.CollectiveSuite = orig
        assert broken.maybe_probe(1000.0) == []  # stays off
    finally:
        tc.CollectiveSuite = orig


def test_prober_without_a_group_disables_itself():
    logs = []
    prober = tc.ActiveICIProber(interval_s=1.0, log=logs.append)
    assert prober.maybe_probe(0.0) == []
    assert prober._disabled and any("process group" in line or "torch.distributed" in line
                                    for line in logs)


def test_prober_timeout_disables_instead_of_stalling():
    """A collective whose peer is gone hangs with no exception: the
    prober's worker-thread join timeout disables it and returns."""
    import threading
    import time

    logs = []
    prober = tc.ActiveICIProber(interval_s=1.0, log=logs.append, timeout_s=0.3)
    release = threading.Event()
    prober._probe_once = lambda: release.wait(30.0)
    t0 = time.perf_counter()
    assert prober.maybe_probe(0.0) == []
    elapsed = time.perf_counter() - t0
    release.set()
    assert elapsed < 5.0
    assert prober._disabled
    assert any("hang" in line for line in logs)
    assert prober.maybe_probe(1000.0) == []
