"""Multi-host slice correlation: the port's ``SliceJoiner``,
``synthesize_slice_streams`` and ``slicecorr`` CLI against the JAX
package's.

Every scenario of ``tests/test_multihost.py`` is written once, as a
function of one package's module pair (joiner, stream synthesizer), and
run on both: the streams each package synthesizes from the same
arguments must be equal, and so must everything the scenario observes
(incidents field by field, drains, skip counters).  The CLI runs over
per-host JSONL and over a profile directory of per-host card traces.
"""

from __future__ import annotations

import io
import json
import random
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import test_torch_xla_spans as txs  # noqa: E402
from tpuslo.cli import slicecorr as jcli  # noqa: E402
from tpuslo.correlation import multihost as jmh  # noqa: E402
from tpuslo.faultreplay import slice_streams as jss  # noqa: E402
from tpuslo_torch.cli import slicecorr as tcli  # noqa: E402
from tpuslo_torch.correlation import multihost as tmh  # noqa: E402
from tpuslo_torch.faultreplay import slice_streams as tss  # noqa: E402

JAX = SimpleNamespace(mh=jmh, synth=jss.synthesize_slice_streams)
PORT = SimpleNamespace(mh=tmh, synth=tss.synthesize_slice_streams)


def _ingest(joiner, streams):
    for stream in streams:
        joiner.add_all(stream)


def _incidents(incidents):
    return [i.to_dict() for i in incidents]


def _collective(launch, host, ts, value, slice_id="s"):
    return {"signal": "ici_collective_latency_ms", "node": f"host-{host}",
            "ts_unix_nano": ts, "value": value,
            "tpu": {"slice_id": slice_id, "host_index": host, "program_id": "prog",
                    "launch_id": launch}}


def _retry(host, link, ts, value, slice_id="s"):
    return {"signal": "ici_link_retries_total", "node": f"host-{host}",
            "ts_unix_nano": ts, "value": value,
            "tpu": {"slice_id": slice_id, "host_index": host, "ici_link": link}}


# --- the scenarios of tests/test_multihost.py, as functions of a side ------


def compute_straggler(s):
    streams = s.synth(n_hosts=4, n_launches=6, straggler_host=2, straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, streams)
    return streams, _incidents(j.incidents())


def ici_link_cause(s):
    streams = s.synth(n_hosts=4, straggler_host=1, ici_link=3, link_retries_per_launch=5.0)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, streams)
    return streams, _incidents(j.incidents())


def healthy_slice(s):
    streams = s.synth(straggler_delay_ms=0.0)
    j = s.mh.SliceJoiner()
    _ingest(j, streams)
    return streams, _incidents(j.incidents())


def skew_below_floor(s):
    streams = s.synth(base_latency_ms=2.0, straggler_delay_ms=2.0)
    j = s.mh.SliceJoiner()
    _ingest(j, streams)
    return streams, _incidents(j.incidents())


def min_hosts_guard(s):
    streams = s.synth(n_hosts=4, straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner()
    j.add_all(streams[0])
    return streams, _incidents(j.incidents())


def partial_coverage(s):
    streams = s.synth(n_hosts=4, straggler_host=0, straggler_delay_ms=50.0)
    full = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(full, streams)
    partial = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(partial, streams[:2])
    return streams, (_incidents(full.incidents()), _incidents(partial.incidents()))


def no_slice_identity(s):
    j = s.mh.SliceJoiner()
    added = [j.add({"signal": "dns_latency_ms", "value": 5.0}),
             j.add({"signal": "ici_collective_latency_ms", "value": 5.0, "tpu": {}})]
    return [], (added, j.skipped, j.ingested)


def round_trip_json(s):
    streams = s.synth(straggler_delay_ms=50.0, ici_link=1)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, streams)
    return streams, json.loads(json.dumps(j.incidents()[0].to_dict()))


def drain_once(s):
    streams = s.synth(n_hosts=4, n_launches=6, straggler_delay_ms=50.0, ici_link=1)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, streams)
    first, second = _incidents(j.drain()), _incidents(j.drain())
    late = s.synth(n_hosts=4, n_launches=1, straggler_delay_ms=50.0,
                   start_unix_nano=1_700_000_100_000_000_000)
    _ingest(j, late)
    return streams + late, (first, second, len(j._groups), _incidents(j.drain()))


def drain_awaiting_hosts(s):
    streams = s.synth(n_hosts=4, straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner(expected_hosts=4)
    j.add_all(streams[0])
    early, kept = _incidents(j.drain(min_hosts=2)), len(j._groups)
    for stream in streams[1:]:
        j.add_all(stream)
    return streams, (early, kept, _incidents(j.drain(min_hosts=2)))


def drain_stale_groups(s):
    streams = s.synth(n_hosts=4, n_launches=5, straggler_host=1, straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner(expected_hosts=4, pending_horizon_ns=10)
    _ingest(j, streams[:3])
    drained = _incidents(j.drain())
    full = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(full, streams)
    return streams, (drained, len(j._groups), _incidents(full.incidents()))


def drain_learns_membership(s):
    streams = s.synth(n_hosts=4, n_launches=2, straggler_host=3, straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner()
    for stream in streams:
        j.add(stream[0])
    j.add(streams[0][1])
    j.add(streams[1][1])
    first, kept = _incidents(j.drain(min_hosts=2)), len(j._groups)
    j.add(streams[2][1])
    j.add(streams[3][1])
    return streams, (first, kept, _incidents(j.drain(min_hosts=2)))


def drain_horizon_per_slice(s):
    fresh = s.synth(n_hosts=2, n_launches=1, straggler_delay_ms=0.0, slice_id="slice-fresh",
                    start_unix_nano=2_000_000_000_000_000_000)
    lagging = s.synth(n_hosts=4, n_launches=1, straggler_delay_ms=50.0, slice_id="slice-lag",
                      start_unix_nano=1_000_000_000_000_000_000)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, fresh)
    _ingest(j, lagging[:3])
    return fresh + lagging, (_incidents(j.drain()),
                             sorted(g.slice_id for g in j._groups.values()))


def retry_evidence_outlives_pending(s):
    j = s.mh.SliceJoiner(expected_hosts=4, retry_window_ns=100, pending_horizon_ns=5_000)
    j.add(_collective(1, 0, ts=1_000, value=100.0))
    j.add(_collective(1, 1, ts=1_040, value=10.0))
    j.add(_retry(1, link=2, ts=1_040, value=5.0))
    j.add(_retry(0, link=0, ts=4_000, value=1.0))
    early = _incidents(j.drain())
    j.add(_collective(2, 0, ts=9_000, value=10.0))
    return [], (early, _incidents(j.drain()))


def unattributable_single_host(s):
    j = s.mh.SliceJoiner(expected_hosts=4, pending_horizon_ns=10)
    j.add(_collective(1, 0, ts=100, value=10.0))
    j.add(_collective(2, 0, ts=10_000, value=10.0))
    return [], (_incidents(j.drain()), j.dropped_unattributable, len(j._groups))


def ranked_by_confidence(s):
    streams = s.synth(straggler_delay_ms=50.0)
    j = s.mh.SliceJoiner(expected_hosts=4)
    _ingest(j, streams)
    return streams, _incidents(j.incidents())


def shuffled_add_order(s):
    streams = s.synth(n_hosts=4, n_launches=8, straggler_host=1, straggler_delay_ms=45.0,
                      ici_link=3, link_retries_per_launch=4.0)
    flat = [event for stream in streams for event in stream]
    rng = random.Random(7)
    seen = []
    for _ in range(5):
        shuffled = list(flat)
        rng.shuffle(shuffled)
        j = s.mh.SliceJoiner(expected_hosts=4)
        j.add_all(shuffled)
        seen.append(_incidents(j.incidents()))
    return streams, seen


def skips_reason_classed(s):
    j = s.mh.SliceJoiner()
    added = [
        j.add({"signal": "ici_collective_latency_ms"}),
        j.add({"signal": "ici_collective_latency_ms",
               "tpu": {"slice_id": "s0", "host_index": 0}}),
        j.add({"signal": "dns_latency_ms", "tpu": {"slice_id": "s0", "host_index": 0}}),
        j.add({"signal": "ici_collective_latency_ms",
               "tpu": {"slice_id": "s0", "host_index": "corrupt"}}),
    ]
    return [], (added, j.skipped, dict(j.skipped_by_reason))


def corrupt_value(s):
    j = s.mh.SliceJoiner()
    bad = {"signal": "ici_collective_latency_ms", "value": {"nested": "dict"},
           "tpu": {"slice_id": "s0", "host_index": 0, "launch_id": 1, "program_id": "p"}}
    return [], (j.add(bad), j.add(dict(bad, value=5.0)))


SCENARIOS = [compute_straggler, ici_link_cause, healthy_slice, skew_below_floor,
             min_hosts_guard, partial_coverage, no_slice_identity, round_trip_json,
             drain_once, drain_awaiting_hosts, drain_stale_groups, drain_learns_membership,
             drain_horizon_per_slice, retry_evidence_outlives_pending,
             unattributable_single_host, ranked_by_confidence, shuffled_add_order,
             skips_reason_classed, corrupt_value]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_jax(scenario):
    want_streams, want = scenario(JAX)
    got_streams, got = scenario(PORT)
    assert got_streams == want_streams
    assert got == want


def test_the_jax_tests_assertions_hold_on_the_port():
    """A sample of ``tests/test_multihost.py``'s own assertions, made on
    the port's observations."""
    _, incidents = compute_straggler(PORT)
    assert len(incidents) == 6
    assert all(i["straggler_host"] == 2 and i["cause"] == tmh.CAUSE_COMPUTE
               and i["confidence"] >= 0.75 for i in incidents)
    _, incidents = ici_link_cause(PORT)
    assert incidents and all(i["cause"] == tmh.CAUSE_ICI_LINK and i["ici_link"] == 3
                             for i in incidents)
    _, (full, partial) = partial_coverage(PORT)
    assert partial[0]["confidence"] < full[0]["confidence"]
    _, (drained, kept, full) = drain_stale_groups(PORT)
    assert len(drained) == 4 and kept == 1
    assert all(i["straggler_host"] == 1 and i["n_hosts"] == 3 for i in drained)
    _, (added, skipped, by_reason) = skips_reason_classed(PORT)
    assert by_reason == {tmh.SKIP_MISSING_SLICE_IDENTITY: 1, tmh.SKIP_MISSING_LAUNCH_ID: 1,
                         tmh.SKIP_UNMATCHED_SIGNAL: 1, tmh.SKIP_BAD_FIELD_TYPE: 1}


def test_the_defaults_are_jaxs():
    for name in ("DEFAULT_SKEW_RATIO", "DEFAULT_SKEW_FLOOR_MS", "DEFAULT_RETRY_THRESHOLD",
                 "DEFAULT_RETRY_WINDOW_NS", "CAUSE_COMPUTE", "CAUSE_ICI_LINK"):
        assert getattr(tmh, name) == getattr(jmh, name), name


# --- the slicecorr CLI ------------------------------------------------------


def _write_streams(tmp_path, streams, tag):
    paths = []
    for host, stream in enumerate(streams):
        p = tmp_path / f"{tag}-host{host}.jsonl"
        p.write_text("".join(json.dumps(e) + "\n" for e in stream), encoding="utf-8")
        paths.append(str(p))
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_slicecorr_jsonl_equals_jax(tmp_path, capsys):
    streams = tss.synthesize_slice_streams(n_hosts=4, straggler_host=3,
                                           straggler_delay_ms=60.0, ici_link=2)
    paths = _write_streams(tmp_path, streams, "s")
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out, summary = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json"
        rc, _, _ = _run(main, paths + ["--output", str(out), "--summary", str(summary),
                                       "--expected-hosts", "4"], capsys)
        assert rc == 0
        outs[name] = (out.read_text(), json.loads(summary.read_text()))
    assert outs["port"] == outs["jax"]
    incidents = [json.loads(line) for line in outs["port"][0].splitlines()]
    assert incidents and all(i["straggler_host"] == 3 for i in incidents)
    assert outs["port"][1]["by_cause"] == {"ici_link": len(incidents)}


def test_slicecorr_stdin_dash_mixed_with_files(tmp_path, monkeypatch, capsys):
    streams = tss.synthesize_slice_streams(n_hosts=2, n_launches=2, straggler_host=0,
                                           straggler_delay_ms=50.0)
    (p,) = _write_streams(tmp_path, streams[:1], "d")
    stdin = "".join(json.dumps(e) + "\n" for e in streams[1])
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc, out, _ = _run(tcli.main, [p, "-"], capsys)
    assert rc == 0
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert len(lines) == 2 and all(i["n_hosts"] == 2 for i in lines)


def test_slicecorr_over_a_profile_directory_equals_jax(tmp_path, capsys):
    """``--xprof-dir``: per-host card traces (the JAX test's per-host
    xprof documents, each in its Kineto form) through the port's trace
    reader and collective extraction give JAX's incidents."""
    import gzip

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for root, suffix in ((jdir, ".trace.json.gz"), (tdir, ".trace.json")):
        (root / "plugins" / "profile" / "run1").mkdir(parents=True)
    for host, straggler in (("vm-0", False), ("vm-1", True), ("vm-2", False)):
        doc = txs.trace_doc_with_collectives(straggler=straggler)
        with gzip.open(jdir / "plugins" / "profile" / "run1" / f"{host}.trace.json.gz",
                       "wt") as fh:
            json.dump(doc, fh)
        (tdir / "plugins" / "profile" / "run1" / f"{host}.trace.json").write_text(
            json.dumps(txs.to_kineto(doc)))
    outs = {}
    for name, main, root in (("jax", jcli.main, jdir), ("port", tcli.main, tdir)):
        out = tmp_path / f"{name}.jsonl"
        rc, _, _ = _run(main, ["--xprof-dir", str(root), "--slice-id", "s9",
                               "--skew-floor-ms", "0.1", "--output", str(out)], capsys)
        assert rc == 0
        outs[name] = [json.loads(line) for line in out.read_text().splitlines() if line]
    assert outs["port"] == outs["jax"]
    assert outs["port"] and all(i["straggler_host"] == 1 and i["slice_id"] == "s9"
                                for i in outs["port"])


def test_slicecorr_one_host_profile_reports_no_incident(tmp_path, capsys):
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    (run / "card0.trace.json").write_text(
        json.dumps(txs.to_kineto(txs.trace_doc_with_collectives())))
    out = tmp_path / "inc.jsonl"
    rc, _, err = _run(tcli.main, ["--xprof-dir", str(tmp_path), "--output", str(out)], capsys)
    assert rc == 0 and out.read_text() == ""
    assert '"ingested": 2' in err and '"incidents": 0' in err  # its two launches


def test_slicecorr_refusals(tmp_path, capsys):
    rc, _, err = _run(tcli.main, ["--xprof-dir", str(tmp_path)], capsys)
    assert rc == 2 and "no xprof profile runs" in err
    rc, _, err = _run(tcli.main, ["some.jsonl", "--xprof-dir", str(tmp_path)], capsys)
    assert rc == 2 and "mutually exclusive" in err
    rc, out, err = _run(tcli.main, ["--gate", "some.jsonl"], capsys)
    assert rc == 2 and "ROADMAP item 17" in err and out == ""
