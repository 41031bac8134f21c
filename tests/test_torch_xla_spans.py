"""The port's span source (``tpuslo_torch.otel.xla_spans``) against the JAX
module's.

Every case of ``tests/test_xla_spans.py`` runs twice: the JAX fixture (a
trace-viewer document with "XLA Modules"/"XLA Ops" lanes) through the JAX
parser, and the same events written in the layout the port reads (a
Kineto trace: ``gpu_user_annotation`` module spans named
``<module>(<fingerprint>)#<launch>``, ``kernel`` ops, NCCL kernel names
for collectives) through the port's parser.  The spans must agree in
every field the folds read; the JAX test's assertions are then made on
the port's result.  The capture smoke drives ``capture`` over the port's
CPU ``ServeEngine``.
"""

from __future__ import annotations

import gzip
import json

import pytest

torch = pytest.importorskip("torch")

from tpuslo import schema  # noqa: E402
from tpuslo.correlation import SignalRef, SpanRef, match  # noqa: E402
from tpuslo.correlation.multihost import SliceJoiner  # noqa: E402
from tpuslo.otel import xla_spans as jx  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.otel import xla_spans as tx  # noqa: E402

ANCHOR_NS = 1_700_000_000_000_000_000
# The fields of a span every fold reads (``name`` of an op differs by
# design: an HLO op name on one side, a CUDA kernel name on the other).
KEY = ("module_name", "program_id", "launch_id", "start_us", "duration_us",
       "device_pid", "lane")
NCCL = {
    "all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
    "all-gather": "ncclDevKernel_AllGather_RING_LL",
    "reduce-scatter": "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL",
    "collective-permute": "ncclDevKernel_SendRecv",
    "all-to-all": "ncclDevKernel_SendRecv",
}


def trace_doc():
    return {
        "displayTimeUnit": "ns",
        "metadata": {"highres-ticks": True},
        "traceEvents": [
            {"ph": "M", "pid": 3, "name": "process_name",
             "args": {"name": "/device:TPU:0"}},
            {"ph": "M", "pid": 3, "tid": 2, "name": "thread_name",
             "args": {"name": "XLA Modules"}},
            {"ph": "M", "pid": 3, "tid": 3, "name": "thread_name",
             "args": {"name": "XLA Ops"}},
            {"ph": "M", "pid": 701, "tid": 9, "name": "thread_name",
             "args": {"name": "python"}},
            {"ph": "X", "pid": 3, "tid": 2, "ts": 100.0, "dur": 5.0,
             "name": "jit_train_step(1111)", "args": {"run_id": "42"}},
            {"ph": "X", "pid": 3, "tid": 2, "ts": 300.0, "dur": 5.5,
             "name": "jit_train_step(1111)", "args": {"run_id": "43"}},
            {"ph": "X", "pid": 3, "tid": 2, "ts": 200.0, "dur": 1.0,
             "name": "jit_prefill(2222)", "args": {"run_id": "7"}},
            {"ph": "X", "pid": 3, "tid": 3, "ts": 101.0, "dur": 4.0,
             "name": "fusion.1", "args": {"hlo_category": "fusion"}},
            {"ph": "X", "pid": 701, "tid": 9, "ts": 90.0, "dur": 50.0,
             "name": "PjitFunction(train_step)"},
        ],
    }


def to_kineto(doc):
    """The JAX fixture's events in the layout the port reads."""
    lanes = {
        (e.get("pid"), e.get("tid")): (e.get("args") or {}).get("name", "")
        for e in doc["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        lane = lanes.get((e.get("pid"), e.get("tid")), "")
        args = e.get("args") or {}
        if lane == "XLA Modules":
            run = args.get("run_id")
            name = e["name"] + (f"#{run}" if run is not None else "")
            out.append({"ph": "X", "cat": "gpu_user_annotation", "pid": e["pid"],
                        "tid": 7, "name": name, "ts": e["ts"], "dur": e["dur"]})
        elif lane == "XLA Ops":
            hay = f"{args.get('hlo_category', '')} {e['name']}"
            marker = next((m for m in jx.COLLECTIVE_MARKERS if m in hay), None)
            out.append({"ph": "X", "cat": "kernel", "pid": e["pid"], "tid": 7,
                        "name": NCCL[marker] if marker else e["name"],
                        "ts": e["ts"], "dur": e["dur"], "args": {"device": e["pid"]}})
        else:
            out.append({"ph": "X", "cat": "cpu_op", "pid": e["pid"],
                        "tid": e["tid"], "name": e["name"], "ts": e["ts"],
                        "dur": e["dur"]})
    return {"traceEvents": out}


def keys(spans):
    return [tuple(getattr(s, k) for k in KEY) for s in spans]


def both_parse(doc, include_ops=False):
    """(JAX spans, port spans) of one fixture; they must agree."""
    want = jx.parse_trace_events(doc, include_ops=include_ops)
    got = tx.parse_trace_events(to_kineto(doc), include_ops=include_ops)
    assert keys(got) == keys(want)
    for a, b in zip(want, got):
        if a.lane == jx.MODULES_LANE:
            assert b.name == a.name
    return want, got


class TestParse:
    def test_module_spans_with_identity(self):
        _, spans = both_parse(trace_doc())
        assert [s.launch_id for s in spans] == [42, 7, 43]  # time-sorted
        first = spans[0]
        assert first.module_name == "jit_train_step"
        assert first.program_id == "1111"
        assert first.lane == tx.MODULES_LANE
        assert first.duration_us == 5.0

    def test_ops_included_on_request_only(self):
        _, spans = both_parse(trace_doc())
        assert all(s.lane == tx.MODULES_LANE for s in spans)
        _, with_ops = both_parse(trace_doc(), include_ops=True)
        ops = [s for s in with_ops if s.lane == tx.OPS_LANE]
        assert len(ops) == 1 and ops[0].hlo_category == "kernel"

    def test_metadata_events_are_skipped(self):
        doc = to_kineto(trace_doc())
        doc["traceEvents"].insert(
            0, {"ph": "M", "pid": 9, "tid": 9, "name": "thread_name"}
        )
        assert len(tx.parse_trace_events(doc)) == 3  # parse survives

    def test_unparseable_module_name_keeps_raw_name(self):
        doc = trace_doc()
        doc["traceEvents"].append(
            {"ph": "X", "pid": 3, "tid": 2, "ts": 400.0, "dur": 1.0,
             "name": "weird-module", "args": {}}
        )
        _, spans = both_parse(doc)
        span = [s for s in spans if s.name == "weird-module"][0]
        assert span.module_name == "weird-module"
        assert span.program_id == "" and span.launch_id == -1

    def test_span_ref_feeds_xla_launch_tier(self):
        """A profiler span joins a probe signal on the exact-identity
        xla_launch tier with no instrumentation beyond the range."""
        _, spans = both_parse(trace_doc())
        ref_dict = spans[0].to_span_ref_dict(
            ANCHOR_NS, service="rag-demo", node="host-0"
        )
        span_ref = SpanRef.from_dict(ref_dict)
        signal = SignalRef.from_dict(
            {
                "signal": "ici_collective_latency_ms",
                "timestamp": ref_dict["timestamp"],
                "program_id": "1111",
                "launch_id": 42,
                "value": 3.0,
            }
        )
        decision = match(span_ref, signal)
        assert decision.matched and decision.tier == "xla_launch"
        assert decision.confidence == 0.95
        want, _ = both_parse(trace_doc())
        assert ref_dict == want[0].to_span_ref_dict(
            ANCHOR_NS, service="rag-demo", node="host-0"
        )

    def test_anchor_offsets_timestamp_by_trace_us(self):
        _, spans = both_parse(trace_doc())
        a = SpanRef.from_dict(spans[0].to_span_ref_dict(ANCHOR_NS))
        b = SpanRef.from_dict(spans[2].to_span_ref_dict(ANCHOR_NS))
        delta_ms = (b.timestamp - a.timestamp).total_seconds() * 1000.0
        assert delta_ms == pytest.approx(0.2, abs=1e-6)  # 300us - 100us

    def test_base_time_rebases_to_the_anchor(self):
        """A Kineto document's ``ts`` count from ``baseTimeNanoseconds``;
        given the capture's anchor, spans start that many µs after it."""
        doc = to_kineto(trace_doc())
        doc["baseTimeNanoseconds"] = ANCHOR_NS - 5_000_000
        raw = tx.parse_trace_events(doc)
        anchored = tx.parse_trace_events(doc, anchor_unix_ns=ANCHOR_NS)
        assert [s.start_us for s in anchored] == pytest.approx(
            [s.start_us - 5_000.0 for s in raw]
        )

    @staticmethod
    def card_doc(extra=()):
        """A card's trace: a host launch event (``cuda_runtime``), one
        range's device extent and its kernels, two of which touch, and
        a copy outside every range."""
        return {"traceEvents": [
            {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
             "name": "prefill(55)#3", "ts": 0.0, "dur": 50.0},
            {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
             "name": "cudaLaunchKernel", "ts": 10.0, "dur": 2.0},
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
             "name": "prefill(55)#3", "ts": 30.0, "dur": 55.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k1",
             "ts": 30.0, "dur": 5.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k2",
             "ts": 35.0, "dur": 3.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k3",
             "ts": 50.0, "dur": 8.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "k4",
             "ts": 80.0, "dur": 5.0},
            {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
             "name": "Memcpy HtoD", "ts": 100.0, "dur": 5.0},
            *extra,
        ]}

    def test_card_trace_cuts_a_range_at_its_kernel_gaps(self):
        """On a card a range's extent holds the host's queueing gaps: it
        becomes one module span per run of its kernels, each with the
        range's identity, so the ledger's idle gap is the device's."""
        from tpuslo_torch.deviceplane.ledger import build_ledger

        doc = self.card_doc()
        assert tx.module_lane_source(doc) == "kernel_segments"
        spans = tx.parse_trace_events(doc, include_ops=True)
        mods = [s for s in spans if s.lane == tx.MODULES_LANE]
        assert [(s.start_us, s.duration_us) for s in mods] == [
            (30.0, 8.0), (50.0, 8.0), (80.0, 5.0)]
        assert {(s.module_name, s.program_id, s.launch_id, s.device_pid)
                for s in mods} == {("prefill", "55", 3, 0)}
        ledger = build_ledger(spans)
        assert ledger.total_us == 75.0  # the first kernel to the copy's end
        assert ledger.buckets_us["joined"] == 21.0
        assert ledger.buckets_us["idle_gap"] == 54.0  # the copy is outside every range
        (event,) = tx.extract_device_time_signals(spans, ANCHOR_NS)
        assert event["tpu"]["launch_id"] == 3 and event["value"] == 0.021

    def test_card_trace_gives_a_kernel_to_its_innermost_range(self):
        doc = self.card_doc(extra=(
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
             "name": "suffix_prefill(66)#1", "ts": 49.0, "dur": 10.0},
        ))
        mods = [s for s in tx.parse_trace_events(doc) if s.lane == tx.MODULES_LANE]
        assert [(s.module_name, s.start_us, s.duration_us) for s in mods] == [
            ("prefill", 30.0, 8.0), ("suffix_prefill", 50.0, 8.0), ("prefill", 80.0, 5.0)]

    def test_a_graph_replay_cut_short_keeps_its_kernels_by_correlation(self):
        """Kineto may end a CUDA graph replay's device extent long before
        its last kernel (graph kernels carry no external id).  A kernel
        outside every extent goes to the range whose host range made the
        launch its correlation id names; a copy launched outside every
        range stays outside."""
        from tpuslo_torch.deviceplane.ledger import build_ledger

        name = "spec_multi_round(77)#4"
        graph = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": f"g{i}",
                  "ts": 200.0 + 10.0 * i, "dur": 10.0, "args": {"correlation": 900}}
                 for i in range(6)]
        doc = self.card_doc(extra=(
            {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1, "name": name,
             "ts": 150.0, "dur": 30.0},
            {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "name": "cudaGraphLaunch",
             "ts": 160.0, "dur": 15.0, "args": {"correlation": 900}},
            {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "name": "cudaMemcpyAsync",
             "ts": 190.0, "dur": 1.0, "args": {"correlation": 901}},
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7, "name": name,
             "ts": 200.0, "dur": 20.0},
            *graph,
            {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "Memcpy DtoH",
             "ts": 260.0, "dur": 2.0, "args": {"correlation": 901}},
        ))
        spans = tx.parse_trace_events(doc, include_ops=True)
        mods = [s for s in spans if s.lane == tx.MODULES_LANE and s.module_name == "spec_multi_round"]
        assert [(s.start_us, s.duration_us, s.launch_id) for s in mods] == [(200.0, 60.0, 4)]
        ledger = build_ledger(spans)
        assert ledger.buckets_us["joined"] == 21.0 + 60.0
        assert ledger.buckets_us["idle_gap"] == ledger.total_us - 81.0  # the two copies

    def test_card_trace_without_device_extents_raises(self):
        """Kernels and dispatch ranges but no ``gpu_user_annotation``: the
        module lane cannot be read, and nothing stands in for it."""
        doc = self.card_doc()
        doc["traceEvents"] = [e for e in doc["traceEvents"]
                              if e["cat"] != "gpu_user_annotation"]
        with pytest.raises(ValueError, match="gpu_user_annotation"):
            tx.parse_trace_events(doc, include_ops=True)


def trace_doc_with_collectives(base_latency_us=400.0, straggler=False):
    """Two module launches, each containing an all-reduce whose
    duration encodes the collective wait (punctual hosts wait longer)."""
    wait = 50.0 if straggler else base_latency_us
    events = [
        {"ph": "M", "pid": 3, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 3, "tid": 3, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
    ]
    for launch in range(2):
        t0 = 1000.0 * launch
        events.append(
            {"ph": "X", "pid": 3, "tid": 2, "ts": t0, "dur": 900.0,
             "name": "jit_train_step(777)", "args": {"run_id": str(launch)}}
        )
        events.append(
            {"ph": "X", "pid": 3, "tid": 3, "ts": t0 + 10.0, "dur": wait,
             "name": "all-reduce.3", "args": {"hlo_category": "all-reduce"}}
        )
        events.append(
            {"ph": "X", "pid": 3, "tid": 3, "ts": t0 + 200.0, "dur": 20.0,
             "name": "all-gather-start.1", "args": {"hlo_category": "fusion"}}
        )
        events.append(
            {"ph": "X", "pid": 3, "tid": 3, "ts": t0 + 300.0, "dur": 99.0,
             "name": "fusion.7", "args": {"hlo_category": "fusion"}}
        )
    events.append(
        {"ph": "X", "pid": 3, "tid": 3, "ts": 5000.0, "dur": 11.0,
         "name": "all-reduce.9", "args": {"hlo_category": "all-reduce"}}
    )
    return {"traceEvents": events}


def collective_spans(straggler=False):
    return both_parse(trace_doc_with_collectives(straggler=straggler), include_ops=True)


class TestCollectiveExtraction:
    def test_nccl_kernels_are_the_collectives(self):
        want, got = collective_spans()
        assert [jx.is_collective_op(s) for s in want] == [
            tx.is_collective_op(s) for s in got
        ]
        assert sum(tx.is_collective_op(s) for s in got) == 5

    def test_per_launch_totals_with_identity(self):
        want, got = collective_spans()
        kw = dict(node="host-0", slice_id="s0", host_index=0)
        events = tx.extract_collective_signals(got, ANCHOR_NS, **kw)
        assert events == jx.extract_collective_signals(want, ANCHOR_NS, **kw)
        assert len(events) == 2  # one per module launch
        for launch, ev in enumerate(events):
            assert ev["signal"] == "ici_collective_latency_ms"
            assert ev["tpu"]["launch_id"] == launch
            assert ev["tpu"]["program_id"] == "777"
            assert ev["value"] == pytest.approx(0.42)  # (400+20)us in ms
            assert ev["tpu"]["slice_id"] == "s0"

    def test_events_validate_against_probe_schema(self):
        _, got = collective_spans()
        for ev in tx.extract_collective_signals(got, ANCHOR_NS, node="host-0"):
            schema.validate(ev, schema.SCHEMA_PROBE_EVENT)

    def test_device_time_signals_match_and_validate(self):
        want, got = collective_spans()
        events = tx.extract_device_time_signals(got, ANCHOR_NS, node="host-0")
        assert events == jx.extract_device_time_signals(want, ANCHOR_NS, node="host-0")
        assert [e["value"] for e in events] == pytest.approx([0.519, 0.519])
        for ev in events:
            schema.validate(ev, schema.SCHEMA_PROBE_EVENT)

    def test_orphan_collective_outside_modules_skipped(self):
        _, got = collective_spans()
        events = tx.extract_collective_signals(got, ANCHOR_NS)
        assert len(events) == 2
        assert sum(e["value"] for e in events) == pytest.approx(0.84)

    def test_multi_device_host_keeps_per_device_containment(self):
        """Two devices run the same launch concurrently: ops pair with
        their own device's module span (no double-counting), and devices
        of one host aggregate into one event per launch."""
        doc = {"traceEvents": []}
        for pid in (3, 4):
            doc["traceEvents"] += [
                {"ph": "M", "pid": pid, "tid": 2, "name": "thread_name",
                 "args": {"name": "XLA Modules"}},
                {"ph": "M", "pid": pid, "tid": 3, "name": "thread_name",
                 "args": {"name": "XLA Ops"}},
                {"ph": "X", "pid": pid, "tid": 2, "ts": 100.0, "dur": 500.0,
                 "name": "jit_step(9)", "args": {"run_id": "0"}},
                {"ph": "X", "pid": pid, "tid": 3, "ts": 150.0, "dur": 100.0,
                 "name": "all-reduce.1",
                 "args": {"hlo_category": "all-reduce"}},
            ]
        want, got = both_parse(doc, include_ops=True)
        events = tx.extract_collective_signals(got, ANCHOR_NS, node="h")
        assert events == jx.extract_collective_signals(want, ANCHOR_NS, node="h")
        assert len(events) == 1
        assert events[0]["value"] == pytest.approx(0.2)  # 100us x 2 devices
        assert events[0]["tpu"]["launch_id"] == 0

    def test_anonymous_launch_ops_sum_into_one_event(self):
        doc = {"traceEvents": [
            {"ph": "M", "pid": 3, "tid": 2, "name": "thread_name",
             "args": {"name": "XLA Modules"}},
            {"ph": "M", "pid": 3, "tid": 3, "name": "thread_name",
             "args": {"name": "XLA Ops"}},
            {"ph": "X", "pid": 3, "tid": 2, "ts": 0.0, "dur": 1000.0,
             "name": "jit_anon(5)", "args": {}},
            {"ph": "X", "pid": 3, "tid": 3, "ts": 10.0, "dur": 5.0,
             "name": "all-reduce.1", "args": {"hlo_category": "all-reduce"}},
            {"ph": "X", "pid": 3, "tid": 3, "ts": 50.0, "dur": 5.0,
             "name": "all-reduce.2", "args": {"hlo_category": "all-reduce"}},
        ]}
        want, got = both_parse(doc, include_ops=True)
        events = tx.extract_collective_signals(got, ANCHOR_NS)
        assert events == jx.extract_collective_signals(want, ANCHOR_NS)
        assert len(events) == 1
        assert events[0]["value"] == pytest.approx(0.01)  # 2 x 5us in ms

    def test_profiler_to_slicecorr_end_to_end(self):
        """Per-host traces -> collective signals -> SliceJoiner names the
        straggler host."""
        by_host = {
            "vm-0": collective_spans()[1],
            "vm-1": collective_spans()[1],
            "vm-2": collective_spans(straggler=True)[1],
            "vm-3": collective_spans()[1],
        }
        events = tx.extract_collective_signals_by_host(
            by_host, ANCHOR_NS, slice_id="slice-0"
        )
        joiner = SliceJoiner(expected_hosts=4, skew_floor_ms=0.1)
        joiner.add_all(events)
        incidents = joiner.incidents()
        assert len(incidents) == 2
        assert all(i.straggler_host == 2 for i in incidents)
        assert all(i.cause == "compute_straggler" for i in incidents)


class TestFiles:
    def write_run(self, tmp_path, run, hosts):
        d = tmp_path / "plugins" / "profile" / run
        d.mkdir(parents=True)
        for host in hosts:
            with gzip.open(d / f"{host}.trace.json.gz", "wt") as fh:
                json.dump(to_kineto(trace_doc()), fh)

    def test_newest_run_first_and_multi_host(self, tmp_path):
        self.write_run(tmp_path, "2026_01_01_00_00_00", ["hostA"])
        self.write_run(tmp_path, "2026_02_02_00_00_00", ["hostA", "hostB"])
        files = tx.find_trace_files(str(tmp_path))
        assert len(files) == 3
        assert "2026_02_02_00_00_00" in files[0]
        assert len(tx.load_latest_trace(str(tmp_path))) == 6

    def test_load_single_file(self, tmp_path):
        self.write_run(tmp_path, "r", ["vm"])
        path = tx.find_trace_files(str(tmp_path))[0]
        assert len(tx.load_trace_file(path)) == 3

    def test_empty_dir(self, tmp_path):
        assert tx.find_trace_files(str(tmp_path)) == []
        assert tx.load_latest_trace(str(tmp_path)) == []
        assert tx.load_latest_trace_by_host(str(tmp_path)) == {}

    def test_by_host_grouping_preserves_launch_scope(self, tmp_path):
        self.write_run(tmp_path, "r", ["hostA", "hostB"])
        by_host = tx.load_latest_trace_by_host(str(tmp_path))
        assert set(by_host) == {"hostA", "hostB"}
        assert all(len(spans) == 3 for spans in by_host.values())

    def test_dotted_hostnames_stay_distinct(self, tmp_path):
        hosts = ["worker.zone-a.internal", "worker.zone-b.internal"]
        self.write_run(tmp_path, "r", hosts)
        by_host = tx.load_latest_trace_by_host(str(tmp_path))
        assert set(by_host) == set(hosts)
        assert all(len(spans) == 3 for spans in by_host.values())

    def test_span_refs_by_host_labels_each_host(self, tmp_path):
        self.write_run(tmp_path, "r", ["hostA", "hostB"])
        cap = tx.capture(str(tmp_path))
        cap.anchor_unix_ns = ANCHOR_NS
        cap.spans_by_host = tx.load_latest_trace_by_host(str(tmp_path))
        refs = cap.span_refs_by_host(
            {
                "hostA": {"node": "tpu-vm-0", "host_index": 0},
                "hostB": {"node": "tpu-vm-1", "host_index": 1},
            },
            service="rag",
            slice_id="slice-0",
        )
        assert refs["hostA"][0]["node"] == "tpu-vm-0"
        assert refs["hostB"][0]["host_index"] == 1
        assert refs["hostB"][0]["slice_id"] == "slice-0"

    def test_span_refs_rejects_ambiguous_multi_host_labeling(self, tmp_path):
        self.write_run(tmp_path, "r", ["hostA", "hostB"])
        cap = tx.capture(str(tmp_path))
        cap.spans_by_host = tx.load_latest_trace_by_host(str(tmp_path))
        with pytest.raises(ValueError, match="span_refs_by_host"):
            cap.span_refs(node="tpu-vm-0")


class TestCaptureSmoke:
    def test_capture_over_the_cpu_serve_engine(self, tmp_path):
        """The port's annotated dispatches come back as module spans:
        one program id per (module, shapes), launch ids rising within a
        program."""
        torch.set_num_threads(1)
        engine = ts.ServeEngine(cfg=tl.llama_tiny(max_seq_len=128), device="cpu",
                                decode_chunk_size=4)
        list(engine.generate("warm", max_new_tokens=3))
        with tx.capture(str(tmp_path)) as cap:
            for prompt in ("first request", "second request"):
                list(engine.generate(prompt, max_new_tokens=9, stop_at_eos=False))
        assert cap.anchor_unix_ns > 0
        assert tx.find_trace_files(str(tmp_path)) == [cap.trace_path]
        mods = list(cap.launches())
        by_program: dict[str, list] = {}
        for s in mods:
            by_program.setdefault(s.program_id, []).append(s)
        names = {s.module_name for s in mods}
        assert {"prefill", "decode_chunk"} <= names
        for program_spans in by_program.values():
            assert len({s.module_name for s in program_spans}) == 1
            launches = [s.launch_id for s in program_spans]
            assert launches == sorted(launches) and len(set(launches)) == len(launches)
        # Two requests, two decode chunks each, same shapes: one program.
        decode = [s for s in mods if s.module_name == "decode_chunk"]
        assert len(decode) == 4 and len({s.program_id for s in decode}) == 1
        assert all(s.device_pid == tx.CPU_DEVICE_PID for s in mods)
        assert all(0 <= s.start_us < 60e6 for s in mods)  # µs after the anchor
        refs = cap.span_refs(service="s")
        assert len(refs) == len(mods)
        for ref in refs:
            SpanRef.from_dict(ref)

    def test_no_range_without_a_profiler(self):
        before = dict(tx._RUNS)
        with tx.dispatch_range("prefill", torch.zeros(1, 4)) as r:
            assert r is None
        assert tx._RUNS == before

    def test_fingerprint_follows_shapes_and_static_args(self):
        a = tx.program_fingerprint("decode_chunk", torch.zeros(2, dtype=torch.long), 4)
        assert a == tx.program_fingerprint("decode_chunk", torch.ones(2, dtype=torch.long), 4)
        assert a != tx.program_fingerprint("decode_chunk", torch.zeros(3, dtype=torch.long), 4)
        assert a != tx.program_fingerprint("decode_chunk", torch.zeros(2, dtype=torch.long), 8)
        assert a != tx.program_fingerprint("prefill", torch.zeros(2, dtype=torch.long), 4)
        assert a.isdigit()


class TestLaunchMatchBreakdown:
    def _spans(self, include_ops=True):
        return both_parse(trace_doc(), include_ops=include_ops)

    def test_classifies_launches_without_ops(self):
        want, got = self._spans()
        report = tx.launch_match_breakdown(got)
        assert report == jx.launch_match_breakdown(want)
        assert report["launches"] == 3
        assert report["launches_with_ops"] == 1
        assert report["unmatched_count"] == 2
        assert report["reasons"] == {"no_contained_ops": 2}
        assert report["substantive_join_rate"] == 1.0
        assert {u["launch_id"] for u in report["unmatched"]} == {43, 7}

    def test_no_ops_lane_reason(self):
        want, got = self._spans(include_ops=False)
        report = tx.launch_match_breakdown(got)
        assert report == jx.launch_match_breakdown(want)
        assert report["launches"] == 3
        assert report["launches_with_ops"] == 0
        assert report["reasons"] == {"no_ops_lane": 3}

    def test_empty_trace(self):
        report = tx.launch_match_breakdown([])
        assert report == jx.launch_match_breakdown([])
        assert report["launches"] == 0
        assert report["substantive_join_rate"] == 0.0
