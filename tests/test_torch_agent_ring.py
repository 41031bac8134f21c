"""The port's real-probe (ring) path: ``tests/test_agent_ring.py``'s five
cases on ``tpuslo_torch`` (userspace ring producer → native consumer →
schema envelope → JSONL writer, through the port's agent loop), and the
port's consumer held to the JAX package's: the same written events
decode into equal ``DecodedSample``s and lift into equal
``ProbeEventV1``s.  ``NativeSample`` is checked field by field against
``native/decode.h``'s ``Sample``, as ``load_runtime`` checks its size
against the library's.  The active prober runs over a one-rank gloo
group (``--device cpu``): a card's NCCL rank is the chip's."""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from pathlib import Path

import pytest

from tpuslo.collector import native as jnative
from tpuslo.collector import ringbuf as jringbuf
from tpuslo.signals import Metadata as JMetadata
from tpuslo_torch.collector import native
from tpuslo_torch.collector import ringbuf
from tpuslo_torch.signals import Metadata

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    not native.runtime_available(), reason="native runtime not buildable"
)


def test_agent_ring_mode_end_to_end(tmp_path):
    from tpuslo_torch.cli import agent

    ring_path = str(tmp_path / "agent.buf")
    out_path = str(tmp_path / "probes.jsonl")
    writer = ringbuf.RingWriter(ring_path)

    def produce():
        # Give the agent a moment to attach the ring, then emit a mix of
        # CPU and TPU wire events.
        time.sleep(0.3)
        writer.write_event(signal=native.SIG_DNS_LATENCY, value=3_000_000,
                           ts_ns=time.time_ns(), pid=11)
        writer.write_event(signal=native.SIG_XLA_COMPILE, value=60_000_000,
                           ts_ns=time.time_ns(), pid=12, aux=99, flags=native.F_TPU)
        writer.write_event(signal=native.SIG_ICI_COLLECTIVE, value=4_000_000,
                           ts_ns=time.time_ns(), pid=12, aux=1234, flags=native.F_TPU)

    producer = threading.Thread(target=produce)
    producer.start()
    rc = agent.main([
        "--probe-source", "ring", "--ring-path", ring_path, "--event-kind", "probe",
        "--output", "jsonl", "--jsonl-path", out_path, "--count", "4",
        "--interval-s", "0.2", "--metrics-port", "0",
        "--signal-set", "dns_latency_ms,xla_compile_ms,ici_collective_latency_ms",
    ])
    producer.join()
    writer.close()
    assert rc == 0

    events = [json.loads(line) for line in open(out_path, encoding="utf-8")]
    by_signal = {e["signal"]: e for e in events}
    assert by_signal["dns_latency_ms"]["value"] == pytest.approx(3.0)
    assert by_signal["dns_latency_ms"]["pid"] == 11
    assert by_signal["xla_compile_ms"]["value"] == pytest.approx(60.0)
    assert by_signal["ici_collective_latency_ms"]["tpu"]["launch_id"] == 1234


def test_agent_ring_mode_runs_ici_prober(tmp_path):
    """Ring mode (the production path) runs the active prober too, over
    the one-rank group the agent brings up before its first cycle."""
    import torch.distributed as dist

    from tpuslo_torch.cli import agent

    out_path = str(tmp_path / "probes.jsonl")
    rc = agent.main([
        "--probe-source", "ring", "--ring-path", str(tmp_path / "empty.buf"),
        "--event-kind", "probe", "--output", "jsonl", "--jsonl-path", out_path,
        "--count", "2", "--interval-s", "0.05", "--metrics-port", "0",
        "--max-overhead-pct", "1000", "--ici-probe-interval-s", "3600",
        "--ici-probe-payload-kb", "16", "--device", "cpu",
    ])
    assert rc == 0
    events = [json.loads(line) for line in open(out_path).read().splitlines()]
    ici = [e for e in events if e.get("tpu", {}).get("program_id") == "icibench"]
    assert len(ici) == 4  # one probe round, four collectives
    assert not dist.is_initialized()


def test_agent_ring_mode_stamps_multihost_identity(tmp_path):
    """--slice-id/--host-index/--xla-program-id flow into every TPU
    event's TPURef — what slicecorr joins per-host agent streams on."""
    from tpuslo_torch.cli import agent

    ring_path = str(tmp_path / "agent.buf")
    out_path = str(tmp_path / "probes.jsonl")
    writer = ringbuf.RingWriter(ring_path)

    def produce():
        time.sleep(0.3)
        for launch in range(3):
            writer.write_event(signal=native.SIG_ICI_COLLECTIVE, value=int(25.0 * 1e6),
                               ts_ns=time.time_ns(), aux=launch, tid=1, flags=native.F_TPU)

    producer = threading.Thread(target=produce)
    producer.start()
    rc = agent.main([
        "--probe-source", "ring", "--ring-path", ring_path, "--count", "8",
        "--interval-s", "0.15", "--output", "jsonl", "--jsonl-path", out_path,
        "--node", "dist-host-1", "--slice-id", "test-slice", "--host-index", "1",
        "--xla-program-id", "dist_psum", "--signal-set", "ici_collective_latency_ms",
        "--capability-mode", "cuda_full", "--metrics-port", "0",
        "--max-overhead-pct", "1000",
    ])
    producer.join()
    assert rc == 0
    events = [json.loads(line) for line in open(out_path).read().splitlines()
              if line.strip()]
    collectives = [e for e in events if e["signal"] == "ici_collective_latency_ms"]
    assert len(collectives) == 3
    for event in collectives:
        assert event["tpu"]["slice_id"] == "test-slice"
        assert event["tpu"]["host_index"] == 1
        assert event["tpu"]["program_id"] == "dist_psum"
        assert abs(event["value"] - 25.0) < 1e-6
    assert {e["tpu"]["launch_id"] for e in collectives} == {0, 1, 2}


def test_owned_side_ring_created_securely_and_cleaned_up(tmp_path, monkeypatch):
    """When the agent owns the side ring (no --ring-path), the file is
    created via mkstemp and removed on exit."""
    import tempfile

    from tpuslo_torch.cli import agent

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = agent.main([
        "--probe-source", "ring", "--hello", "--event-kind", "probe", "--output", "jsonl",
        "--jsonl-path", str(tmp_path / "probes.jsonl"), "--count", "2",
        "--interval-s", "0.05", "--metrics-port", "0", "--max-overhead-pct", "1000",
        "--signal-set", "dns_latency_ms",
    ])
    assert rc == 0
    assert not list(tmp_path.glob("tpuslo-ring-*.buf"))


def test_ring_consumer_lifts_launch_id_for_dcn_events(tmp_path):
    """aux -> launch_id lifts for BOTH collective signals: the cross-slice
    joiner keys dcn_transfer groups on (program, launch)."""
    path = str(tmp_path / "dcn.buf")
    consumer = ringbuf.RingBufConsumer()
    writer = ringbuf.RingWriter(path)
    consumer.add_userspace_ring(path)
    writer.write_event(signal=native.SIG_DCN_TRANSFER, value=int(33.0e6), ts_ns=5,
                       aux=7, pid=1, tid=0, flags=native.F_TPU)
    samples = list(consumer.poll())
    assert samples and samples[0].signal == "dcn_transfer_latency_ms"
    meta = Metadata(node="n", namespace="llm", pod="p", container="c", pid=1, tid=0,
                    tpu_chip="accel0", slice_id="s-0", host_index=0,
                    xla_program_id="prog")
    event = ringbuf.to_probe_event(samples[0], meta)
    assert event.tpu.launch_id == 7
    consumer.close()
    writer.close()


# Wire events of every kind the consumer decodes: CPU and TPU signals, an
# error, a connection tuple, a heartbeat with no schema identity.
EVENTS = [
    dict(signal=native.SIG_DNS_LATENCY, value=3_000_000, ts_ns=11, pid=5, tid=6,
         comm=b"dns"),
    dict(signal=native.SIG_CONNECT_LATENCY, value=7_500_000, ts_ns=12, pid=5, tid=7,
         saddr4=0x0100007F, daddr4=0x0200000A, sport=4242, dport=443,
         flags=native.F_CONN | native.F_ERROR, err=-111),
    dict(signal=native.SIG_TCP_RETRANSMIT, value=3, ts_ns=13, pid=8, flags=native.F_CONN,
         saddr4=0x0100007F, daddr4=0x0100007F, sport=1, dport=2),
    dict(signal=native.SIG_XLA_COMPILE, value=60_000_000, ts_ns=14, pid=12, aux=99,
         flags=native.F_TPU, comm=b"serve-storm"),
    dict(signal=native.SIG_HBM_UTILIZATION, value=4321, ts_ns=15, pid=12,
         flags=native.F_TPU),
    dict(signal=native.SIG_ICI_COLLECTIVE, value=4_000_000, ts_ns=16, aux=1234,
         flags=native.F_TPU),
    dict(signal=native.SIG_ICI_LINK_RETRY, value=2, ts_ns=17, aux=3, flags=native.F_TPU),
    dict(signal=native.SIG_DCN_TRANSFER, value=int(33.0e6), ts_ns=18, aux=7,
         flags=native.F_TPU),
    dict(signal=native.SIG_HOST_OFFLOAD, value=2_000_000, ts_ns=19, pid=3),
    dict(signal=native.SIG_HELLO, value=1, ts_ns=20, pid=4),
]


def _decode(native_mod, ringbuf_mod, path: str) -> list:
    consumer = ringbuf_mod.RingBufConsumer()
    writer = ringbuf_mod.RingWriter(path)
    consumer.add_userspace_ring(path)
    for event in EVENTS:
        assert writer.write(native_mod.pack_event(**event))
    samples = []
    for _ in range(5):
        samples += consumer.poll()
    consumer.close()
    writer.close()
    return samples


def test_the_ports_consumer_decodes_and_lifts_as_jaxs(tmp_path):
    jax_samples = _decode(jnative, jringbuf, str(tmp_path / "jax.buf"))
    port_samples = _decode(native, ringbuf, str(tmp_path / "port.buf"))
    assert len(jax_samples) == len(EVENTS)
    assert [dataclasses.asdict(s) for s in port_samples] == [
        dataclasses.asdict(s) for s in jax_samples]
    assert [s.is_tpu for s in port_samples] == [s.is_tpu for s in jax_samples]
    identity = dict(node="n", namespace="llm", pod="p", container="c", pid=1, tid=1,
                    tpu_chip="accel0", slice_id="s-0", host_index=2,
                    xla_program_id="prog", trace_id="t", span_id="s")
    for js, ps in zip(jax_samples, port_samples):
        want = jringbuf.to_probe_event(js, JMetadata(**identity))
        got = ringbuf.to_probe_event(ps, Metadata(**identity))
        assert (got is None) == (want is None)
        if want is not None:
            assert got.to_dict() == want.to_dict()


def test_native_sample_mirrors_decode_h():
    """NativeSample's fields, in order, are decode.h's ``struct Sample``."""
    header = (ROOT / "native" / "decode.h").read_text()
    body = re.search(r"struct Sample \{(.*?)\};", header, re.S).group(1)
    fields = re.findall(r"^\s*\w+\s+(\w+)(?:\[[^\]]+\])?;", body, re.M)
    assert fields == [name for name, _ in native.NativeSample._fields_]
    lib = native.load_runtime()
    assert lib.tpuslo_sample_size() == __import__("ctypes").sizeof(native.NativeSample)
