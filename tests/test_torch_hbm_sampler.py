"""The port's HBM sampler (``tpuslo_torch.collector.hbm_sampler``): the
hang boundary of ``tests/test_collector.py`` (a hung live probe times
out once, then stays off), the stats-file source, the "no card" miss
with its reason, and ``HBMSampler`` writing a wire event that the JAX
package's native ring consumer decodes as it decodes its own sampler's.

The live CUDA source is held to ``torch.cuda.memory_allocated`` and
``mem_get_info`` on the card (``tests/test_torch_card.py``).
"""

from __future__ import annotations

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from tpuslo.collector import hbm_sampler as j_hbm  # noqa: E402
from tpuslo.collector import native as j_native  # noqa: E402
from tpuslo.collector.ringbuf import RingBufConsumer  # noqa: E402
from tpuslo_torch.collector import hbm_sampler  # noqa: E402
from tpuslo_torch.collector import native  # noqa: E402


class TestHBMSamplerHangBoundary:
    """A hung driver makes the first CUDA call block with no exception;
    the sampler's live probe must time out once, then stay disabled
    instead of parking a worker thread per cycle."""

    def test_hung_device_probe_times_out_and_disables(self, monkeypatch):
        release = threading.Event()
        monkeypatch.setattr(hbm_sampler, "_read_device",
                            lambda: release.wait(30.0) and None)
        monkeypatch.setenv("TPUSLO_HBM_PROBE_TIMEOUT_S", "0.2")
        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", False)

        t0 = time.perf_counter()
        assert hbm_sampler.read_stats() is None
        assert time.perf_counter() - t0 < 5.0  # the join timeout, not the hang
        assert hbm_sampler._DEVICE_PROBE_DEAD

        t0 = time.perf_counter()
        assert hbm_sampler.read_stats() is None
        assert time.perf_counter() - t0 < 0.05  # no new worker
        release.set()

    def test_stats_file_path_unaffected(self, tmp_path, monkeypatch):
        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", True)
        stats = tmp_path / "hbm.json"
        stats.write_text('{"bytes_in_use": 8, "bytes_limit": 16}')
        assert hbm_sampler.read_stats(str(stats)) == (8, 16)
        assert j_hbm.read_stats(str(stats)) == (8, 16)

    @pytest.mark.parametrize("body", ['{"bytes_in_use": 8}', "not json"])
    def test_bad_stats_file_is_a_miss(self, tmp_path, body):
        stats = tmp_path / "hbm.json"
        stats.write_text(body)
        assert hbm_sampler.read_stats(str(stats)) is None
        assert j_hbm.read_stats(str(stats)) is None


class TestLiveSource:
    def test_no_card_is_a_miss_with_its_reason(self, monkeypatch):
        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
        assert hbm_sampler.read_stats() is None
        assert hbm_sampler.LAST_PROBE_ERROR == hbm_sampler.NO_DEVICE
        assert not hbm_sampler._DEVICE_PROBE_DEAD

    def test_probe_failure_is_recorded(self, monkeypatch):
        def broken():
            raise RuntimeError("driver said no")

        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", False)
        monkeypatch.setattr(hbm_sampler, "_read_device", broken)
        monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
        assert hbm_sampler.read_stats() is None
        assert "driver said no" in hbm_sampler.LAST_PROBE_ERROR

    def test_live_reading_is_allocated_over_total(self, monkeypatch):
        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", False)
        monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (30 << 30, 80 << 30))
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 12 << 30)
        assert hbm_sampler.read_stats() == (12 << 30, 80 << 30)
        assert hbm_sampler.LAST_PROBE_ERROR is None


class TestSampler:
    def test_wire_contract_equals_jax(self):
        assert native.SIG_HBM_UTILIZATION == j_native.SIG_HBM_UTILIZATION
        assert native.F_TPU == j_native.F_TPU
        kw = dict(ts_ns=123, pid=9, flags=native.F_TPU, comm=b"hbm_sampler")
        assert native.pack_event(native.SIG_HBM_UTILIZATION, 4321, **kw) == (
            j_native.pack_event(j_native.SIG_HBM_UTILIZATION, 4321, **kw))
        assert len(native.pack_event(1, 1)) == native.EVENT_BYTES

    def test_sample_once_writes_basis_points_the_consumer_decodes(self, tmp_path):
        stats = tmp_path / "hbm.json"
        stats.write_text('{"bytes_in_use": 6981, "bytes_limit": 8000}')
        ring = str(tmp_path / "ring.buf")
        sampler = hbm_sampler.HBMSampler(ring, stats_path=str(stats))
        consumer = RingBufConsumer(steal_window_ms=1000, ncpu=1)
        consumer.add_userspace_ring(ring)
        try:
            assert sampler.sample_once()
            assert sampler.samples == 1
            (s,) = consumer.poll()
        finally:
            sampler.close()
            consumer.close()
        assert s.signal == "hbm_utilization_pct"
        assert s.value == pytest.approx(87.26)  # 8726 basis points
        assert s.is_tpu and s.comm == "hbm_sampler"

    def test_sample_once_without_stats_writes_nothing(self, tmp_path, monkeypatch):
        monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", True)
        monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
        sampler = hbm_sampler.HBMSampler(str(tmp_path / "ring.buf"))
        try:
            assert not sampler.sample_once()
            assert sampler.samples == 0
        finally:
            sampler.close()
