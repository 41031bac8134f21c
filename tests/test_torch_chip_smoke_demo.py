"""``chip_smoke.py``'s phases 28 (the fault injectors) and 29 (the demo
workload): their place in the script and the kernels line, and phase 29
rehearsed on the CPU at ``llama_tiny``'s width (the entry point as a
subprocess, ``torch_batched`` over the paged pool in this process, the
vector store against numpy).  The CPU launches no kernel, so the launch
check is the one part stubbed.  It imports no JAX, as the script does
not."""

from __future__ import annotations

import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small models run in many processes at
    once under the suite's workers, where torch's default of one thread a
    core oversubscribes the box."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_phases_28_and_29_run_after_27_and_feed_the_kernels_line():
    source = Path(chip_smoke.__file__).read_text()
    main = source[source.index("def main() -> int:"):]
    order = ["phase_train_mesh(torch", "phase_chaos(torch", "phase_demo(torch",
             'kernels = {"kernels": [']
    assert [main.index(o) for o in order] == sorted(main.index(o) for o in order)
    for kernel in ("flash_attention", "flash_attention_f32", "paged_attention",
                   "paged_attention_f32", "rms_norm", "add_rms_norm"):
        assert f'demo_launches["{kernel}"]' in main, kernel
    for name in ("chaos", "demo"):
        assert f'"{name}": {name}' in main and f'print(f"{name}: {{json.dumps({name})}}"' in main
        assert f'mark("{28 if name == "chaos" else 29} {name}")' in main


def test_phase_29_rehearses_on_the_cpu_at_a_tiny_width(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_hold_launched", lambda *a, **k: None)
    mods = [importlib.import_module(f"tpuslo_torch.ops.{m}")
            for m in ("flash_attention", "paged_attention", "rms_norm", "launch_counts")]
    out = chip_smoke.phase_demo(torch, *mods, model="llama_tiny", device="cpu")
    served, batched = out["served"], out["batched"]
    assert served["tokens"][:2] == [24, 24] and len(served["ttft_ms"]) == 3
    assert served["spans"] == 9 and set(served["launches"]) == set(out["launches"])
    assert batched["engine"] == "PagedBatchingEngine" and batched["pallas_attention"]
    assert batched["tokens"] == [24] * 4 and batched["engine_stat_lines"] > 0
    for part in (served, batched):
        assert len(part["parity"]) == len(part["tokens"])
    for row in out["store"].values():
        assert row["max_score_err"] <= chip_smoke.DEMO_STORE_TOL
    assert out["store"]["large"]["docs"] == chip_smoke.DEMO_STORE_ROWS
