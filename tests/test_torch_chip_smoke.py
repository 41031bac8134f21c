"""``chip_smoke.py``'s arithmetic that needs no card: K1-f32's restated
bound and the ptxas report's instantiation names; and the process
entry's phase helpers (admission orders, the row comparison, the chaos
lane's resume audit, cycle wall times) on recorded rows.

K1-f32 computes f32-accurate products on the tensor cores (3xTF32 on f32
inputs, p in two 16-bit pieces on bf16 or f16 inputs), so its bound takes
each product at the fastest rate that keeps f32 accuracy; the FFMA-rate
bound that PR 6 stated stays beside it.  The expected values are the
bound's own arithmetic at B1 S256 H24 KV8 causal and at the f32 path's
prefill, worked out by hand from the H100's published rates (989 TFLOP/s
bf16, 495 TF32, 67 f32, 3.35 TB/s).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("shape,dtype,ops_us,bytes_us,ffma_us", [
    ((1, 256, 24, 8, 128, True), "f32", 2.4499, 2.5041, 6.0332),
    ((1, 256, 24, 8, 512, True), "f32", 9.7994, 10.0162, 24.1329),
    ((1, 256, 24, 8, 512, True), "bf16", 2.4523, 5.0081, 12.8839),
    ((1, 256, 24, 8, 384, True), "bf16", 1.8392, 3.7561, 9.6629),
    ((2, 128, 2, 1, 128, True), "f32", 0.10247, 0.23476, 0.25236),
])
def test_f32_attention_bound_is_restated(shape, dtype, ops_us, bytes_us, ffma_us):
    """The bound is the larger of the operations time (3xTF32 on f32
    inputs; q.k at 989 and p.v at 989 / 2 on 16-bit ones) and the bytes
    time, and the FFMA-rate bound is PR 6's."""
    bound_ms, bound_by, ffma_ms = chip_smoke._f32_attention_bounds(*shape, dtype)
    assert bound_ms * 1e3 == pytest.approx(max(ops_us, bytes_us), rel=1e-4)
    assert bound_by == ("operations" if ops_us > bytes_us else "bytes")
    assert ffma_ms * 1e3 == pytest.approx(ffma_us, rel=1e-4)


@pytest.mark.parametrize("D", [128, 256, 384, 512])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_attention_bound_never_exceeds_the_ffma_bound(D, dtype, causal):
    for B, S, H, KV in ((1, 128, 2, 1), (1, 256, 24, 8), (8, 2048, 32, 8)):
        bound_ms, _, ffma_ms = chip_smoke._f32_attention_bounds(B, S, H, KV, D, causal, dtype)
        assert 0 < bound_ms <= ffma_ms


def _report(mangled: str, registers: int = 40, spill: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, 512 bytes smem\n")


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_116flash_f32_kernelIfLi128EEEvNS_9FlashArgsE",
     "flash_f32_kernel<f32,128>"),
    ("_ZN12_GLOBAL__N_116paged_f32_kernelIfLi128EEEvNS_9PagedArgsE",
     "paged_f32_kernel<f32,128>"),
    ("_ZN12_GLOBAL__N_116paged_f32_kernelIaLi128EEEvNS_9PagedArgsE",
     "paged_f32_kernel<int8,128>"),
    ("_ZN12_GLOBAL__N_116paged_f32_kernelI13__nv_bfloat16Li16EEEvNS_9PagedArgsE",
     "paged_f32_kernel<bf16,16>"),
    ("_ZN12_GLOBAL__N_116paged_f32_kernelI6__halfLi32EEEvNS_9PagedArgsE",
     "paged_f32_kernel<f16,32>"),
    ("_ZN12_GLOBAL__N_124paged_f32_combine_kernelILi128EEEvNS_9PagedArgsE",
     "paged_f32_combine_kernel<128>"),
    ("_ZN12_GLOBAL__N_124paged_f32_combine_kernelILi16EEEvNS_9PagedArgsE",
     "paged_f32_combine_kernel<16>"),
])
def test_ptxas_names_of_the_f32_instantiations(mangled, name):
    """The names chip_smoke reads off a ptxas report (and holds the main
    path's instantiations and the spill check to)."""
    [entry] = chip_smoke.ptxas_entries(_report(mangled, spill=8))
    assert entry == {"name": name, "registers": 40, "spill_bytes": 16, "smem_bytes": 512}


def test_path_instantiations_name_k2_f32s_builds():
    assert {"paged_f32_kernel<f32,128>", "paged_f32_kernel<int8,128>",
            "paged_f32_kernel<bf16,16>", "paged_f32_combine_kernel<128>",
            "paged_f32_combine_kernel<16>", "flash_f32_kernel<f32,128>"} <= set(
                chip_smoke.PATH_INSTANTIATIONS)


@pytest.mark.parametrize("kv_bytes,scales,nbytes", [(2, False, 664), (1, True, 520)])
def test_paged_bound_counts_a_shared_block_once(kv_bytes, scales, nbytes):
    """The paged kernels' bound reads each visible (block, position) pair
    once: lane 1's three positions lie in block 1, which lane 0 reads
    too, so 6 pairs of K and V (plus int8 scales), q and the output in
    bf16, the table and the lengths; worked out by hand."""
    import torch

    table = torch.tensor([[1, 2], [1, 3]], dtype=torch.int32)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    bound_ms, bound_by = chip_smoke._paged_bound(torch, table, lengths, 4, 2, 1, 16,
                                                 kv_bytes, scales)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / chip_smoke.PEAK_BYTES * 1e3, rel=1e-12)


# ---- phase 14, the process entry: its helpers on recorded rows -------------

def _row(cycle, admitted, ts, applied=True, restored="cold"):
    return {"ts": ts, "cycle": cycle, "burn_state": "fast_burn", "priority": 10,
            "admitted": admitted, "remediation_applied": applied,
            "order_flipped": admitted == ["steady", "burny"], "restored": restored}


FIRST, FLIPPED = ["burny", "steady"], ["steady", "burny"]


def _rows(n=4, t0=100.0):
    return [_row(i, FIRST if i == 0 else FLIPPED, t0 + i) for i in range(n)]


def test_entry_orders_reads_the_order_before_and_after():
    assert chip_smoke.entry_orders(_rows()) == (FIRST, FLIPPED)


@pytest.mark.parametrize("break_it", [
    lambda rows: rows.__setitem__(0, {**rows[0], "admitted": FLIPPED}),
    lambda rows: rows.__setitem__(2, {**rows[2], "admitted": FIRST}),
    lambda rows: rows.__setitem__(1, {**rows[1], "remediation_applied": False}),
    lambda rows: rows.pop(0),
    lambda rows: rows.clear(),
], ids=["cycle0_flipped", "late_cycle_unflipped", "not_applied", "no_cycle0", "no_rows"])
def test_entry_orders_fails_a_wrong_run(break_it):
    rows = _rows()
    break_it(rows)
    with pytest.raises(SystemExit):
        chip_smoke.entry_orders(rows)


def test_rows_mismatch_ignores_only_ts():
    card, cpu = _rows(t0=100.0), _rows(t0=5.0)
    assert chip_smoke.rows_mismatch(card, cpu) == []
    cpu[2] = {**cpu[2], "priority": 100}
    assert len(chip_smoke.rows_mismatch(card, cpu)) == 1
    assert chip_smoke.rows_mismatch(card, cpu[:3]) == ["4 rows against 3"]


def _killed_run():
    """Rows of a run killed after cycle 2 (snapshot at 2) and restarted
    to cycle 5, and both incarnations' stderr."""
    rows = _rows(3, t0=100.0) + [_row(i, FLIPPED, 200.0 + i, restored="restored")
                                 for i in range(2, 6)]
    stderr = ("frontdoor: remediation demote_tenant -> burny phase=verifying\n"
              "frontdoor: runtime: snapshot restored (age 1.0s, components: "
              "progress,burn,frontdoor,remediation); resuming at cycle 2\n")
    return rows, 150.0, stderr


def test_audit_resume_passes_a_good_restart():
    assert chip_smoke.audit_resume(*_killed_run()) == []


@pytest.mark.parametrize("break_it,failure", [
    (lambda rows, s: ([{**r, "restored": "cold"} for r in rows], s),
     "restarted front door did not resume from its snapshot"),
    (lambda rows, s: ([{**r, "order_flipped": r["ts"] < 150.0} for r in rows], s),
     "the demotion did not survive the front door restart"),
    (lambda rows, s: (rows, s.replace("snapshot restored", "snapshot cold")),
     "front door stderr carries no snapshot-restored line"),
    (lambda rows, s: (rows, s + "frontdoor: remediation demote_tenant -> burny\n"),
     "demote_tenant applied 2 times over both incarnations"),
    (lambda rows, s: ([{**r, "remediation_applied": False} for r in rows], s),
     "front door never applied a live remediation"),
], ids=["not_restored", "demotion_lost", "no_restore_line", "applied_twice", "never_applied"])
def test_audit_resume_names_each_failure(break_it, failure):
    rows, kill_ts, stderr = _killed_run()
    rows, stderr = break_it(rows, stderr)
    assert failure in chip_smoke.audit_resume(rows, kill_ts, stderr)


def test_read_rows_drops_a_torn_row(tmp_path):
    path = tmp_path / "status.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows(3)) + '{"ts": 1.0, "cyc')
    assert chip_smoke.read_rows(path) == _rows(3)
    assert chip_smoke.read_rows(tmp_path / "missing.jsonl") == []


def test_cycle_ms_from_row_timestamps():
    rows = [_row(i, FLIPPED, t) for i, t in enumerate((0.0, 0.5, 0.6, 0.8, 0.9, 1.3))]
    got = chip_smoke._cycle_ms(rows)
    assert got["first"] == pytest.approx(500.0)
    assert got["n"] == 4  # cycles 1-4: 100, 200, 100, 400 ms
    assert got["median"] == pytest.approx(200.0)
    assert got["p90"] == pytest.approx(200.0)


def test_entry_argv_is_the_chaos_lanes():
    argv = chip_smoke.entry_argv(Path("/w"), "cuda", 0, 0.05, 0.2)
    assert argv[1:4] == ["-m", "tpuslo_torch", "frontdoor"]
    flags = dict(zip(argv[4::2], argv[5::2]))
    assert flags["--device"] == "cuda"
    assert flags["--interval-s"] == "0.05" and flags["--snapshot-interval-s"] == "0.2"
    assert argv[-1] == "--json"


# ---- batch invariance: the new build, the exactness and upcast checks -------


@pytest.mark.parametrize("mangled,name", [
    ("_ZN51_GLOBAL__N__b8d85e21_18_batch_invariant_cu_17c3d05a15rms_norm_kernelI13__nv_bfloat16"
     "Li8ELb1EEEvPKT_S4_PS2_ixxff", "rms_norm_kernel<bf16,8>"),
    ("_ZN51_GLOBAL__N__b8d85e21_18_batch_invariant_cu_17c3d05a15rms_norm_kernelIfLi4ELb1EEEvPKT_S3_"
     "PS1_ixxff", "rms_norm_kernel<f32,4>"),
    ("_ZN51_GLOBAL__N__b8d85e21_18_batch_invariant_cu_17c3d05a15add_norm_kernelI13__nv_bfloat16"
     "Li8ELb0EEEvPKT_S4_S4_PS2_S5_ixxxxff", "add_norm_kernel<bf16,8>"),
    ("_ZN51_GLOBAL__N__b8d85e21_18_batch_invariant_cu_17c3d05a15add_norm_kernelIfLi4ELb1EEEvPKT_S3_"
     "S3_PS1_S4_ixxxxff", "add_norm_kernel<f32,4>"),
    ("_ZN51_GLOBAL__N__848908c5_18_paged_attention_cu_f6a6c6d318paged_split_kernelI13__nv_"
     "bfloat16Li64ELi4EEEvNS_4ArgsE", "paged_split_kernel<bf16,64,4>"),
])
def test_ptxas_names_of_the_lane_path(mangled, name):
    """The names of the instantiations the batch-invariant path adds, as
    a card's ptxas report spells them (the RMSNorm kernel and the fused
    add + RMSNorm kernel on 16-byte packs; K2 at the 1B draft's head dim
    64 and 4 query heads per kv head)."""
    [entry] = chip_smoke.ptxas_entries(_report(mangled, spill=0))
    assert entry["name"] == name
    assert name in chip_smoke.PATH_INSTANTIATIONS


def test_the_build_lists_every_source():
    assert set(chip_smoke.KERNELS) == {p.stem for p in chip_smoke.ROOT.glob(
        "tpuslo_torch/ops/csrc/*.cu")}


def test_bench_ii_serves_the_models_dtype():
    assert chip_smoke.BENCH_3B_DTYPE == "bfloat16"


def test_bench_ii_keeps_the_3b_widths_at_half_its_depth():
    """Bench (ii)'s time cuts lower depth only: 14 of 28 layers, then 7 to
    make room for the MoE and probe phases, then 2 for the multi-device
    phase (and phase 21 serves 8 of mixtral_2b6's 16 layers)."""
    assert chip_smoke.BENCH_3B_LAYERS == 2 and chip_smoke.BENCH_3B_STREAMS == 96
    assert chip_smoke.MOE_LAYERS == 8


def test_bench_ii_cuts_its_window_with_its_streams():
    """Bench (ii) serves the JAX bench's first 96 records at its rate of
    192 a second: the same records as over a 1 s window, offsets halved."""
    import inspect

    from tpuslo_torch.benchmark import frontdoor_bench
    from tpuslo_torch.cli.loadgen import synthesize_requests

    defaults = inspect.signature(frontdoor_bench.run_frontdoor_bench).parameters
    jax_rate = defaults["streams"].default / defaults["arrival_window_s"].default
    n, window = chip_smoke.BENCH_3B_STREAMS, chip_smoke.BENCH_3B_WINDOW_S
    assert n / window == jax_rate == 192

    def records(duration_s):
        return synthesize_requests(profile="chat_short", rps=n / duration_s,
                                   duration_s=duration_s, seed=defaults["seed"].default,
                                   arrival="burst", tenants=4, tenant_mix="40,30,20,10",
                                   prefix_rate=0.35)[:n]

    cut, whole = records(window), records(1.0)
    assert len(cut) == n
    for a, b in zip(cut, whole):
        # loadgen rounds each offset to the microsecond
        assert a["offset_ms"] == pytest.approx(b["offset_ms"] * window, abs=1e-3)
        assert {k: v for k, v in a.items() if k != "offset_ms"} == \
            {k: v for k, v in b.items() if k != "offset_ms"}
    assert max(r["offset_ms"] for r in cut) < 1000.0 * window


def test_hold_exact_fails_only_a_held_stream():
    ok = chip_smoke._hold_exact("t", [[1, 2, 3], [1, 9, 3]], [[1, 2, 3], [1, 2, 3]],
                                [True, False])
    assert ok["held"] == 1 and ok["held_equal"] == 1 and ok["parted_at"] == [None, 1]
    with pytest.raises(SystemExit):
        chip_smoke._hold_exact("t", [[1, 2, 3], [1, 9, 3]], [[1, 2, 3], [1, 2, 3]],
                               [True, True])
    with pytest.raises(SystemExit):
        chip_smoke._hold_exact("t", [[1, 2]], [[1, 2, 3]], [True])


@pytest.mark.parametrize("n,bucket", [(1, 32), (32, 32), (33, 64), (129, 256), (256, 256),
                                      (257, None)])
def test_own_bucket(n, bucket):
    from tpuslo_torch.models import serve

    assert chip_smoke._own_bucket(serve, None, list(range(n))) == bucket


def test_ulps_reads_bf16_ulps():
    import torch

    ref = torch.tensor([1.0, 3.0, -0.5])
    got = ref + torch.tensor([2.0**-7, 0.0, -(2.0**-9)])
    assert chip_smoke._ulps(torch, got, ref, 7) == pytest.approx(1.0)


def test_cache_upcasts_sees_the_plain_paths_copies(monkeypatch):
    """The check that no pass copies a whole cache: the plain attention
    over the cache upcasts each side (found, at the cache's length), and
    a conversion of the step's own rows is not such a copy (the card's
    lanes read the cache in place, which only a card run shows)."""
    import torch

    from tpuslo_torch.models import kv_cache, llama

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    T = 160
    k = torch.randn(2, T, 2, 16).bfloat16()
    q = torch.randn(2, 3, 4, 16).bfloat16()
    mask = torch.arange(T)[None, None, :] <= torch.tensor([[5, 6, 7], [90, 91, 92]])[:, :, None]
    plain = chip_smoke._cache_upcasts(
        torch, lambda: llama.attention(q, kv_cache.kv_load(k), kv_cache.kv_load(k), mask, 2), T)
    assert len(plain) >= 2 and all(u["shape"][-3] == T for u in plain)
    assert chip_smoke._cache_upcasts(torch, lambda: q.float(), T) == []


def test_rounding_ties_counts_only_ties():
    """A norm output two ulps off the plain version is a rounding tie only
    where the exact pre-weight product sits on a bf16 midpoint: a row of
    one value v (rms 1/|v|, the product exactly 1.0 or -1.0) has none;
    an output bumped off by two ulps there is counted far, not a tie."""
    import torch

    from tpuslo_torch.ops import rms_norm as rn

    h = torch.full((2, 64), 3.0).bfloat16()
    w = torch.full((64,), 0.9).bfloat16()
    ref = rn.rms_norm_reference(h, w, 0.0)
    assert chip_smoke._rounding_ties(torch, h, w, ref.clone(), ref, 0.0) == (0, 0)
    got = ref.clone()
    got[1, 5] = float(ref[1, 5]) * (1 + 2 * 2.0**-7)
    assert chip_smoke._rounding_ties(torch, h, w, got, ref, 0.0) == (1, 0)


def test_hold_norm_holds_the_pre_weight_value_and_y():
    """Phase 18's rule for a norm kernel: the same bits pass; T(h x rms)
    two ulps off fails even where y agrees; y two ulps off where no
    rounding tie explains it fails."""
    import torch

    from tpuslo_torch.ops import rms_norm as rn

    h = torch.full((2, 64), 3.0).bfloat16()
    w = torch.full((64,), 0.9).bfloat16()
    ref = rn.rms_norm_reference(h, w, 1e-5)
    ref_n = rn.rms_norm_reference(h, torch.ones_like(w), 1e-5)
    held = chip_smoke._hold_norm(torch, "same", h, w, ref.clone(), ref, ref_n.clone(), ref_n)
    assert held["max_err_ulps"] == held["pre_weight_err_ulps"] == 0.0
    assert held["rounding_ties"] == held["over_tol_elements"] == 0
    off = ref_n.clone()
    off[0, 3] = float(ref_n[0, 3]) * (1 + 2 * 2.0**-7)
    with pytest.raises(SystemExit):
        chip_smoke._hold_norm(torch, "pre-weight", h, w, ref.clone(), ref, off, ref_n)
    got = ref.clone()
    got[1, 5] = float(ref[1, 5]) * (1 + 2 * 2.0**-7)
    with pytest.raises(SystemExit):
        chip_smoke._hold_norm(torch, "y", h, w, got, ref, ref_n.clone(), ref_n)


def test_range_breakdown_splits_an_admitting_window_by_range():
    """Phase 12's breakdown of a window: the admission ranges split into
    the target's (the first half in start order) and the draft's, each
    range's device ms and the ops inside its spans counted, the ops
    outside every span kept apart."""
    from types import SimpleNamespace as S

    def span(lane, start, dur, module="", launch=0):
        return S(lane=lane, start_us=start, duration_us=dur, module_name=module,
                 program_id="p", launch_id=launch)

    mods, ops = "modules", "ops"
    spans = [span(mods, 0, 10, "prefill", 1), span(mods, 20, 10, "prefill", 2),
             span(mods, 40, 5, "spec_multi_round", 3)]
    spans += [span(ops, t, 1) for t in (1, 2, 21, 41, 42, 60)]
    got = chip_smoke._range_breakdown(spans, mods, ops)
    assert got["target.prefill"] == {"ms": 0.01, "ranges": 1, "kernels": 2}
    assert got["draft.prefill"] == {"ms": 0.01, "ranges": 1, "kernels": 1}
    assert got["spec_multi_round"]["kernels"] == 2
    assert got["outside_ranges"] == {"ms": 0.001, "ranges": 0, "kernels": 1}


def test_the_probe_mode_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.probe_main(["norm", "--tree", str(chip_smoke.ROOT)]) == 2


def _serving_report() -> dict:
    """A serving report that meets every gate of phase 20."""
    return {
        "model": "llama32_3b", "n_params": 3_606_752_256, "flash_attention": True,
        "prefill_k1_launches": 28, "xla_launch_join_rate_substantive": 0.97,
        "xla_launch_matches": 3, "bw_decode_b1": {"hbm_bw_pct": 61.4},
        "deviceplane": {"substantive_join_rate": 1.0, "unexplained_share": 0.0002},
        "profiler": {"overhead_ema_pct": 0.08, "min_substantive_join_rate": 1.0},
        "kv": {"paged": {"k2_launches": 10},
               "batch_curve": {"k2_launches": 4, "curve": [{"batch": 1, "ms_per_step": 9.0}]},
               "shared_prefix": {"k2_launches": 5}},
        "int8": {"model": "llama3_8b", "n_params": 8_030_261_248,
                 "bw_decode_b8": {"hbm_bw_pct": 40.0}},
        "speculative_measured": {"parity_ok": True, "acceptance_rate": 0.93,
                                 "measured_speedup": 1.4},
        "moe": {"model": "mixtral_2b6", "n_params": 2_513_635_328, "ttft_ms": 31.5,
                "decode_tokens_per_sec": 40.2, "k1_launches": 0, "k2_launches": 1536},
    }


def test_serving_gates_pass_a_good_report():
    assert chip_smoke.serving_failures(_serving_report()) == []


@pytest.mark.parametrize("break_it,failure", [
    (lambda r: r["kv"]["batch_curve"]["curve"][0].update(pallas_error="boom"), "pallas_error"),
    (lambda r: r.update(prefix_cache={"error": "OOM"}), "prefix_cache: error"),
    (lambda r: r.update(xprof_error="no trace"), "xprof_error"),
    (lambda r: r["int8"].update(retried=True), "int8: retried"),
    (lambda r: r["int8"]["bw_decode_b8"].update(hbm_bw_pct=100.5), "hbm_bw_pct 100.5"),
    (lambda r: r["deviceplane"].update(substantive_join_rate=0.89), "device-plane substantive"),
    (lambda r: r["deviceplane"].update(unexplained_share=0.11), "unexplained share"),
    (lambda r: r["profiler"].update(overhead_ema_pct=3.2), "overhead EMA"),
    (lambda r: r["profiler"].update(min_substantive_join_rate=0.5), "window join"),
    (lambda r: r.pop("xla_launch_join_rate_substantive"), "not the ledger's rate"),
    (lambda r: r.update(xla_launch_matches=0), "joined no device-time signal"),
    (lambda r: r.update(prefill_k1_launches=0), "K1 was not launched"),
    (lambda r: r["kv"]["paged"].update(k2_launches=0), "K2 was not launched in the paged"),
    (lambda r: r["kv"]["shared_prefix"].update(k2_launches=0), "shared_prefix lane"),
    (lambda r: r.update(n_params=3_606_752_257), "bf16 model llama32_3b"),
    (lambda r: r["int8"].update(model="llama32_3b"), "int8 model llama32_3b"),
    (lambda r: r.update(speculative_measured={"tokens_per_sec": 1.0}),
     "speculative_measured is not measured"),
    (lambda r: r.update(speculative_measured={"not_ported": "ROADMAP 14"}),
     "speculative_measured is not measured"),
    (lambda r: r["speculative_measured"].update(parity_ok=False), "streams differ"),
    (lambda r: r.update(moe={"not_ported": "ROADMAP 12"}), "moe model None"),
    (lambda r: r["moe"].update(n_params=2_513_635_327), "moe model mixtral_2b6"),
    (lambda r: r["moe"].pop("ttft_ms"), "moe lane has no ttft_ms"),
    (lambda r: r["moe"].update(decode_tokens_per_sec=0.0), "no decode_tokens_per_sec"),
    (lambda r: r["moe"].update(k2_launches=0), "K2 was not launched in the moe lane"),
    (lambda r: r["moe"].update(error="RuntimeError: OOM"), "moe: error"),
])
def test_serving_gates_name_each_failure(break_it, failure):
    report = _serving_report()
    break_it(report)
    fails = chip_smoke.serving_failures(report)
    assert fails and any(failure in f for f in fails), fails


def test_every_phase_marks_when_it_ended():
    """main() prints each phase's end in seconds from the start and keeps
    them in the record: every phase from the build to 27, the last
    line's (19) aside, once, in the order the phases run."""
    import re

    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    names = re.findall(r'mark\("([^"]+)"\)', main)
    numbers = [int(n.split()[0]) for n in names]
    assert sorted(numbers) == [n for n in range(2, 28) if n != 19]
    assert numbers.index(20) == numbers.index(16) + 1 and numbers[-1] == 27
    for name in names:
        assert main.index(f'mark("{name}")') < main.index('kernels = {"kernels": [')
    assert '"phase_end_s": marks' in main


def _cut_report() -> dict:
    """A good serving report whose three models ran at SERVING_LAYERS."""
    r = _serving_report()
    cut = chip_smoke.SERVING_CUT_PARAMS
    for lane in (r, r["int8"], r["moe"]):
        lane.update(n_layers=chip_smoke.SERVING_LAYERS, n_params=cut[lane["model"]])
    return r


def test_serving_gates_hold_a_cut_report_to_the_cut_counts():
    assert chip_smoke.serving_failures(_cut_report()) == []


@pytest.mark.parametrize("break_it,failure", [
    (lambda r: r.update(n_params=3_606_752_256), "bf16 model llama32_3b"),
    (lambda r: r["int8"].update(n_params=8_030_261_248), "int8 model llama3_8b"),
    (lambda r: r["moe"].update(n_params=2_513_635_328), "moe model mixtral_2b6"),
    (lambda r: r.update(n_layers=7), "bf16 model llama32_3b"),
    (lambda r: r["moe"].update(n_layers=9), "moe model mixtral_2b6"),
])
def test_serving_gates_hold_each_lane_to_its_own_depth(break_it, failure):
    """A lane that says it ran the cut is held to the cut config's count,
    one at another depth to the full config's."""
    report = _cut_report()
    break_it(report)
    fails = chip_smoke.serving_failures(report)
    assert fails and any(failure in f for f in fails), fails


def test_serving_cut_params_are_the_jax_param_counts():
    """The cut counts are the JAX package's ``param_count`` of the bench's
    configs at SERVING_LAYERS layers, and the port's bench builds them."""
    import dataclasses

    from tpuslo.benchmark import serving_bench as jsb
    from tpuslo.models import mixtral
    from tpuslo.models.llama import param_count
    from tpuslo_torch.benchmark import serving_bench as tsb
    from tpuslo_torch.models import llama as tllama
    from tpuslo_torch.models import mixtral as tmixtral

    n = chip_smoke.SERVING_LAYERS
    want = {name: param_count(dataclasses.replace(jsb._make_config(name), n_layers=n))
            for name in ("llama32_3b", "llama3_8b")}
    want["mixtral_2b6"] = mixtral.param_count(
        dataclasses.replace(mixtral.mixtral_2b6(), n_layers=n))
    assert chip_smoke.SERVING_CUT_PARAMS == want
    for name in ("llama32_3b", "llama3_8b"):
        cfg = tsb._make_config(name, n)
        assert cfg.n_layers == n and tllama.param_count(cfg) == want[name]
    assert tmixtral.param_count(tsb._cut(tmixtral.mixtral_2b6(), n)) == want["mixtral_2b6"]


def test_phase_20_runs_the_bench_at_its_depth_cut(monkeypatch):
    """Phase 20 asks the bench for SERVING_LAYERS layers and holds its
    report to the gates."""
    import types

    import torch

    seen = []

    def run(argv, **kwargs):
        seen.append(argv)
        return types.SimpleNamespace(
            returncode=0, stderr="", stdout="SERVING_BENCH:" + json.dumps(_cut_report()))

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    out = chip_smoke.phase_serving(torch)
    assert seen[0][-2:] == ["--layers", str(chip_smoke.SERVING_LAYERS)]
    assert out["report"]["n_layers"] == chip_smoke.SERVING_LAYERS


def test_serving_models_are_the_jax_param_counts():
    """The constants phase 20 holds ``n_params`` to are the JAX package's
    ``param_count`` of the bench's two configs."""
    from tpuslo.benchmark import serving_bench as jsb
    from tpuslo.models.llama import param_count

    assert chip_smoke.SERVING_MODELS == {
        name: param_count(jsb._make_config(name)) for name in ("llama32_3b", "llama3_8b")}


def test_serving_moe_is_the_jax_param_count():
    from tpuslo.models import mixtral

    assert chip_smoke.SERVING_MOE == ("mixtral_2b6", mixtral.param_count(mixtral.mixtral_2b6()))


# --- phase 23: training ------------------------------------------------------


def test_phase_23_runs_after_phase_22_and_feeds_the_kernels_line():
    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    assert main.index("phase_probe(torch)") < main.index("phase_train(torch, fa, pa")
    assert main.index("phase_train(torch, fa, pa") < main.index('kernels = {"kernels": [')
    # its profiled times are taken early, right after phase 18
    assert (main.index("phase_invariance(") < main.index("_train_timings(")
            < main.index("phase_bench(torch"))
    for counter in ("flash_attention", "flash_attention_f32", "paged_attention",
                    "paged_attention_f32", "rms_norm", "add_rms_norm"):
        assert f'train_launches["{counter}"]' in main, counter


def test_phase_23_holds_the_jax_param_counts():
    from tpuslo.models import llama, mixtral

    assert chip_smoke.TRAIN_3B_PARAMS == llama.param_count(llama.llama32_3b())
    assert chip_smoke.TRAIN_MOE_PARAMS == mixtral.param_count(mixtral.mixtral_2b6())


def test_the_script_exits_2_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chip_smoke.sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 2
    assert chip_smoke.probe_main(["train"]) == 2
    assert '{"ok": true' not in capsys.readouterr().out


class _Event:
    def __init__(self, key, us, count):
        self.key, self.self_device_time_total, self.count = key, us, count


def test_kernel_groups_sum_a_traced_step_by_family():
    kernels = [_Event("void flash_fwd_kernel<128>(...)", 900.0, 56),
               _Event("void add_norm_kernel<__nv_bfloat16, 8>(...)", 300.0, 112),
               _Event("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", 50_000.0, 500),
               _Event("void at::native::(anonymous)::multi_tensor_apply_kernel<...>", 20_000.0,
                      90),
               _Event("void at::native::elementwise_kernel<128, 2, ...>", 4_000.0, 3000)]
    groups = chip_smoke._kernel_groups(kernels)
    assert groups["K1"] == {"ms": 0.9, "launches": 56}
    assert groups["norm kernels"] == {"ms": 0.3, "launches": 112}
    assert groups["GEMM"] == {"ms": 50.0, "launches": 500}
    assert groups["optimizer"] == {"ms": 20.0, "launches": 90}
    assert groups["other"] == {"ms": 4.0, "launches": 3000}
    assert sum(g["ms"] for g in groups.values()) == pytest.approx(75.2)


def test_rel_err_is_relative_to_the_largest_reference_value():
    import torch

    ref = torch.tensor([0.5, -4.0, 2.0])
    assert chip_smoke._rel_err(torch.tensor([0.5, -4.0, 2.5]), ref) == pytest.approx(0.125)
    assert chip_smoke._rel_err(ref.bfloat16(), ref) == 0.0


# --- phase 24: the multi-device plane on one card -----------------------------


def test_phase_24_runs_after_phase_23_and_feeds_the_kernels_line():
    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    assert main.index("phase_train(torch, fa, pa") < main.index("phase_multidevice(torch")
    assert main.index("phase_multidevice(torch") < main.index('kernels = {"kernels": [')
    assert 'multi_launches["k1"]' in main and 'multi_launches["k2"]' in main
    assert '"multidevice": multi' in main
    assert main.index("phase_paged_kernel_f32(") < main.index("phase_paged_kernel_f32_hd24(")
    # (a)'s profiled part runs early, while traces keep their kernel events
    assert (main.index("_train_timings(") < main.index("open_nccl_rank(torch)")
            < main.index("capture_collectives(torch)") < main.index("phase_bench(torch"))


def test_phase_24_prints_one_line_per_part_and_its_json_line():
    source = (Path(chip_smoke.__file__)).read_text()
    for part in ("(a) collectives", "(b) stragglers", "(c) tp 1", "(d) tp 2"):
        assert source.count(f'f"multidevice {part}') == 1, part
    phase = source[source.index("def phase_multidevice("):source.index("def _load_tree(")]
    for key in ("collectives", "tp1", "stragglers", "tp2", "seconds"):
        assert f'out["{key}"]' in phase, key
    assert 'print(f"multidevice: {json.dumps(multi)}"' in source


def test_the_k2_f32_head_dim_24_instantiations_are_on_the_path():
    for name in ("paged_f32_kernel<f32,24>", "paged_f32_kernel<bf16,24>",
                 "paged_f32_combine_kernel<24>"):
        assert name in chip_smoke.PATH_INSTANTIATIONS
    assert chip_smoke.ptxas_entries(
        "Compiling entry function '_ZN12_GLOBAL__N_116paged_f32_kernelIfLi24EEEvNS_9PagedArgsE'"
    )[0]["name"] == "paged_f32_kernel<f32,24>"
    assert chip_smoke.HD24["HD"] == 24 and chip_smoke.HD24["H"] // chip_smoke.HD24["KV"] == 2


def _straggler_report(incidents, dcn=3.0, errors=()):
    return {"incidents": [{"straggler_host": h, "host_latencies_ms": {}} for h in incidents],
            "errors": list(errors), "top_confidence": 0.9, "dcn_transfer_ms_max": dcn,
            "dcn_events": 8}


@pytest.mark.parametrize("delayed,sliced,failure", [
    (_straggler_report([1, 2, 1]), _straggler_report([]), "not named in every incident"),
    (_straggler_report([]), _straggler_report([]), "not named in every incident"),
    (_straggler_report([1], errors=["worker timeout"]), _straggler_report([]), "not named in every incident"),
    (_straggler_report([1, 1]), _straggler_report([], dcn=0.0), "dcn component of 0.0"),
    (_straggler_report([1, 1]), _straggler_report([], errors=["boom"]), "dcn component"),
])
def test_a_failed_straggler_part_fails_the_script(delayed, sliced, failure, monkeypatch,
                                                  capsys, tmp_path):
    reports = iter([delayed, sliced])
    monkeypatch.setattr(chip_smoke, "_icibench", lambda argv, workdir, name: ([], next(reports)))
    with pytest.raises(SystemExit) as exit_:
        chip_smoke._multi_stragglers(tmp_path)
    assert exit_.value.code == 1
    assert failure in capsys.readouterr().err


def test_a_good_straggler_part_passes(monkeypatch, tmp_path):
    reports = iter([_straggler_report([1, 1, 1]), _straggler_report([], dcn=2.5)])
    monkeypatch.setattr(chip_smoke, "_icibench", lambda argv, workdir, name: ([], next(reports)))
    out = chip_smoke._multi_stragglers(tmp_path)
    assert out["incidents"] == [1, 1, 1] and out["dcn_transfer_ms_max"] == 2.5


def test_icibench_failures_fail_the_script(monkeypatch, capsys, tmp_path):
    """A non-zero icibench, or an event the validator refuses, ends the
    run with exit 1."""
    import types

    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(returncode=1, stderr="boom"))
    with pytest.raises(SystemExit) as exit_:
        chip_smoke._icibench(["--reps", "1"], tmp_path, "x")
    assert exit_.value.code == 1 and "exited 1" in capsys.readouterr().err

    def bad_events(argv, **kw):
        out = argv[argv.index("--output") + 1]
        Path(out).write_text(json.dumps({"signal": "ici_collective_latency_ms"}) + "\n")
        return types.SimpleNamespace(returncode=0, stderr="")

    monkeypatch.setattr(chip_smoke.subprocess, "run", bad_events)
    with pytest.raises(SystemExit):
        chip_smoke._icibench(["--reps", "1"], tmp_path, "y")
    assert "schema-invalid" in capsys.readouterr().err


def test_a_failed_part_is_not_caught_and_the_group_is_torn_down(monkeypatch, tmp_path):
    """Phase 24 catches no part's failure: the exit propagates (the
    script exits 1 with no result line) after the NCCL group is torn
    down, and no later part runs."""
    import torch
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: calls.append("destroy"))

    def collectives(*a, **k):
        calls.append("a")
        chip_smoke._fail("multidevice: a part failed")

    monkeypatch.setattr(chip_smoke, "_multi_collectives", collectives)
    for later in ("_multi_tp1", "_multi_stragglers", "_multi_tp2"):
        monkeypatch.setattr(chip_smoke, later, lambda *a, **k: calls.append(later))
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.phase_multidevice(torch, None, None, {})
    assert exit_.value.code == 1
    assert calls == ["a", "destroy"]


def _phase_24_parts(monkeypatch, stragglers):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: calls.append("destroy"))
    monkeypatch.setattr(chip_smoke, "_multi_collectives", lambda *a: calls.append("a") or {})

    def part(name):
        def run(*a):
            calls.append(f"{name} start")
            chip_smoke.time.sleep(0.4)
            calls.append(f"{name} end")
            return {}
        return run

    monkeypatch.setattr(chip_smoke, "_multi_tp1", part("c"))
    monkeypatch.setattr(chip_smoke, "_multi_tp2", part("d"))
    monkeypatch.setattr(chip_smoke, "_multi_stragglers", stragglers)
    return calls


def test_phase_24_runs_the_stragglers_beside_the_tp_parts(monkeypatch):
    """(b)'s CPU processes run in a thread while (c) and (d) run here:
    the phase takes about the longer of the two, not their sum."""
    import torch

    def stragglers(workdir):
        chip_smoke.time.sleep(0.6)
        assert workdir.is_dir()
        return {"incidents": [1]}

    calls = _phase_24_parts(monkeypatch, stragglers)
    out = chip_smoke.phase_multidevice(torch, None, None, {})
    assert calls == ["a", "c start", "c end", "destroy", "d start", "d end"]
    assert out["stragglers"]["incidents"] == [1] and out["seconds"] < 1.2
    assert all("seconds" in out[k] for k in ("collectives", "tp1", "stragglers", "tp2"))


def test_a_failed_straggler_thread_fails_the_phase(monkeypatch, capsys):
    import torch

    def stragglers(workdir):
        chip_smoke._fail("multidevice: the delayed host 1 is not named")

    _phase_24_parts(monkeypatch, stragglers)
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.phase_multidevice(torch, None, None, {})
    assert exit_.value.code == 1 and "host 1 is not named" in capsys.readouterr().err


def test_the_train_attention_bound_counts_the_ports_backward():
    """K1's forward and the plain backward at the train step (B 8, S 128,
    24 heads over 8, D 128, bf16): 16.8 MB forward (q, k, v read, o
    written) and 27.3 MB backward (q, k, v and the cotangent read; dq, dk,
    dv written: the port's backward recomputes the probabilities and
    never reads o), bytes-bound at 3.35 TB/s, against 2.84 GFLOP."""
    ms, by = chip_smoke.train_attention_bound(8, 128, 24, 8, 128)
    assert by == "bytes"
    assert ms == pytest.approx(44_040_192 / 3.35e12 * 1e3)
    assert chip_smoke.TRAIN_GRAD_SHAPES[0] == (8, 128, 24, 8, 128)


# --- phase 25: sequence parallelism -------------------------------------------


def test_phase_25_runs_after_phase_24_and_feeds_the_kernels_line():
    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    assert main.index("phase_multidevice(torch") < main.index("phase_sp(torch")
    assert main.index("phase_sp(torch") < main.index('kernels = {"kernels": [')
    for kernel in ("flash_attention", "paged_attention", "rms_norm", "add_rms_norm"):
        assert f'sp_launches["{kernel}"]' in main, kernel
    assert '"sp": sp' in main and 'print(f"sp: {json.dumps(sp)}"' in main


def test_phase_25_prints_one_line_per_part():
    source = (Path(chip_smoke.__file__)).read_text()
    for part in ("(a) sp 1", "(b) sp 2", "(c) mixtral"):
        assert source.count(f'f"sp {part}') == 1, part
    # the prompt is not padded at sp 1 or 2 and takes chunked appends
    assert chip_smoke.SP_IDS % 128 == 0 and chip_smoke.SP_IDS > chip_smoke.BUCKETS[-1]
    assert len(chip_smoke.SP_PROMPT) == chip_smoke.SP_IDS - 1


def _phase_25_modules():
    import importlib

    return [importlib.import_module(f"tpuslo_torch.ops.{m}")
            for m in ("flash_attention", "paged_attention", "rms_norm", "launch_counts")]


def test_phase_25_rehearses_on_the_cpu_at_a_tiny_width(monkeypatch):
    """Phase 25's functions at a 2-layer width on the CPU: sp 1 over a
    one-rank gloo group, sp 2 as two gloo processes.  The CPU reads no
    cache as K2's lanes, so the lane check is the one part stubbed."""
    import sys

    import torch

    from tpuslo_torch.models import llama, mixtral

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)  # the ranks import it
    monkeypatch.setattr(chip_smoke, "_hold_lanes", lambda *a, **k: None)
    cfg = llama.llama_tiny(max_seq_len=512)
    out = chip_smoke.phase_sp(torch, *_phase_25_modules(), cfg=cfg,
                              moe_cfg=mixtral.mixtral_tiny(max_seq_len=256), device="cpu",
                              prompt=chip_smoke.SP_PROMPT[:299])
    sp1, sp2 = out["sp1"], out["sp2"]
    assert sp1["ring_bitwise"] and sp1["prompt_ids"] == 300
    assert sp1["max_logit_err"] <= chip_smoke.PARITY_TOL
    assert sp1["sp_ingest_calls"] == {"all_reduce": 1, "all_gather": 2}
    assert sp2["max_logit_err"] <= chip_smoke.PARITY_TOL
    steps = chip_smoke.SP_TOKENS - 1
    for calls in sp2["collectives"]:
        assert calls == {"shift": 2 * cfg.n_layers, "all_reduce": 1 + 2 * steps * cfg.n_layers,
                         "all_reduce_max": steps * cfg.n_layers}
    assert sp2["host_copies"] == [0, 0] and len(sp2["decode_step_ms"]) == 2
    assert out["moe"]["tokens"] == chip_smoke.SP_MOE_TOKENS
    assert not torch.distributed.is_initialized()


def test_a_failed_sp_part_is_not_caught_and_the_group_is_torn_down(monkeypatch):
    import torch
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(chip_smoke, "open_nccl_rank", lambda *a, **k: calls.append("open"))
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: calls.append("destroy"))

    def sp1(*a, **k):
        calls.append("a")
        chip_smoke._fail("sp: a part failed")

    monkeypatch.setattr(chip_smoke, "_sp1", sp1)
    for later in ("_sp_moe", "_sp2"):
        monkeypatch.setattr(chip_smoke, later, lambda *a, **k: calls.append(later))
    with pytest.raises(SystemExit) as exit_:
        chip_smoke.phase_sp(torch, *_phase_25_modules(), device="cpu")
    assert exit_.value.code == 1
    assert calls == ["open", "a", "destroy"]


# --- phase 26: Mixtral serving over tp and ep meshes -------------------------


def test_phase_26_runs_after_phase_25_and_feeds_the_kernels_line():
    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    assert main.index("phase_sp(torch") < main.index("phase_moemesh(torch")
    assert main.index("phase_moemesh(torch") < main.index('kernels = {"kernels": [')
    for kernel in ("flash_attention", "paged_attention", "rms_norm", "add_rms_norm"):
        assert f'moemesh_launches["{kernel}"]' in main, kernel
    assert '"moemesh": moemesh' in main and 'print(f"moemesh: {json.dumps(moemesh)}"' in main


def test_phase_26_prints_one_line_per_part():
    source = (Path(chip_smoke.__file__)).read_text()
    for part in ("(a) tp 1 and ep 1", "(b) moe_mlp_sharded", "(c) {axis} 2"):
        assert source.count(f'print(f"moemesh {part}') == 1, part
    # the prompts prefill at buckets 128 and 256, where K1 runs at head dim 128
    from tpuslo_torch.models import serve

    assert [serve._bucket(len(serve.encode_bytes(p, 256)), chip_smoke.MOE_BUCKETS)
            for p in chip_smoke.MOEMESH_PROMPTS] == [128, 256]


def test_phase_26_rehearses_on_the_cpu_at_a_tiny_width(monkeypatch):
    """Phase 26's functions at mixtral_tiny's width on the CPU: tp 1, ep 1
    and the exchange over a one-rank gloo group, tp 2 and ep 2 as two gloo
    processes.  The CPU launches neither K1 nor K2, so the two launch
    checks are the parts stubbed."""
    import sys

    import torch

    from tpuslo_torch.models import mixtral

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)  # the ranks import it
    monkeypatch.setattr(chip_smoke, "_hold_lanes", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "_hold_launched", lambda *a, **k: None)
    cfg = mixtral.mixtral_tiny(max_seq_len=512)
    out = chip_smoke.phase_moemesh(torch, *_phase_25_modules(), cfg=cfg, device="cpu")
    one = out["one_rank"]
    assert all(all(v.values()) for v in one["equal"].values())
    L = cfg.n_layers
    assert one["calls"]["ep"] == {"all_reduce": one["calls"]["ep"]["all_reduce"]}
    assert one["calls"]["ep"]["all_reduce"] % L == 0
    assert set(one["calls"]["tp"]) == {"all_reduce", "all_gather"}
    assert out["exchange"]["calls"] == {"all_to_all": 2}
    assert 0 < out["ep_err"] <= out["exchange"]["tol"]
    two = out["two_ranks"]
    assert two["tp"]["max_logit_err"] <= chip_smoke.PARITY_TOL
    assert two["ep"]["bitwise"] and two["ep"]["max_logit_err"] == 0.0
    for axis in ("tp", "ep"):
        for rank in two[axis]["per_rank"]:
            assert rank["host_copies"] == 0 and len(rank["step_ms"]) == 2
    assert two["tp"]["shards"]["w1"] == (L, cfg.n_experts, cfg.dim, cfg.ffn_dim // 2)
    assert two["ep"]["shards"]["w1"] == (L, cfg.n_experts // 2, cfg.dim, cfg.ffn_dim)
    assert out["tp_moe_tokens"] == _left_count(two["tp"]["tokens"])
    assert not torch.distributed.is_initialized()


def _left_count(rows):
    return sum(r["diverged_at"] is not None for r in rows)


def test_a_failed_moemesh_part_is_not_caught_and_the_group_is_torn_down(monkeypatch):
    import torch
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(chip_smoke, "open_nccl_rank", lambda *a, **k: calls.append("open"))
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: calls.append("destroy"))

    def one(*a, **k):
        calls.append("a")
        chip_smoke._fail("moemesh: a part failed")

    monkeypatch.setattr(chip_smoke, "_moemesh1", one)
    for later in ("_moemesh_exchange", "_moemesh2"):
        monkeypatch.setattr(chip_smoke, later, lambda *a, **k: calls.append(later))
    from tpuslo_torch.models import mixtral

    with pytest.raises(SystemExit) as exit_:
        chip_smoke.phase_moemesh(torch, *_phase_25_modules(),
                                 cfg=mixtral.mixtral_tiny(max_seq_len=512), device="cpu")
    assert exit_.value.code == 1
    assert calls == ["open", "a", "destroy"]


def test_phase_27_runs_after_phase_26_and_feeds_the_kernels_line():
    source = (Path(chip_smoke.__file__)).read_text()
    main = source[source.index("def main() -> int:"):]
    assert main.index("phase_moemesh(torch") < main.index("phase_train_mesh(torch")
    assert main.index("phase_train_mesh(torch") < main.index('kernels = {"kernels": [')
    for kernel in ("flash_attention", "rms_norm", "add_rms_norm"):
        assert f'train_mesh_launches["{kernel}"]' in main, kernel
    assert '"train_mesh": train_mesh' in main
    assert 'print(f"train_mesh: {json.dumps(train_mesh)}"' in main


TRAIN_MESH_KEYS = {"config", "moe_config", "n_layers", "dim", "n_heads", "n_kv_heads", "ffn_dim",
                   "vocab", "n_params", "moe_n_params", "batch", "seq", "steps", "microbatches",
                   "transport", "one_device", "reference_s", "ranks_s", "meshes", "moe_ep2",
                   "pp2", "launches", "seconds"}
TRAIN_MESH_ROW_KEYS = {"losses", "loss_err", "grad_rel_err", "worst_grad_leaf", "param_rel_err",
                       "per_rank"}


def test_phase_27_rehearses_on_the_cpu_at_a_tiny_width(monkeypatch):
    """Phase 27 at llama_tiny's and mixtral_tiny's widths on the CPU: the
    one-device reference in this process, dp 2, fsdp 2, tp 2, dcn 2, pp 2
    and dp 1 x ep 2 as two gloo processes.  The CPU launches none of the
    kernels, so the launch check is the part stubbed; the ``train_mesh:``
    line's keys and each mesh's bounds are the card's."""
    import dataclasses
    import sys

    import torch

    from tpuslo_torch.models import llama, mixtral

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)  # the ranks import it
    monkeypatch.setattr(chip_smoke, "_hold_train_launched", lambda *a, **k: None)
    cfg = llama.llama_tiny(max_seq_len=chip_smoke.TRAIN_SEQ)
    moe_cfg = dataclasses.replace(mixtral.mixtral_tiny(max_seq_len=chip_smoke.TRAIN_SEQ))
    out = chip_smoke.phase_train_mesh(torch, *_phase_25_modules(), cfg=cfg, moe_cfg=moe_cfg,
                                      device="cpu")
    assert set(out) == TRAIN_MESH_KEYS
    json.dumps(out)  # the train_mesh: line
    assert set(out["meshes"]) == {"dp2", "fsdp2", "tp2", "dcn2"}
    for row in [*out["meshes"].values(), out["moe_ep2"]]:
        assert set(row) == TRAIN_MESH_ROW_KEYS
        assert len(row["losses"]) == chip_smoke.TRAIN_MESH_STEPS
        assert row["loss_err"] <= chip_smoke.TRAIN_MESH_LOSS_TOL
        assert row["grad_rel_err"] <= chip_smoke.TRAIN_PARITY_GRAD_REL
        for rank in row["per_rank"]:
            assert rank["host_copies"] == 0 and len(rank["step_wall_ms"]) == 2
    assert out["meshes"]["dp2"]["per_rank"][0]["rows"] == chip_smoke.TRAIN_BATCH // 2
    assert out["meshes"]["tp2"]["per_rank"][0]["rows"] == chip_smoke.TRAIN_BATCH
    assert "reduce_scatter" in out["meshes"]["fsdp2"]["per_rank"][0]["calls_per_step"]
    assert out["pp2"]["max_logit_err"] <= chip_smoke.PARITY_TOL
    ticks = chip_smoke.TRAIN_MESH_MICROBATCHES + 1
    for stage in out["pp2"]["per_rank"]:
        assert stage["forward_calls"] == {"shift": ticks - 1, "all_reduce": 1}
        assert all(stage["layers_with_grad"])
    assert not torch.distributed.is_initialized()


def _mesh_rank(loss_shift=0.0, grad_err=1e-3):
    counts = {"flash_attention": 4, "rms_norm": 2, "add_rms_norm": 8}
    return {"losses": [6.0 + loss_shift, 5.9 + loss_shift], "grad_rel_err": {"embed": grad_err},
            "param_rel_err": {"embed": 1e-4}, "rows": 4, "calls_per_step": {},
            "calls_steps": {}, "host_copies": 0, "launches": counts, "step_wall_ms": [1, 1],
            "peak_gb": 0.0}


@pytest.mark.parametrize("breach", ["none", "loss", "grad", "launch"])
def test_a_train_mesh_bound_breach_fails_the_phase(breach):
    ref = {"losses": [6.0, 5.9]}
    shift = 2 * chip_smoke.TRAIN_MESH_LOSS_TOL if breach == "loss" else 0.0
    grad = 2 * chip_smoke.TRAIN_PARITY_GRAD_REL if breach == "grad" else 1e-3
    ranks = [_mesh_rank(shift, grad), _mesh_rank(shift)]
    if breach == "launch":
        ranks[1]["launches"]["add_rms_norm"] = 0
    if breach == "none":
        row = chip_smoke._train_mesh_row("dp2", ranks, ref)
        assert row["loss_err"] == 0.0 and row["grad_rel_err"] == 1e-3
        return
    with pytest.raises(SystemExit):
        chip_smoke._train_mesh_row("dp2", ranks, ref)


@pytest.mark.parametrize("breach", ["none", "logits", "grad", "layer"])
def test_a_pipeline_bound_breach_fails_the_phase(breach):
    stage = {"max_logit_err": 2 * chip_smoke.PARITY_TOL if breach == "logits" else 0.01,
             "finite": True, "loss": 6.0,
             "grad_rel_err": {"embed": 1.0 if breach == "grad" else 1e-3},
             "forward_ms": 1.0, "forward_calls": {}, "loss_grad_ms": 1.0, "calls": {},
             "host_copies": 0, "peak_gb": 0.0, "layers_with_grad": [breach != "layer"],
             "forward_launches": {}, "launches": {"flash_attention": 1, "rms_norm": 1,
                                                  "add_rms_norm": 1}}
    if breach == "none":
        assert chip_smoke._train_mesh_pp([stage, stage], {"losses": [6.0]})["loss_err"] == 0.0
        return
    with pytest.raises(SystemExit):
        chip_smoke._train_mesh_pp([stage, stage], {"losses": [6.0]})
