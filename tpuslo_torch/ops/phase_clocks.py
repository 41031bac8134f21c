"""Per-CTA phase clocks of the port's kernels on the card.

A probe for what a profiler cannot show inside a kernel (the card
machine has no ``ncu``).  It copies ``csrc/<name>.cu`` into
``build/tpuslo_torch/probes/`` (git-ignored), inserts ``clock64()``
reads at the phase boundaries of the kernel and a store of them by
thread 0 of every CTA into an extra buffer argument, builds the copy
with the same nvcc flags, routes the module's own wrapper through it,
and prints per phase the median and maximum cycles over the CTAs that
did work, with the heaviest CTA's phases and the kernel's span on the
global timer:

    python -m tpuslo_torch.ops.phase_clocks                  # every kernel
    python -m tpuslo_torch.ops.phase_clocks paged_attention attention_f32

K1 runs at the serve shapes and S 2048 (Llama-3.2-3B's attention
widths), K2 at a paged step of 8 lanes (lengths 49-729, one 64-position
pool block per span) with a cold and a warm L2, K1-f32 at the f32 path's
prefill (B2 S128 H2 KV1 D128) and at B1 S256 H24 KV8 in f32 at D 128 and
512 and in bf16 at D 512 (its phases summed over the tiles of the CTA's
first warp).  The insertion points
are text anchors in the committed sources; a probe whose anchor is gone
raises instead of measuring something else.  The clocks add a few
instructions per phase to each CTA.
"""

from __future__ import annotations

import ctypes
import importlib
import statistics
import subprocess
import sys

import torch

from tpuslo_torch.ops import _build

PROBES = _build.BUILD_ROOT / "probes"
RECORD = 16  # 64-bit words per CTA

# (anchor, replacement) per kernel, applied in order; each anchor must
# occur exactly once.  Thread 0 (of the consumer warpgroup in K1) stores
# [t_start, t_end, phase cycles..., whole CTA, work flag at slot 8] at its
# CTA's record; CTAs without work leave the flag 0.
_CLOCK = "long long {0} = clock64();\n"
_GTIME = ("unsigned long long {0}; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({0}));\n")


def _after(anchor: str, text: str) -> tuple[str, str]:
    return anchor, anchor + text


FLASH_EDITS = (
    ("                     float scale_log2, int causal) {\n",
     "                     float scale_log2, int causal, unsigned long long* probe) {\n"
     + _GTIME.format("pc_t0") + _CLOCK.format("pc0")
     + f"unsigned long long* pc_rec = probe + {RECORD}ull * "
     "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);\n"),
    _after("  __syncthreads();  // the barriers are initialised\n", _CLOCK.format("pc1")),
    _after("  wait_tile(full_k, 0);\n", _CLOCK.format("pc2")),
    _after("    pack_probs(s, pa);\n  }\n", _CLOCK.format("pc3")),
    _after("    hopper::bulk_wait_read();\n  }\n",
           _CLOCK.format("pc5") + _GTIME.format("pc_t1")
           + "if (tid == 0) { pc_rec[0] = pc_t0; pc_rec[1] = pc_t1;"
           " pc_rec[2] = pc1 - pc0; pc_rec[3] = pc2 - pc1; pc_rec[4] = pc3 - pc2;"
           " pc_rec[5] = pc5 - pc3; pc_rec[6] = pc5 - pc0; pc_rec[8] = 1; }\n"),
    ("    float scale, int causal, void* stream) {",
     "    float scale, int causal, void* stream, void* probe_buf) {"),
    ("      tm_q, tm_k, tm_v, tm_o, S, H / KV, scale_log2, causal);",
     "      tm_q, tm_k, tm_v, tm_o, S, H / KV, scale_log2, causal,"
     " static_cast<unsigned long long*>(probe_buf));"),
)
FLASH_PHASES = ("setup", "wait for Q and K0", "tiles 0..n-2 (scores, softmax, p.v)",
                "last p.v and epilogue", "whole CTA")

PAGED_EDITS = (
    ("  float* part;\n", "  float* part;\n  unsigned long long* probe;\n"),
    _after("  const int lane = tid % 32;\n\n",
           _GTIME.format("pc_t0") + _CLOCK.format("pc0")
           + f"unsigned long long* pc_rec = a.probe + {RECORD}ull * "
           "((split * gridDim.y + b) * gridDim.x + g);\n"),
    _after("  if (split >= live_spans(a, len)) return;\n", _CLOCK.format("pc1")),
    _after("    row_off[tid] = off;\n  }\n  __syncthreads();\n", _CLOCK.format("pc2")),
    _after("  hopper::cp_async_wait<1>();  // this thread's K copies have landed\n"
           "  __syncthreads();     // and everyone's\n", _CLOCK.format("pc4")),
    _after("  hopper::cp_async_wait<0>();  // V has landed\n  __syncthreads();\n",
           _CLOCK.format("pc6")),
    _after("    part_row(a, b, g, split, r, NREP, HD)[c] = x;\n  }\n",
           _CLOCK.format("pc7") + _GTIME.format("pc_t1")
           + "if (tid == 0) { pc_rec[0] = pc_t0; pc_rec[1] = pc_t1;"
           " pc_rec[2] = pc1 - pc0; pc_rec[3] = pc2 - pc1; pc_rec[4] = pc4 - pc2;"
           " pc_rec[5] = pc6 - pc4; pc_rec[6] = pc7 - pc6; pc_rec[7] = pc7 - pc0;"
           " pc_rec[8] = 1; }\n"),
    ("    long long o_sh, float scale, int out_f32, void* stream) {",
     "    long long o_sh, float scale, int out_f32, void* stream, void* probe_buf) {"),
    ("               static_cast<float*>(part), N, BS, MB,",
     "               static_cast<float*>(part),"
     " static_cast<unsigned long long*>(probe_buf), N, BS, MB,"),
)
PAGED_PHASES = ("length and table reads", "row offsets", "copy issue and wait for K",
                "scores, softmax, wait for V", "p.v and partial write", "whole CTA")

F32_EDITS = (
    ("  float scale_log2;  // D^-0.5 * log2(e)\n  int causal;\n};",
     "  float scale_log2;  // D^-0.5 * log2(e)\n  int causal;\n  unsigned long long* probe;\n};"),
    _after("  const int side = warp & 1, kg = (warp >> 1) & 1, rg = warp >> 2;\n",
           _GTIME.format("pc_t0") + _CLOCK.format("pc0")
           + "long long pc_wait = 0, pc_qk = 0, pc_sm = 0, pc_pv = 0; int pc_n = 0;\n"
           + f"unsigned long long* pc_rec = a.probe + {RECORD}ull * "
           "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);\n"),
    _after("  load_tile(0);\n  hopper::cp_async_commit();\n", _CLOCK.format("pc1")),
    _after("  for (int j = 0; j < n_tiles; ++j) {\n", _CLOCK.format("pc_a")),
    _after("    __syncthreads();             // and for every thread\n",
           _CLOCK.format("pc_b") + "pc_wait += pc_b - pc_a;\n"),
    _after("      tile_scores<T, D>(s, qw, kt, c0, lane);\n",
           _CLOCK.format("pc_c") + "pc_qk += pc_c - pc_b;\n"),
    ("      tile_pv<T, D>(o, s, vt, c0, lane);\n",
     _CLOCK.format("pc_d") + "pc_sm += pc_d - pc_c;\n"
     "      tile_pv<T, D>(o, s, vt, c0, lane);\n"
     "pc_pv += clock64() - pc_d; ++pc_n;\n"),
    _after("      store2(at + 8 * nn, x0 / denom, x1 / denom);\n    }\n  }\n",
           _CLOCK.format("pc9") + _GTIME.format("pc_t1")
           + "if (tid == 0) { pc_rec[0] = pc_t0; pc_rec[1] = pc_t1;"
           " pc_rec[2] = pc1 - pc0; pc_rec[3] = pc_wait; pc_rec[4] = pc_qk;"
           " pc_rec[5] = pc_sm; pc_rec[6] = pc_pv; pc_rec[7] = pc9 - pc0;"
           " pc_rec[8] = 1; pc_rec[9] = pc_n; }\n"),
    ("    long long o_sb, long long o_ss, long long o_sh, float scale, int causal, void* stream) {",
     "    long long o_sb, long long o_ss, long long o_sh, float scale, int causal, void* stream,"
     " void* probe_buf) {"),
    ("v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale * kLog2e, causal};",
     "v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale * kLog2e, causal,"
     " static_cast<unsigned long long*>(probe_buf)};"),
)
F32_PHASES = ("setup and copy issue", "tile issue and wait", "scores (q.k)",
              "pair exchange and softmax", "p.v", "whole CTA")
EDITS = {"flash_attention": FLASH_EDITS, "paged_attention": PAGED_EDITS,
         "attention_f32": F32_EDITS}


def build_probe(name: str) -> ctypes.CDLL:
    """The instrumented copy of ``csrc/<name>.cu``, built and loaded; its
    entry point takes one more argument, the record buffer."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for anchor, replacement in EDITS[name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in {name}.cu: {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    PROBES.mkdir(parents=True, exist_ok=True)
    cu = PROBES / f"{name}.cu"
    cu.write_text(src)
    lib = PROBES / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _route(module, lib, symbol: str, attr: str = "_kernel") -> list:
    """Send ``module``'s wrapper through the probe's entry point (the one
    its ``attr`` returns), which gets the record buffer whose pointer is
    in the returned holder."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(getattr(module, attr)().argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    holder = [None]
    setattr(module, attr, lambda: (lambda *args: fn(*args, holder[0])))
    return holder


def _report(what: str, records: torch.Tensor, phases) -> None:
    rows = [r for r in records.view(-1, RECORD).cpu().tolist() if r[8]]
    t0, t1 = min(r[0] for r in rows), max(r[1] for r in rows)
    heavy = max(rows, key=lambda r: r[2 + len(phases) - 1])
    cells = []
    for i, phase in enumerate(phases):
        vals = [r[2 + i] for r in rows]
        cells.append(f"{phase} {statistics.median(vals):.0f}/{max(vals)}")
    print(f"{what}: {len(rows)} CTAs with work, span {(t1 - t0) / 1e3:.2f} us; "
          f"cycles median/max: " + "; ".join(cells)
          + f"; heaviest CTA: {[heavy[2 + i] for i in range(len(phases))]}", flush=True)


def probe_flash(dev) -> None:
    fa = importlib.import_module("tpuslo_torch.ops.flash_attention")
    holder = _route(fa, build_probe("flash_attention"), "tpuslo_flash_attention_fwd_bf16")
    H, KV, D = 24, 8, 128
    for B, S in ((1, 128), (1, 256), (4, 128), (4, 256), (1, 2048)):
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
        k = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
        v = torch.randn(B, S, KV, D, device=dev, generator=g).bfloat16()
        records = torch.zeros(H * B * (S // 64) * RECORD, dtype=torch.int64, device=dev)
        holder[0] = records.data_ptr()
        for _ in range(3):
            fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        _report(f"K1 B{B} S{S} causal", records, FLASH_PHASES)


def probe_paged(dev) -> None:
    pa = importlib.import_module("tpuslo_torch.ops.paged_attention")
    holder = _route(pa, build_probe("paged_attention"), "tpuslo_paged_decode_attention")
    B, MB, N, BS, H, KV, HD = 8, 32, 129, 64, 24, 8, 128
    gen = torch.Generator().manual_seed(5)
    lens = torch.tensor([49, 120, 203, 260, 331, 409, 560, 729], dtype=torch.int32)
    table = torch.zeros(B, MB, dtype=torch.int32)
    nxt = 1
    for b in range(B):
        for j in range(int(lens[b]) // BS + 1):
            table[b, j] = nxt
            nxt += 1
    k = torch.randn(N, BS, KV, HD, generator=gen).bfloat16().to(dev)
    v = torch.randn(N, BS, KV, HD, generator=gen).bfloat16().to(dev)
    q = torch.randn(B, H, HD, generator=gen).bfloat16().to(dev)
    table, lens = table.to(dev), lens.to(dev)
    plan = pa.split_plan(B, KV, H // KV, HD, BS, MB)
    records = torch.zeros(KV * B * plan.n_split * RECORD, dtype=torch.int64, device=dev)
    holder[0] = records.data_ptr()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for cold in (True, False):
        for _ in range(3):
            if cold:
                flush.zero_()
            pa.paged_decode_attention(q, k, v, table, lens, block_size=BS)
        torch.cuda.synchronize()
        _report(f"K2 split, paged step, {'cold' if cold else 'warm'} L2", records,
                PAGED_PHASES)


def probe_f32(dev) -> None:
    fa = importlib.import_module("tpuslo_torch.ops.flash_attention")
    holder = _route(fa, build_probe("attention_f32"), "tpuslo_flash_attention_fwd_f32",
                    "_kernel_f32")
    for B, S, H, KV, D, dtype in ((2, 128, 2, 1, 128, torch.float32),
                                  (1, 256, 24, 8, 128, torch.float32),
                                  (1, 256, 24, 8, 512, torch.float32),
                                  (1, 256, 24, 8, 512, torch.bfloat16)):
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
        k = torch.randn(B, S, KV, D, device=dev, generator=g).to(dtype)
        v = torch.randn(B, S, KV, D, device=dev, generator=g).to(dtype)
        records = torch.zeros(H * B * (S // 16) * RECORD, dtype=torch.int64, device=dev)
        holder[0] = records.data_ptr()
        for _ in range(3):
            fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        heavy = max((r for r in records.view(-1, RECORD).cpu().tolist() if r[8]),
                    key=lambda r: r[7])
        _report(f"K1-f32 B{B} S{S} H{H} KV{KV} D{D} {str(dtype)[6:]} causal "
                f"(heaviest CTA: {heavy[9]} tiles)", records, F32_PHASES)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    probes = {"flash_attention": probe_flash, "paged_attention": probe_paged,
              "attention_f32": probe_f32}
    for name in argv or list(probes):
        probes[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
