"""Card-only tests of the port: the CUDA kernels and the engines on a GPU.

They import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_card.py

Without a CUDA device every test skips (the kernels have no CPU mode);
the decision is taken inside a fixture, never at import.
"""

from __future__ import annotations

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tpuslo_torch.models import frontdoor, kv_cache, llama, paged_kv, serve  # noqa: E402
from tpuslo_torch.models import speculative  # noqa: E402
from tpuslo_torch.ops import flash_attention, launch_counts  # noqa: E402
from tpuslo_torch.ops.flash_attention import flash_attention_reference  # noqa: E402
from tpuslo_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_decode_attention_split,
)

# bf16 output rounding and bf16 p in p.v (see the kernel's source note);
# the JAX package's own bf16 kernel test uses the same bound.
KERNEL_TOL = 3e-2
# The same roundings relative to each output row's RMS: ~2^-6 by a CPU
# model of the kernel's arithmetic; a dropped key tile is ~1 or more.
KERNEL_ROW_TOL = 2.0**-5
# Card vs CPU bf16 logits: other summation order and kernel vs plain
# attention; 4 bf16 ulps at |logit| in [4, 8).
LOGIT_TOL = 0.125
# K2 vs its plain version: the kernel keeps f32 up to its output, which
# it rounds once to bf16: half an ulp is at most 2^-8 of |o|, and |o| < 8
# (a convex combination of v rows), so 2^-6 at worst; 3.9e-3 by a CPU
# model of that rounding.  Row-scaled (each (b, h) row's max error over
# its RMS): the same rounding of a row's largest element, 0.0175 at
# worst in the CPU model.
PAGED_TOL = 2e-2
PAGED_ROW_TOL = 0.025


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _qkv(seed, B, S, H, KV, D, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device, torch.bfloat16
        )
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (1, 128, 24, 8, 128, True),
    (4, 128, 24, 8, 128, True),
    (4, 256, 24, 8, 128, True),
    (1, 256, 24, 8, 128, False),
    (2, 512, 4, 2, 128, True),
    (2, 512, 24, 8, 128, True),
    (1, 1024, 24, 8, 128, True),
    (2, 1024, 24, 8, 128, False),
    # The head-dim-256 instantiation (four 64-column boxes per tile, two
    # 128-column accumulator blocks), held to the same bounds: the
    # scores' scale keeps their spread the same.
    (1, 128, 2, 1, 256, True),
    (2, 256, 4, 2, 256, True),
    (1, 512, 8, 4, 256, False),
    (2, 1024, 4, 1, 256, True),
])
def test_kernel_matches_plain(cuda_device, B, S, H, KV, D, causal):
    q, k, v = _qkv(7, B, S, H, KV, D, cuda_device)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = flash_attention_reference(q.float(), k.float(), v.float(), causal)
    diff = (out.float() - ref).abs()
    assert diff.max().item() < KERNEL_TOL
    row_rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert (diff / row_rms).max().item() < KERNEL_ROW_TOL


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda_device):
    """q/k/v as views into wider buffers (strided heads), no copy."""
    q, k, v = _qkv(8, 1, 256, 8, 4, 128, cuda_device)
    wide = torch.zeros(1, 256, 16, 128, dtype=torch.bfloat16, device=cuda_device)
    wide[:, :, ::2] = q
    out = flash_attention(wide[:, :, ::2], k, v)
    ref = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_tensor_never_falls_back(cuda_device):
    """What no kernel takes raises on the card; it is never served by the
    plain version.  (f32 and head dims 384 and 512 now have K1-f32.)"""
    q, k, v = _qkv(9, 1, 128, 4, 2, 128, cuda_device)
    before = (flash_attention.launches, flash_attention.f32_launches)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q[:, :100], k[:, :100], v[:, :100])
    wide = torch.zeros(1, 128, 2, 640, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 640"):
        flash_attention(wide, wide[:, :, :1], wide[:, :, :1])
    assert (flash_attention.launches, flash_attention.f32_launches) == before


# K1-f32 and K2-f32 against their plain versions: both sides compute in
# f32 (FFMA on the card, no TF32) and differ only in the order of the
# sums.  A bf16 or f16 output adds its own rounding: half an ulp, at
# most 2^-8 (bf16) or 2^-11 (f16) of |o|, allowed on top.
F32_TOL = 1e-4
OUT_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}


def _hold_f32(out, ref):
    assert out.shape == ref.shape and torch.isfinite(out).all()
    bound = F32_TOL + OUT_ULP[out.dtype] * ref.abs()
    excess = ((out.float() - ref).abs() - bound).max().item()
    assert excess <= 0.0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,dtype", [
    (2, 128, 2, 1, 128, True, torch.float32),  # the JAX f32 model test's attention
    (1, 256, 24, 8, 128, True, torch.float32),  # llama32_3b's widths in f32
    (2, 256, 24, 8, 128, False, torch.float32),
    (2, 256, 4, 2, 256, True, torch.float32),
    (1, 256, 4, 2, 384, True, torch.float32),
    (1, 256, 4, 1, 512, True, torch.float32),
    (1, 384, 8, 2, 512, False, torch.float32),
    (1, 256, 4, 2, 384, True, torch.bfloat16),  # no wgmma instantiation at 384/512
    (2, 128, 4, 4, 512, False, torch.bfloat16),
    (1, 128, 4, 2, 128, True, torch.float16),  # the wgmma kernel is bf16 only
    # Shapes that choose each row count per CTA, in every input type: 32
    # rows (RG 2, where every SM still gets a CTA; f32 D512 with its
    # 16-key tiles) and 16 rows (RG 1: B1 S128 H1 gives too few CTAs).
    (4, 512, 32, 8, 128, True, torch.float32),
    (2, 256, 16, 4, 512, True, torch.float32),
    (1, 128, 1, 1, 256, False, torch.float16),
    (4, 256, 8, 2, 384, True, torch.float16),
    (2, 512, 16, 16, 512, True, torch.bfloat16),
])
def test_f32_kernel_matches_plain(cuda_device, B, S, H, KV, D, causal, dtype):
    q, k, v = (t.to(dtype) for t in _qkv(17, B, S, H, KV, D, cuda_device))
    before = (flash_attention.launches, flash_attention.f32_launches)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.f32_launches) == (
        before[0], before[1] + 1)
    assert out.dtype == dtype
    _hold_f32(out, flash_attention_reference(q.float(), k.float(), v.float(), causal))


@pytest.mark.cuda
def test_f32_kernel_reads_mixed_dtypes_and_strided_heads(cuda_device):
    """An f32 q over bf16 k/v is read as f32 (exact) and written in q's
    dtype, as the Pallas kernel casts; a strided q is read in place."""
    q, k, v = _qkv(18, 1, 256, 8, 4, 128, cuda_device)
    qf = q.float()
    out = flash_attention(qf, k, v)
    assert out.dtype == torch.float32
    _hold_f32(out, flash_attention_reference(qf, k.float(), v.float(), True))
    wide = torch.zeros(1, 256, 16, 128, device=cuda_device)
    wide[:, :, ::2] = qf
    kf, vf = k.float(), v.float()
    strided = flash_attention(wide[:, :, ::2], kf, vf)
    torch.cuda.synchronize()
    assert torch.equal(strided, flash_attention(qf, kf, vf))


@pytest.mark.cuda
def test_f32_model_on_card_matches_cpu(cuda_device):
    """The JAX package's f32 head-dim-128 model
    (``tests/test_flash_attention.py::TestModelIntegration``) on the card,
    its prefill through K1-f32, against the same weights on the CPU."""
    cfg = llama.LlamaConfig(
        vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        ffn_dim=512, max_seq_len=128, dtype=torch.float32,
    )
    cpu_params = llama.init_params(0, cfg, "cpu")
    card_params = {
        "embed": cpu_params["embed"].to(cuda_device),
        "layers": {n: t.to(cuda_device) for n, t in cpu_params["layers"].items()},
        "final_norm": cpu_params["final_norm"].to(cuda_device),
        "output": cpu_params["output"].to(cuda_device),
    }
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 128)))
    before = flash_attention.f32_launches
    card, _ = llama.prefill(card_params, tokens.to(cuda_device),
                            llama.init_kv_cache(cfg, 2, device=cuda_device), cfg)
    torch.cuda.synchronize()
    assert flash_attention.f32_launches - before == cfg.n_layers
    cpu, _ = llama.prefill(cpu_params, tokens, llama.init_kv_cache(cfg, 2, device="cpu"), cfg)
    assert (card.cpu() - cpu).abs().max().item() < F32_TOL


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """A small head-dim-128 bf16 engine on the card (prefill through the
    kernel) against the same weights on the CPU (plain path), in logit
    space with the tie rule of ``stream_parity``."""
    cfg = llama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        ffn_dim=512, max_seq_len=512,
    )
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    cpu_params = llama.init_params(0, cfg, "cpu")
    card_params = {
        "embed": cpu_params["embed"].to(cuda_device),
        "layers": {n: t.to(cuda_device) for n, t in cpu_params["layers"].items()},
        "final_norm": cpu_params["final_norm"].to(cuda_device),
        "output": cpu_params["output"].to(cuda_device),
    }
    card = serve.ServeEngine(cfg, card_params, decode_chunk_size=4, device=cuda_device)
    cpu = serve.ServeEngine(cfg, cpu_params, decode_chunk_size=4, device="cpu")
    before = flash_attention.launches
    report = serve.stream_parity(
        card, cpu, "The card serves this prompt. " * 5, max_new_tokens=8,
        atol=LOGIT_TOL,
    )
    assert report["ok"], report
    assert flash_attention.launches - before >= cfg.n_layers


def _paged_inputs(seed, B, MB, N, H, KV, HD, BS, quantized, device):
    """Random q and pools with random tables and lengths, like the JAX
    lowering tests; the last lane is parked (zeroed table, length 100)
    and lane 1 shares lane 0's first two blocks."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, HD, generator=g).bfloat16()
    k = torch.randn(N, BS, KV, HD, generator=g).bfloat16()
    v = torch.randn(N, BS, KV, HD, generator=g).bfloat16()
    if quantized:
        k, v = kv_cache.quantize_kv(k.float()), kv_cache.quantize_kv(v.float())
    table = torch.randint(1, N, (B, MB), generator=g, dtype=torch.int32)
    lengths = torch.randint(1, MB * BS, (B,), generator=g, dtype=torch.int32)
    table[-1] = 0
    lengths[-1] = 100
    table[1, :2] = table[0, :2]
    return tuple(kv_cache.kv_map(lambda t: t.to(device), x) for x in (q, k, v, table, lengths))


PAGED_SHAPES = {
    "B8-bf16": (8, 4, 40, 24, 8, 128, 64, False),
    "B8-int8": (8, 4, 40, 24, 8, 128, 64, True),
    "B32-bf16": (32, 8, 300, 24, 8, 128, 64, False),
    "B32-int8": (32, 8, 300, 24, 8, 128, 64, True),
    "HD64-BS16": (6, 6, 30, 8, 2, 64, 16, False),
    # Every group size the kernel is built for, and both head dims.
    "nrep1": (4, 6, 30, 8, 8, 128, 64, False),
    "nrep2-int8": (4, 6, 30, 16, 8, 128, 64, True),
    "nrep4": (4, 6, 30, 32, 8, 128, 64, False),
    "nrep8-int8": (4, 6, 30, 64, 8, 128, 64, True),
    "HD64-nrep3": (4, 6, 30, 24, 8, 64, 64, False),
    "HD64-nrep2-int8": (4, 6, 30, 16, 8, 64, 64, True),
    # Spans that cut a block into chunks (BS > 64) or hold several.
    "BS128-chunks": (4, 3, 14, 24, 8, 128, 128, False),
    "BS100-HD64": (3, 3, 12, 8, 2, 64, 100, False),
    "BS8-HD64-int8": (5, 20, 120, 8, 2, 64, 8, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
def test_paged_kernel_matches_plain(cuda_device, shape):
    B, MB, N, H, KV, HD, BS, quantized = PAGED_SHAPES[shape]
    q, k, v, table, lengths = _paged_inputs(1, B, MB, N, H, KV, HD, BS, quantized, cuda_device)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, table, lengths, block_size=BS)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = paged_decode_attention_reference(
        q, k, v, table, lengths, block_size=BS, out_dtype=torch.float32
    )
    diff = (out.float() - ref).abs()
    assert torch.isfinite(out).all()
    assert diff.max().item() < PAGED_TOL
    row_rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    assert (diff / row_rms).max().item() < PAGED_ROW_TOL


def _hold_to_plain(q, k, v, table, lengths, block_size, plain=paged_decode_attention_reference):
    out = paged_decode_attention(q, k, v, table, lengths, block_size=block_size)
    torch.cuda.synchronize()
    ref = plain(q, k, v, table, lengths, block_size=block_size, out_dtype=torch.float32)
    diff = (out.float() - ref).abs()
    assert torch.isfinite(out).all()
    assert diff.max().item() < PAGED_TOL
    row_rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt().clamp_min(1e-30)
    rows = ref.abs().amax(dim=-1, keepdim=True) > 0
    assert ((diff / row_rms) * rows).max().item() < PAGED_ROW_TOL
    return out


@pytest.mark.cuda
def test_paged_kernel_one_lane_all_blocks_visible(cuda_device):
    """B 1 with all 32 blocks of the table visible: 32 spans run and are
    merged."""
    q, k, v, table, lengths = _paged_inputs(4, 2, 32, 40, 24, 8, 128, 64, False, cuda_device)
    q, table, lengths = q[:1], table[:1].clone(), lengths[:1].clone()
    table[0] = torch.arange(1, 33, dtype=torch.int32, device=cuda_device)
    for length in (32 * 64 - 1, 32 * 64 + 500):
        lengths.fill_(length)
        _hold_to_plain(q, k, v, table, lengths, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [64, 16, 128])
def test_paged_kernel_span_boundaries(cuda_device, bs):
    """Lengths that end a span exactly and that put one position into
    the next span."""
    q, k, v, table, lengths = _paged_inputs(5, 6, 8, 60, 24, 8, 128, bs, False, cuda_device)
    values = [63, 64, 127, 128, 4 * bs - 1, 4 * bs]
    lengths.copy_(torch.tensor(values, dtype=torch.int32))
    _hold_to_plain(q, k, v, table, lengths, bs)


@pytest.mark.cuda
def test_paged_kernel_out_of_pool_entries(cuda_device):
    """Table entries outside [0, N) are skipped: a middle block's entry
    leaves its span empty (max -inf, sum 0), a lane with every entry out
    of range returns zeros; held to the plain model of the split."""
    q, k, v, table, lengths = _paged_inputs(6, 4, 4, 30, 24, 8, 128, 64, False, cuda_device)
    lengths.copy_(torch.tensor([200, 150, 255, 40], dtype=torch.int32))
    table[0, 1] = 30
    table[1, 2] = -1
    table[2] = torch.tensor([31, 32, -5, 1 << 20], dtype=torch.int32)
    out = _hold_to_plain(q, k, v, table, lengths, 64, plain=paged_decode_attention_split)
    assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_kernel_replays_in_a_cuda_graph(cuda_device, quantized):
    """One call captured in a CUDA graph, replayed after the lengths and
    the page table change in place: the grid and the scratch depend on
    shapes only, and the kernel reads the new values on the device."""
    q, k, v, table, lengths = _paged_inputs(7, 8, 6, 60, 24, 8, 128, 64, quantized, cuda_device)
    paged_decode_attention(q, k, v, table, lengths, block_size=64)  # build, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention(q, k, v, table, lengths, block_size=64)
    g = torch.Generator().manual_seed(70)
    for _ in range(3):
        lengths.copy_(torch.randint(0, 6 * 64 + 50, (8,), generator=g, dtype=torch.int32))
        table.copy_(torch.randint(0, 60, (8, 6), generator=g, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_decode_attention_reference(
            q, k, v, table, lengths, block_size=64, out_dtype=torch.float32
        )
        diff = (out.float() - ref).abs()
        assert torch.isfinite(out).all() and diff.max().item() < PAGED_TOL
        row_rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
        assert (diff / row_rms).max().item() < PAGED_ROW_TOL


@pytest.mark.cuda
def test_paged_kernel_skips_blocks_past_length(cuda_device):
    """Poisoning every block but lane 0's first leaves lane 0's output
    bit for bit as it was."""
    q, k, v, table, lengths = _paged_inputs(2, 4, 4, 20, 24, 8, 128, 64, False, cuda_device)
    lengths[0] = 30
    clean = paged_decode_attention(q, k, v, table, lengths, block_size=64)
    poison = torch.full_like(k, 1e4)
    owned = int(table[0, 0])
    poison[owned] = k[owned]
    dirty = paged_decode_attention(q, poison, v, table, lengths, block_size=64)
    torch.cuda.synchronize()
    assert torch.equal(clean[0], dirty[0])


@pytest.mark.cuda
def test_paged_kernel_never_falls_back(cuda_device):
    """What neither kernel is built for raises on the card, naming it; it
    is never served by the plain version.  (A bf16 q over f32 pools now
    has K2-f32, which reads both as f32.)"""
    q, k, v, table, lengths = _paged_inputs(3, 2, 2, 6, 8, 2, 128, 16, False, cuda_device)
    before = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
    with pytest.raises(ValueError, match="float64 pool"):
        paged_decode_attention(q, k.double(), v.double(), table, lengths, block_size=16)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, k, v, table.long(), lengths, block_size=16)
    q96 = torch.zeros(2, 8, 96, dtype=torch.bfloat16, device=cuda_device)
    k96 = torch.zeros(6, 16, 2, 96, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        paged_decode_attention(q96, k96, k96, table, lengths, block_size=16)
    q5 = torch.zeros(2, 10, 128, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="query heads per kv head"):
        paged_decode_attention(q5, k, v, table, lengths, block_size=16)
    assert (paged_decode_attention.launches, paged_decode_attention.f32_launches) == before
    out = paged_decode_attention(q, k.float(), v.float(), table, lengths, block_size=16)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches, paged_decode_attention.f32_launches) == (
        before[0], before[1] + 1)
    _hold_f32(out, paged_decode_attention_reference(q, k.float(), v.float(), table, lengths,
                                                    block_size=16, out_dtype=torch.float32))


F32_PAGED_SHAPES = {
    "B8": (8, 4, 40, 24, 8, 128, 64),
    "B32": (32, 8, 300, 24, 8, 128, 64),
    "HD64-BS16": (6, 6, 30, 8, 2, 64, 16),
    "nrep1": (4, 6, 30, 8, 8, 128, 64),
    "nrep2-HD64": (4, 6, 30, 16, 8, 64, 64),
    "nrep4": (4, 6, 30, 32, 8, 128, 64),
    "nrep8": (4, 6, 30, 64, 8, 128, 64),
    "BS128": (4, 3, 14, 24, 8, 128, 128),
    "BS8-HD64": (5, 20, 120, 8, 2, 64, 8),
    "nrep2-HD128-BS16": (3, 8, 30, 2, 1, 128, 16),  # the f32 model's paged engine
    "HD24-nrep2": (4, 4, 20, 8, 4, 24, 64),  # the serving bench's measured target (F11)
}


def _f32_paged(seed, B, MB, N, H, KV, HD, BS, device):
    q, k, v, table, lengths = _paged_inputs(seed, B, MB, N, H, KV, HD, BS, False, device)
    return q.float(), k.float(), v.float(), table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F32_PAGED_SHAPES))
def test_paged_f32_kernel_matches_plain(cuda_device, shape):
    q, k, v, table, lengths = _f32_paged(11, *F32_PAGED_SHAPES[shape], cuda_device)
    BS = F32_PAGED_SHAPES[shape][-1]
    before = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
    out = paged_decode_attention(q, k, v, table, lengths, block_size=BS)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches, paged_decode_attention.f32_launches) == (
        before[0], before[1] + 1)
    assert out.dtype == torch.float32
    _hold_f32(out, paged_decode_attention_reference(q, k, v, table, lengths, block_size=BS))
    half = paged_decode_attention(q, k, v, table, lengths, block_size=BS,
                                  out_dtype=torch.bfloat16)
    _hold_f32(half, paged_decode_attention_reference(q, k, v, table, lengths, block_size=BS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_f32_kernel_at_head_dim_24_is_batch_invariant(cuda_device, dtype):
    """Head dim 24 (6 column groups of 4: 126 of the 128 threads run the
    p.v stage): each lane of a batch of 8 has the bits it has alone."""
    q, k, v, table, lengths = _f32_paged(13, 8, 4, 40, 8, 4, 24, 64, cuda_device)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    batch = paged_decode_attention(q, k, v, table, lengths, block_size=64)
    for b in range(8):
        alone = paged_decode_attention(q[b:b + 1].contiguous(), k, v,
                                       table[b:b + 1].contiguous(),
                                       lengths[b:b + 1].contiguous(), block_size=64)
        assert torch.equal(alone, batch[b:b + 1]), b
    _hold_f32(batch, paged_decode_attention_reference(q, k, v, table, lengths, block_size=64))


@pytest.mark.cuda
def test_paged_f32_kernel_edges_and_graph_replay(cuda_device):
    """Lengths past the table, zero and span-sized; out-of-pool entries
    (held to the plain model of the split, which skips them); then one
    call captured in a CUDA graph and replayed after the lengths and the
    table change in place."""
    q, k, v, table, lengths = _f32_paged(12, 6, 4, 30, 24, 8, 128, 64, cuda_device)
    lengths.copy_(torch.tensor([0, 31, 32, 255, 256, 900], dtype=torch.int32))
    _hold_f32(paged_decode_attention(q, k, v, table, lengths, block_size=64),
              paged_decode_attention_reference(q, k, v, table, lengths, block_size=64))
    table[0, 0] = 30
    table[3, 2] = -1
    out = paged_decode_attention(q, k, v, table, lengths, block_size=64)
    _hold_f32(out, paged_decode_attention_split(q, k, v, table, lengths, block_size=64))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention(q, k, v, table, lengths, block_size=64)
    g = torch.Generator().manual_seed(13)
    for _ in range(3):
        lengths.copy_(torch.randint(0, 4 * 64 + 50, (6,), generator=g, dtype=torch.int32))
        table.copy_(torch.randint(0, 30, (6, 4), generator=g, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _hold_f32(out, paged_decode_attention_reference(q, k, v, table, lengths,
                                                        block_size=64))


# K2-f32 on every input the Pallas kernel takes that K2 is not built for:
# (B, MB, N, H, KV, HD, BS, q dtype, pool dtype, output dtype).
F6_PAGED_SHAPES = {
    "llama_tiny-bf16": (3, 8, 30, 4, 2, 16, 16, "bf16", "bf16", "bf16"),
    "llama_tiny-f32": (3, 8, 30, 4, 2, 16, 16, "f32", "f32", "f32"),
    "hd16-f32-int8": (4, 8, 30, 4, 2, 16, 16, "f32", "int8", "f32"),
    "hd128-f32-int8": (3, 8, 30, 2, 1, 128, 16, "f32", "int8", "f32"),
    "hd128-f32-int8-nrep3": (8, 4, 40, 24, 8, 128, 64, "f32", "int8", "f32"),
    "hd32-f16": (4, 6, 30, 16, 8, 32, 32, "f16", "f16", "f16"),
    "hd64-f16-bf16-out": (4, 6, 30, 8, 2, 64, 64, "f16", "f16", "bf16"),
    "hd256-bf16": (4, 4, 20, 8, 2, 256, 64, "bf16", "bf16", "bf16"),
    "hd256-f32": (2, 4, 20, 8, 1, 256, 64, "f32", "f32", "f32"),
    "hd128-bf16-f16-out": (4, 6, 30, 24, 8, 128, 64, "bf16", "bf16", "f16"),
    "hd64-bf16-q-f32-pool": (4, 6, 30, 24, 8, 64, 64, "bf16", "f32", "bf16"),
    "hd128-f16-q-int8": (4, 6, 30, 32, 4, 128, 128, "f16", "int8", "f16"),
    "hd16-nrep1-bs8": (5, 20, 120, 4, 4, 16, 8, "bf16", "bf16", "f32"),
    "hd32-nrep8-bs100": (3, 3, 12, 16, 2, 32, 100, "f32", "bf16", "f32"),
}
_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _f6_paged(seed, B, MB, N, H, KV, HD, BS, q_dt, pool_dt, device):
    q, k, v, table, lengths = _paged_inputs(seed, B, MB, N, H, KV, HD, BS, False, device)
    if pool_dt == "int8":
        k, v = kv_cache.quantize_kv(k.float()), kv_cache.quantize_kv(v.float())
    else:
        k, v = k.to(_DT[pool_dt]), v.to(_DT[pool_dt])
    return q.to(_DT[q_dt]), k, v, table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(F6_PAGED_SHAPES))
def test_paged_f32_kernel_takes_every_pallas_input(cuda_device, shape):
    """Every q / pool / output type pairing, head dims 16-256 and group
    sizes 1-8 that K2 does not take launch K2-f32 once and hold the plain
    version within 1e-4 (plus half an output ulp)."""
    *geometry, q_dt, pool_dt, out_dt = F6_PAGED_SHAPES[shape]
    B, MB, N, H, KV, HD, BS = geometry
    q, k, v, table, lengths = _f6_paged(14, *geometry, q_dt, pool_dt, cuda_device)
    before = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
    out = paged_decode_attention(q, k, v, table, lengths, block_size=BS, out_dtype=_DT[out_dt])
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches, paged_decode_attention.f32_launches) == (
        before[0], before[1] + 1)
    assert out.dtype == _DT[out_dt] and out.shape == (B, H, HD)
    _hold_f32(out, paged_decode_attention_reference(q, k, v, table, lengths, block_size=BS,
                                                    out_dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["llama_tiny-bf16", "hd128-f32-int8"])
def test_paged_f32_kernel_f6_inputs_replay_in_a_cuda_graph(cuda_device, shape):
    """K2-f32 at llama_tiny's head dim 16 in bf16 and over int8 pools,
    captured in a CUDA graph and replayed after the lengths and the table
    change in place."""
    *geometry, q_dt, pool_dt, _ = F6_PAGED_SHAPES[shape]
    B, MB, N, H, KV, HD, BS = geometry
    q, k, v, table, lengths = _f6_paged(15, *geometry, q_dt, pool_dt, cuda_device)
    paged_decode_attention(q, k, v, table, lengths, block_size=BS)  # build, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention(q, k, v, table, lengths, block_size=BS)
    g = torch.Generator().manual_seed(16)
    for _ in range(3):
        lengths.copy_(torch.randint(0, MB * BS + 20, (B,), generator=g, dtype=torch.int32))
        table.copy_(torch.randint(0, N, (B, MB), generator=g, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _hold_f32(out, paged_decode_attention_reference(q, k, v, table, lengths,
                                                        block_size=BS, out_dtype=torch.float32))


def _tiny_paged_engines(cfg, cuda_device, kv_dtype="bf16"):
    """The same weights as a card and a CPU ``PagedBatchingEngine`` with
    the K2 switch on, each run over one submit script; returns the
    streams, the card's steps and its K2 / K2-f32 launches."""
    cpu_params = llama.init_params(0, cfg, "cpu")
    card_params = {
        "embed": cpu_params["embed"].to(cuda_device),
        "layers": {n: t.to(cuda_device) for n, t in cpu_params["layers"].items()},
        "final_norm": cpu_params["final_norm"].to(cuda_device),
        "output": cpu_params["output"].to(cuda_device),
    }
    prompts = ["pallas paged", "a second longer request prompt", "third"]
    results, steps, launches = {}, {}, None
    for where, params in (("card", card_params), ("cpu", cpu_params)):
        engine = paged_kv.PagedBatchingEngine(
            cfg, params, max_slots=3, block_size=16, pallas_attention=True, kv_dtype=kv_dtype,
            device=cuda_device if where == "card" else "cpu",
        )
        before = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
        ids = [engine.submit(p, max_new_tokens=8, stop_at_eos=False) for p in prompts]
        engine.run()
        after = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
        if where == "card":
            launches = (after[0] - before[0], after[1] - before[1])
        else:
            assert after == before
        results[where] = [engine.results[i] for i in ids]
        steps[where] = engine.steps
    return prompts, results, steps["card"], launches, cpu_params


def _hold_streams(cfg, cpu_params, prompts, results, tol, kv_dtype="bf16"):
    """Card streams equal the CPU engine's, or leave them only where the
    CPU single-request engine's top-2 margin is under ``2 * tol``."""
    single = serve.ServeEngine(cfg, cpu_params, kv_dtype=kv_dtype, device="cpu")
    for prompt, got, want in zip(prompts, results["card"], results["cpu"]):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                ids = serve.encode_bytes(prompt, cfg.max_seq_len - 2) + want[:i]
                logits, _ = single.ingest_ids(ids)
                top2 = torch.topk(logits[0].float(), 2).values
                assert float(top2[0] - top2[1]) < 2 * tol, (prompt, i, want, got)
                break


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, LOGIT_TOL), (torch.float32, F32_TOL)],
                         ids=["bf16", "f32"])
def test_llama_tiny_paged_engine_with_the_switch_on(cuda_device, dtype, tol):
    """The JAX package's own Pallas engine test
    (``tests/test_paged_attention_kernel.py::test_engine_pallas_path_token_parity``)
    on the card: ``llama_tiny`` (head dim 16) with ``pallas_attention=True``
    takes K2-f32 once per layer per step, and its streams equal the CPU
    engine's by the near-tie rule."""
    cfg = dataclasses.replace(llama.llama_tiny(max_seq_len=128), dtype=dtype)
    prompts, results, steps, launches, cpu_params = _tiny_paged_engines(cfg, cuda_device)
    assert launches == (0, steps * cfg.n_layers)
    _hold_streams(cfg, cpu_params, prompts, results, tol)


@pytest.mark.cuda
def test_f32_hd128_paged_engine_over_int8_pools(cuda_device):
    """The JAX f32 head-dim-128 model's widths with ``kv_dtype="int8"``
    and the switch on: an f32 q over int8 pools takes K2-f32, once per
    layer per step, and the streams equal the CPU engine's by the
    near-tie rule."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                            ffn_dim=512, max_seq_len=128, dtype=torch.float32)
    prompts, results, steps, launches, cpu_params = _tiny_paged_engines(
        cfg, cuda_device, kv_dtype="int8")
    assert launches == (0, steps * cfg.n_layers)
    _hold_streams(cfg, cpu_params, prompts, results, F32_TOL, kv_dtype="int8")


@pytest.mark.cuda
def test_paged_engine_on_card_matches_cpu(cuda_device):
    """A small head-dim-128 bf16 paged engine with K2 switched on (the
    kernel on the card, its plain version on the CPU), same weights, a
    shared prefix and a plain request in flight; streams are held by
    the tie rule against the CPU single-request engine's margins."""
    cfg = llama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        ffn_dim=512, max_seq_len=512,
    )
    cpu_params = llama.init_params(0, cfg, "cpu")
    card_params = {
        "embed": cpu_params["embed"].to(cuda_device),
        "layers": {n: t.to(cuda_device) for n, t in cpu_params["layers"].items()},
        "final_norm": cpu_params["final_norm"].to(cuda_device),
        "output": cpu_params["output"].to(cuda_device),
    }
    prefix = "The card serves this shared system prompt. " * 2
    jobs = [("first suffix", prefix), ("second suffix", prefix), ("no prefix at all", None)]
    results = {}
    for where, params in (("card", card_params), ("cpu", cpu_params)):
        engine = paged_kv.PagedBatchingEngine(
            cfg, params, max_slots=3, block_size=16, pallas_attention=True,
            device=cuda_device if where == "card" else "cpu",
        )
        before, lanes = paged_decode_attention.launches, launch_counts.cached_layers
        ids = [engine.submit(p, max_new_tokens=8, stop_at_eos=False, prefix=pre)
               for p, pre in jobs]
        engine.run()
        launches = paged_decode_attention.launches - before
        # The paged steps, plus the prefix suffixes' verify passes over the
        # dense caches (K2's lanes, once per layer).
        lanes = launch_counts.cached_layers - lanes
        assert launches == (engine.steps * cfg.n_layers + lanes if where == "card" else 0)
        assert engine.prefix_reuse_hits >= 1
        results[where] = [engine.results[i] for i in ids]
    single = serve.ServeEngine(cfg, cpu_params, device="cpu")
    for (prompt, pre), got, want in zip(jobs, results["card"], results["cpu"]):
        assert len(got) == len(want)
        if pre:
            p_ids, s_ids = serve.prefix_prompt_ids(pre, prompt, cfg.max_seq_len)
            ids = p_ids + s_ids
        else:
            ids = serve.encode_bytes(prompt, cfg.max_seq_len - 2)
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                logits, _ = single.ingest_ids(ids + want[:i])
                top2 = torch.topk(logits[0].float(), 2).values
                assert float(top2[0] - top2[1]) < 2 * LOGIT_TOL, (prompt, i, want, got)
                break


# ---- speculative rounds and the front door on the card -------------------


def _spec_pair(device, max_seq_len=256):
    """A small bf16 target (2 layers, head dim 128, so that its prefills
    take kernel K1) and a 1-layer draft of its own widths, on ``device``."""
    cfg_t = llama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        ffn_dim=512, max_seq_len=max_seq_len,
    )
    cfg_d = dataclasses.replace(cfg_t, n_layers=1)
    target = serve.ServeEngine(cfg_t, rng_seed=0, device=device)
    draft = serve.ServeEngine(cfg_d, rng_seed=1, device=device)
    return target, draft


def _round_state(target, draft, rows):
    logits, cache_t = target._prefill_rows(rows, 0)
    _, cache_d = draft._prefill_rows(rows, 0)
    return logits.argmax(dim=-1), cache_t, cache_d


@pytest.mark.cuda
def test_spec_rounds_make_no_host_sync(cuda_device):
    """A batched round, a 2-round chain and a single-stream round (0-d
    frontier) queue with no synchronizing call: PyTorch's sync debug mode
    raises on one.  The uploads of the frontiers and the mask and the
    packed read's copy are inside the guarded region too."""
    target, draft = _spec_pair(cuda_device)
    k = 3
    rows = [[serve.BOS, 5, 6, 7, 8], [serve.BOS, 9, 10], [serve.BOS, 3, 4, 5], [serve.BOS, 2]]
    cur, cache_t, cache_d = _round_state(target, draft, rows)
    batch = speculative._shared_spec_round_batch_fn(target.cfg, draft.cfg, k)
    multi = speculative._shared_spec_multi_round_fn(target.cfg, draft.cfg, k, 2)
    single = speculative._shared_spec_round_fn(target.cfg, draft.cfg, k)
    cur1, ct1, cd1 = _round_state(target, draft, rows[:1])
    frontier = torch.tensor(len(rows[0]), dtype=torch.long, device=cuda_device)
    ct1, cd1 = {**ct1, "length": frontier}, {**cd1, "length": frontier}
    lens = [len(r) for r in rows]
    mask = [True, True, False, True]

    def run_all(cur, cache_t, cache_d, cur1, ct1, cd1):
        start = serve._upload(lens, torch.long, cuda_device)
        active = serve._upload(mask, torch.bool, cuda_device)
        d, p, a, cur, cache_t, cache_d = batch(
            target.params, draft.params, cur, cache_t, cache_d, start, active)
        read = serve._HostRead(speculative.pack_round(d, p, a))
        d, p, a, cur, cache_t, cache_d = multi(
            target.params, draft.params, cur, cache_t, cache_d, cache_t["length"], active)
        d1, p1, a1, cur1, ct1, cd1 = single(target.params, draft.params, cur1, ct1, cd1)
        assert ct1["length"].ndim == 0 and ct1["length"].is_cuda
        return read, cache_t["length"]

    run_all(cur, cache_t, cache_d, cur1, ct1, cd1)  # first calls set up library state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        read, lengths = run_all(cur, cache_t, cache_d, cur1, ct1, cd1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    values = read.values()
    assert len(values) == 4 and len(values[0]) == 2 * k + 2
    assert int(lengths[2]) == lens[2]  # the frozen row did not advance


@pytest.mark.cuda
def test_parked_rows_survive_four_rounds_on_the_card(cuda_device):
    """A dense park is a copy: four further rounds that write the pool in
    place leave it unchanged, and the resumed stream equals the
    uninterrupted one."""
    target, draft = _spec_pair(cuda_device)

    class Burn:
        def admission_priority(self, tenant):
            return 10 if tenant == "lowly" else 100

        def tenant_burn_state(self, tenant):
            return "ok"

        def record(self, outcome):
            pass

    want = speculative.SpeculativeEngine(target, draft, k=3).generate(
        "to be parked", max_new_tokens=30, stop_at_eos=False)
    for paged in (False, True):
        fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=1, burn_engine=Burn(),
                                       paged=paged, block_size=32)
        low = fd.submit("to be parked", tenant="lowly", max_new_tokens=30, stop_at_eos=False)
        fd.step()
        fd.submit("takes the slot", tenant="vip", max_new_tokens=40, stop_at_eos=False)
        fd._fill_slots()
        (parked_req,) = fd._queue
        if paged:
            phys = list(parked_req.parked.phys)
            before = [fd._paged_pool_t["k"][:, phys].clone(), fd._paged_pool_d["v"][:, phys].clone()]
        else:
            row_t, row_d, _, _ = parked_req.parked
            before = [row_t["k"].clone(), row_d["v"].clone()]
        for _ in range(2):  # 2 steps of 2 rounds
            fd.step()
        assert fd._queue == [parked_req]
        if paged:
            after = [fd._paged_pool_t["k"][:, phys], fd._paged_pool_d["v"][:, phys]]
        else:
            after = [row_t["k"], row_d["v"]]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert fd.run()[low] == want
        assert fd.resumes == 1 and fd.paged_resumes == int(paged)


@pytest.mark.cuda
def test_batched_round_replays_in_a_cuda_graph(cuda_device):
    """One batched round captured in a CUDA graph and replayed with new
    ``current``, ``start`` and ``active`` gives what the eager round
    gives on the same caches: the round holds no host read and no
    data-dependent shape."""
    target, draft = _spec_pair(cuda_device)
    k = 3
    rows = [[serve.BOS, 5, 6, 7, 8], [serve.BOS, 9, 10], [serve.BOS, 3, 4, 5], [serve.BOS, 2]]
    cur, cache_t, cache_d = _round_state(target, draft, rows)
    fn = speculative._shared_spec_round_batch_fn(target.cfg, draft.cfg, k)
    s_cur = cur.clone()
    s_start = cache_t["length"].clone()
    s_active = torch.ones(4, dtype=torch.bool, device=cuda_device)

    def snapshot():
        return [kv_cache.kv_map(torch.clone, c[side]) for c in (cache_t, cache_d)
                for side in ("k", "v")]

    def restore(saved):
        for c, (k_saved, v_saved) in zip((cache_t, cache_d), (saved[:2], saved[2:])):
            c["k"].copy_(k_saved)
            c["v"].copy_(v_saved)

    saved = snapshot()
    side_stream = torch.cuda.Stream()
    side_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side_stream):  # warm up off the capture
        for _ in range(2):
            fn(target.params, draft.params, s_cur, cache_t, cache_d, s_start, s_active)
    torch.cuda.current_stream().wait_stream(side_stream)
    restore(saved)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = fn(target.params, draft.params, s_cur, cache_t, cache_d, s_start, s_active)
    g_d, g_p, g_a, g_cur, g_ct, g_cd = g_out

    def eager(cur_in, start_in, active_in):
        restore(saved)
        d, p, a, c, ct, cd = fn(target.params, draft.params, cur_in, cache_t, cache_d,
                                start_in, active_in)
        torch.cuda.synchronize()
        return [t.clone() for t in (d, p, a, c, ct["length"], cd["length"], ct["k"], cd["k"])]

    cases = [
        (cur.clone(), cache_t["length"].clone(), torch.ones(4, dtype=torch.bool, device=cuda_device)),
        (torch.tensor([7, 8, 9, 10], device=cuda_device),
         torch.tensor([3, 2, 4, 1], device=cuda_device),
         torch.tensor([True, False, True, True], device=cuda_device)),
    ]
    for cur_in, start_in, active_in in cases:
        want = eager(cur_in, start_in, active_in)
        restore(saved)
        s_cur.copy_(cur_in)
        s_start.copy_(start_in)
        s_active.copy_(active_in)
        graph.replay()
        torch.cuda.synchronize()
        got = [g_d, g_p, g_a, g_cur, g_ct["length"], g_cd["length"], g_ct["k"], g_cd["k"]]
        for a, b in zip(want[:6], got[:6]):
            assert torch.equal(a, b)
        for a, b in zip(want[6:], got[6:]):
            assert torch.equal(a, b)


# ---- the device plane on the card -----------------------------------------


@pytest.mark.cuda
def test_capture_finds_k1_and_k2_and_the_ledger_closes(cuda_device, tmp_path):
    """One prefill (K1), one decode chunk and one paged step with K2 on,
    under ``capture``: the ops lane names both kernels, every dispatch
    comes back as module spans on the device (one per run of its
    kernels), the ledger's buckets sum to its window, and its busy time
    is kernel time, no more."""
    from tpuslo_torch.deviceplane.ledger import build_ledger
    from tpuslo_torch.otel import xla_spans

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                            ffn_dim=512, max_seq_len=512)
    engine = serve.ServeEngine(cfg, rng_seed=0, decode_chunk_size=4, device=cuda_device)
    paged = paged_kv.PagedBatchingEngine(cfg, engine.params, max_slots=2, block_size=16,
                                         pallas_attention=True, device=cuda_device)
    for prompt in ("a paged lane", "another paged lane"):
        paged.submit(prompt, max_new_tokens=16, stop_at_eos=False)
    paged.step()
    prompt = "x" * 100  # a 128-bucket prefill: K1
    list(engine.generate(prompt, max_new_tokens=5, stop_at_eos=False))  # warm
    k1, k2 = flash_attention.launches, paged_decode_attention.launches
    lanes = launch_counts.cached_layers
    with xla_spans.capture(str(tmp_path), include_ops=True) as cap:
        list(engine.generate(prompt, max_new_tokens=5, stop_at_eos=False))
        paged.step()
    assert flash_attention.launches - k1 == cfg.n_layers
    # The paged step's layers, and the decode chunk's (the dense cache as
    # K2's lanes).
    lanes = launch_counts.cached_layers - lanes
    assert lanes == 4 * cfg.n_layers
    assert paged_decode_attention.launches - k2 == cfg.n_layers + lanes
    assert cap.module_source == "kernel_segments"
    ops = [s for s in cap.spans if s.lane == xla_spans.OPS_LANE]
    names = " ".join(s.name for s in ops)
    for kernel in ("flash_fwd_kernel", "paged_split_kernel", "paged_combine_kernel"):
        assert kernel in names
    mods = list(cap.launches())
    assert {"prefill", "decode_chunk", "paged_decode_step"} <= {s.module_name for s in mods}
    assert all(s.device_pid == cuda_device.index and s.launch_id >= 1 for s in mods)
    ledger = build_ledger(cap.spans)
    assert ledger.total_us > 0
    assert ledger.bucket_sum_us == pytest.approx(ledger.total_us, rel=1e-9)
    assert ledger.tier_counts.get("identity", 0) >= 3
    busy = sum(s.duration_us for s in mods)
    assert ledger.buckets_us["joined"] == pytest.approx(busy, rel=1e-9)
    assert busy <= sum(s.duration_us for s in ops) + 1e-6


@pytest.mark.cuda
def test_live_hbm_reading_is_the_allocator(cuda_device, monkeypatch):
    from tpuslo_torch.collector import hbm_sampler

    monkeypatch.delenv("TPUSLO_HBM_STATS_PATH", raising=False)
    monkeypatch.setattr(hbm_sampler, "_DEVICE_PROBE_DEAD", False)
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    stats = hbm_sampler.read_stats()
    assert stats is not None, hbm_sampler.LAST_PROBE_ERROR
    in_use, limit = stats
    assert in_use == torch.cuda.memory_allocated(cuda_device) >= keep.numel()
    assert limit == torch.cuda.mem_get_info(cuda_device)[1]
    assert hbm_sampler.LAST_PROBE_ERROR is None


@pytest.mark.cuda
def test_head_dim_256_block_runs_k1_on_the_card(cuda_device):
    """A causal block at head dim 256 launches K1's 256 instantiation once
    and equals the same block through the plain attention: within K1's
    bound plus one bf16 ulp of the residual sum (|out| < 8)."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=1, n_heads=2, n_kv_heads=1,
                            ffn_dim=512, max_seq_len=256)
    assert cfg.head_dim == 256
    params = llama.init_params(5, cfg, cuda_device)
    layer = llama._layer(params, 0)
    S = 128
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    h = torch.randn(2, S, cfg.dim, generator=gen, device=cuda_device).bfloat16()
    cos, sin = llama.rope_frequencies(cfg, torch.arange(S, device=cuda_device)[None])
    mask = torch.ones(S, S, dtype=torch.bool, device=cuda_device).tril()
    before = flash_attention.launches
    out, _ = llama.attention_block(cfg, h, layer, cos, sin, mask, causal=True)
    plain, _ = llama.attention_block(cfg, h, layer, cos, sin, mask, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - plain.float()).abs().max().item() < 2 * KERNEL_TOL


@pytest.mark.cuda
def test_annotated_round_graphs_and_profiles(cuda_device, tmp_path):
    """The batched round's dispatch range is compiled in: the round still
    captures in a CUDA graph (no profiler: the range is a no-op), and an
    eager round under ``capture`` comes back as module spans of one
    launch holding its kernels."""
    from tpuslo_torch.otel import xla_spans

    target, draft = _spec_pair(cuda_device)
    rows = [[serve.BOS, 5, 6, 7], [serve.BOS, 9]]
    cur, cache_t, cache_d = _round_state(target, draft, rows)
    fn = speculative._shared_spec_round_batch_fn(target.cfg, draft.cfg, 3)
    start = cache_t["length"].clone()
    active = torch.ones(2, dtype=torch.bool, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(target.params, draft.params, cur, cache_t, cache_d, start, active)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(target.params, draft.params, cur, cache_t, cache_d, start, active)
    graph.replay()
    torch.cuda.synchronize()
    with xla_spans.capture(str(tmp_path), include_ops=True) as cap:
        fn(target.params, draft.params, cur, cache_t, cache_d, start, active)
    runs = [s for s in cap.launches() if s.module_name == "spec_round_batch"]
    assert len({(s.program_id, s.launch_id) for s in runs}) == 1
    inside = [s for s in cap.spans if s.lane == xla_spans.OPS_LANE
              and any(r.start_us <= s.start_us < r.start_us + r.duration_us for r in runs)]
    assert len(inside) > 10


@pytest.mark.cuda
def test_the_entry_serves_five_cycles_on_the_card(cuda_device, tmp_path):
    """``python -m tpuslo_torch frontdoor`` on the card (its default
    device): five cycles, the demotion from cycle 0 and the healthy
    tenant admitted first from cycle 1, the card named on stderr."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    status = tmp_path / "status.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "tpuslo_torch", "frontdoor", "--cycles", "5",
         "--interval-s", "0", "--status-out", str(status), "--state-dir", str(tmp_path),
         "--json"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert torch.cuda.get_device_name(0) in out.stderr
    rows = [json.loads(line) for line in status.read_text().splitlines()]
    assert [r["cycle"] for r in rows] == list(range(5))
    assert rows[0]["admitted"] == ["burny", "steady"]
    assert all(r["admitted"] == ["steady", "burny"] for r in rows[1:])
    assert all(r["remediation_applied"] for r in rows)
    assert json.loads(out.stdout) == {"cycles": 5, "burn_state": "fast_burn", "priority": 10,
                                      "remediation_phase": "verifying", "order_flips": 4}


# ---- one CUDA graph per speculative dispatch --------------------------------


def _buffers(*caches_and_tensors):
    out = []
    for x in caches_and_tensors:
        if isinstance(x, dict):
            for side in ("k", "v", "length"):
                leaf = x[side]
                if isinstance(leaf, torch.Tensor):
                    out.append(leaf)
        else:
            out.append(x)
    return out


def _replay_equals_eager(dispatch, buffers):
    """Replay ``dispatch``'s graph, then put every buffer back and run its
    eager body on the same inputs: the packed outputs and every buffer
    after the dispatch must be equal bit for bit."""
    assert dispatch.graph is not None
    saved = [b.clone() for b in buffers]
    got = dispatch().clone()
    after = [b.clone() for b in buffers]
    for b, s in zip(buffers, saved):
        b.copy_(s)
    want = dispatch._body()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(after, buffers):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
def test_front_door_replay_equals_the_eager_chain(cuda_device):
    """The front door's dispatch (3 chained rounds over 4 slots) replayed
    from its graph equals its eager body on the same buffers, with one
    slot free (inactive), one row that finishes in the dispatch's first
    round and rows of different frontiers."""
    target, draft = _spec_pair(cuda_device)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=4, rounds_per_step=3)
    assert fd._dispatch.graph is not None and target.compile_events
    fd.submit("a long stream that keeps going", max_new_tokens=60, stop_at_eos=False)
    fd.submit("short", max_new_tokens=2, stop_at_eos=False)
    fd.submit("x" * 140, max_new_tokens=40, stop_at_eos=False)
    fd._fill_slots()
    mask = np.asarray([s is not None for s in fd._slots])
    assert mask.tolist() == [True, True, True, False]
    fd._start_in.write(fd._start)
    fd._active_in.write(mask)
    packed = _replay_equals_eager(fd._dispatch, _buffers(
        fd._cache_t, fd._cache_d, fd._tokens, fd._start_in.tensor, fd._active_in.tensor))
    assert packed.shape == (4, 3, 2 * 3 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 4], ids=["stream", "batch"])
def test_speculative_replay_equals_the_eager_round(cuda_device, batch):
    """The single-stream round (0-d frontier) and the batched round at
    bucket 4 (one inactive row) replayed from their graphs equal their
    eager bodies on the same buffers; the graphs were captured at first
    use and recorded as compile events."""
    target, draft = _spec_pair(cuda_device)
    spec = speculative.SpeculativeEngine(target, draft, k=3)
    if batch is None:
        spec.generate("one stream to capture", max_new_tokens=8, stop_at_eos=False)
    else:
        spec.generate_batch(["a", "bb", "ccc"], max_new_tokens=8, stop_at_eos=False)
    state = spec._states[batch]
    captures = [e for e in target.compile_events if e.get("module_name")]
    assert [e["bucket"] for e in captures] == [state.dispatch.key]
    rows = [[serve.BOS, 5, 6, 7, 8], [serve.BOS, 9, 10], [serve.BOS, 3, 4, 5], [serve.BOS, 2]]
    cur, cache_t, cache_d = _round_state(target, draft, rows[:1] if batch is None else rows)
    state.load(cache_t, cache_d, cur)
    if batch is None:
        state.frontier.fill_(len(rows[0]))
        buffers = _buffers(state.cache_t, state.cache_d, state.current, state.frontier)
    else:
        state.start.write(np.asarray([len(r) for r in rows]))
        state.active.write(np.asarray([True, False, True, True]))
        buffers = _buffers(state.cache_t, state.cache_d, state.current, state.start.tensor,
                           state.active.tensor)
    _replay_equals_eager(state.dispatch, buffers)


@pytest.mark.cuda
def test_twenty_steady_front_door_steps_never_recapture(cuda_device):
    """Under the benches' audit: the engine captures once, when it is
    built; each of 20 steady steps then makes no synchronizing call, one
    host read and no capture, and the buffers never move."""
    from tpuslo_torch.analysis import jitaudit

    target, draft = _spec_pair(cuda_device)
    jitaudit.install()
    audit = jitaudit.registry()
    audit.reset()
    try:
        fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=2, rounds_per_step=2)
        # The dispatch, and the admission graphs of both engines.
        assert audit.capture_count() == 1 + fd.admission_captures
        assert fd.admission_captures > 0 and audit.steady_compile_count() == 0
        for i in range(2):
            fd.submit(f"steady graph {i}", max_new_tokens=200, stop_at_eos=False)
        fd.step()
        fd.step()
        ptrs = [b.data_ptr() for b in _buffers(fd._cache_t, fd._cache_d, fd._tokens)]
        for _ in range(20):
            before = (audit.syncs, audit.host_reads, audit.capture_count())
            assert fd.step()
            torch.cuda.synchronize()
            assert (audit.syncs - before[0], audit.host_reads - before[1],
                    audit.capture_count() - before[2]) == (0, 1, 0)
        assert [b.data_ptr() for b in _buffers(fd._cache_t, fd._cache_d, fd._tokens)] == ptrs
        assert audit.steady_compile_count() == 0
    finally:
        jitaudit.uninstall()
        audit.reset()


@pytest.mark.cuda
def test_one_dispatch_range_per_replay_and_the_capture_reads_as_compile(cuda_device, tmp_path):
    """Under ``capture``: an engine built in the window reads its capture's
    warm-up as a launch of the ``compile`` bucket (its compile event joins
    it by program id); three steady steps are three launches of the
    dispatch's program, each holding the graph's kernels, and the ledger
    counts three dispatches."""
    from tpuslo_torch.deviceplane import ledger as dl
    from tpuslo_torch.otel import xla_spans

    target, draft = _spec_pair(cuda_device)
    with xla_spans.capture(str(tmp_path), include_ops=True) as cap:
        fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=2, rounds_per_step=2)
    ledger = dl.build_ledger(cap.spans, target.compile_events)
    assert ledger.buckets_us["compile"] > 0
    assert ledger.tier_counts.get("compile_event", 0) >= 1
    for i in range(2):
        fd.submit(f"ranged {i}", max_new_tokens=200, stop_at_eos=False)
    fd.step()
    with xla_spans.capture(str(tmp_path), include_ops=True) as cap:
        for _ in range(3):
            fd.step()
    runs = [s for s in cap.launches() if s.module_name == "spec_multi_round"]
    assert len({(s.program_id, s.launch_id) for s in runs}) == 3
    ledger = dl.build_ledger(cap.spans)
    assert dl.dispatch_count(ledger) == 3
    for launch in {s.launch_id for s in runs}:
        spans = [s for s in runs if s.launch_id == launch]
        inside = [o for o in cap.spans if o.lane == xla_spans.OPS_LANE and any(
            r.start_us <= o.start_us < r.start_us + r.duration_us for r in spans)]
        assert len(inside) > 50


# ---- batch invariance: a row's bits whatever its batch -----------------------

# Row r alone against row r inside each of these batches, the other rows
# random; the RMSNorm kernel within one bf16 ulp of ``rms_norm``'s plain
# version, K2's lanes within K2's bound of the plain attention.
INVARIANCE_BATCHES = (2, 5, 8, 16, 40, 80, 200)


def _rows_checked(n):
    return sorted({0, n // 2, n - 1})


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(3072, torch.bfloat16), (2048, torch.bfloat16),
                                     (64, torch.bfloat16), (3072, torch.float32),
                                     (256, torch.float16)])
def test_rms_norm_kernel_is_batch_invariant(cuda_device, D, dtype):
    from tpuslo_torch.ops import rms_norm as rn

    gen = torch.Generator(device=cuda_device).manual_seed(D)
    big = max(INVARIANCE_BATCHES)
    x = (3 * torch.randn((big, D), generator=gen, device=cuda_device)).to(dtype)
    w = (1 + 0.1 * torch.randn((D,), generator=gen, device=cuda_device)).to(dtype)
    before = rn.rms_norm.launches
    alone = [rn.rms_norm(x[r:r + 1], w, 1e-5)[0] for r in range(big)]
    for n in INVARIANCE_BATCHES:
        y = rn.rms_norm(x[:n], w, 1e-5)
        for r in _rows_checked(n):
            assert torch.equal(y[r], alone[r]), (n, r)
    got = rn.rms_norm(x.reshape(8, 25, D), w, 1e-5)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches == before + big + len(INVARIANCE_BATCHES) + 1
    assert got.shape == (8, 25, D) and got.dtype == dtype
    ref = rn.rms_norm_reference(x, w, 1e-5).float()
    bf16_ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert ((got.reshape(big, D).float() - ref).abs() <= bf16_ulp).all()


@pytest.mark.cuda
def test_rms_norm_kernel_never_falls_back(cuda_device):
    from tpuslo_torch.ops import rms_norm as rn

    x = torch.ones((4, 64), dtype=torch.bfloat16, device=cuda_device)
    before = rn.rms_norm.launches
    with pytest.raises(ValueError, match="one dtype"):
        rn.rms_norm(x, torch.ones(64, dtype=torch.float32, device=cuda_device), 1e-5)
    with pytest.raises(ValueError, match="one dtype"):
        rn.rms_norm(x.double(), torch.ones(64, dtype=torch.float64, device=cuda_device), 1e-5)
    with pytest.raises(ValueError, match="weight"):
        rn.rms_norm(x, torch.ones(32, dtype=torch.bfloat16, device=cuda_device), 1e-5)
    assert rn.rms_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,KV,HD,K,cache", [
    (192, 24, 8, 128, 5, "bf16"),   # the 3B target's verify at S 192
    (2048, 24, 8, 128, 5, "bf16"),  # ... at S 2048 (two blocks of 1024)
    (2048, 32, 8, 64, 1, "bf16"),   # the 1B draft's decode
    (192, 32, 8, 64, 5, "int8"),
    (128, 4, 2, 16, 5, "bf16"),     # llama_tiny: K2-f32
    (192, 2, 1, 128, 5, "f32"),     # an f32 model: K2-f32
])
def test_dense_lanes_are_batch_invariant(cuda_device, T, H, KV, HD, K, cache):
    from tpuslo_torch.ops import dense_lanes as dl

    gen = torch.Generator(device=cuda_device).manual_seed(T + HD)
    big = max(INVARIANCE_BATCHES)
    dtype = torch.float32 if cache == "f32" else torch.bfloat16
    k = torch.randn((big, T, KV, HD), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((big, T, KV, HD), generator=gen, device=cuda_device).to(dtype)
    q = torch.randn((big, K, H, HD), generator=gen, device=cuda_device).to(dtype)
    pos = torch.randint(0, T + 4, (big, K), generator=gen, device=cuda_device)
    if cache == "int8":
        k, v = kv_cache.quantize_kv(k.float()), kv_cache.quantize_kv(v.float())

    def rows(side, a, b):
        return {n: t[a:b] for n, t in side.items()} if isinstance(side, dict) else side[a:b]

    before = (paged_decode_attention.launches, paged_decode_attention.f32_launches)
    alone = [dl.dense_lane_attention(q[r:r + 1], rows(k, r, r + 1), rows(v, r, r + 1),
                                     pos[r:r + 1])[0] for r in range(big)]
    for n in INVARIANCE_BATCHES:
        out = dl.dense_lane_attention(q[:n], rows(k, 0, n), rows(v, 0, n), pos[:n])
        for r in _rows_checked(n):
            assert torch.equal(out[r], alone[r]), (n, r)
    torch.cuda.synchronize()
    calls = big + len(INVARIANCE_BATCHES)
    f32_route = HD == 16 or cache == "f32"
    assert (paged_decode_attention.launches - before[0],
            paged_decode_attention.f32_launches - before[1]) == (
        (0, calls) if f32_route else (calls, 0))
    n = 16
    mask = torch.arange(T, device=cuda_device)[None, None, :] <= pos[:n, :, None]
    kd, vd = kv_cache.kv_load(rows(k, 0, n), torch.float32), kv_cache.kv_load(rows(v, 0, n),
                                                                              torch.float32)
    ref = llama.attention(q[:n].float(), kd.float(), vd.float(), mask, H // KV)
    got = torch.stack(alone[:n]).float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() < (F32_TOL if cache == "f32" else PAGED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,d_out,int8", [
    (3072, 3072, False), (3072, 1024, False), (3072, 8192, False), (8192, 3072, False),
    (3072, 128256, False), (2048, 2048, False), (2048, 512, False), (8192, 2048, False),
    (256, 512, True),
])
def test_weight_products_are_batch_invariant(cuda_device, d_in, d_out, int8):
    """``llama._matmul`` on the card: every product runs as pieces of one
    shape (cuBLAS at ``GEMM_ROWS`` rows), so a row alone and inside 2 to
    200 rows (two pieces) gets the same bits; the values are the one
    product's."""
    gen = torch.Generator(device=cuda_device).manual_seed(d_in + d_out)
    big = max(INVARIANCE_BATCHES)
    W = (torch.randn((d_in, d_out), generator=gen, device=cuda_device) * d_in**-0.5)
    W = llama._quantize_leaf(W) if int8 else W.bfloat16()
    X = torch.randn((big, d_in), generator=gen, device=cuda_device).bfloat16()
    alone = [llama._matmul(X[r:r + 1], W)[0] for r in range(big)]
    for n in INVARIANCE_BATCHES:
        y = llama._matmul(X[:n], W)
        for r in _rows_checked(n):
            assert torch.equal(y[r], alone[r]), (n, r)
    want = llama._product(X.float(), W if int8 else W.float())
    got = torch.stack(alone).float()
    assert (got - want.float()).abs().max().item() <= 2**-6 * want.abs().max().item()


def _pass_model(cuda_device):
    """A 2-layer model at llama32_3b's widths (bf16, S 192) and caches of 8
    rows holding random K/V."""
    cfg = dataclasses.replace(llama.llama32_3b(max_seq_len=192), n_layers=2)
    params = llama.init_params(0, cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    cache = llama.init_kv_cache(cfg, 8, device=cuda_device)
    for side in ("k", "v"):
        cache[side].copy_(torch.randn(cache[side].shape, generator=gen, device=cuda_device))
    return cfg, params, cache


def _rows_of(cache, n):
    return {side: cache[side][:, :n].clone() for side in ("k", "v")}


@pytest.mark.cuda
@pytest.mark.parametrize("pass_", ["verify", "decode"])
def test_a_pass_gives_row_0_the_same_logits_in_any_batch(cuda_device, pass_):
    """A verify pass (k + 1 = 5 positions) and a decode pass: row 0's
    logits have the same bits at B 1 (the single stream's 0-d frontier)
    as at B 2 and B 8 (per-row frontiers, the other rows other tokens),
    and the pass reads the caches through K2 once per layer, with the
    RMSNorm kernel for the first norm and the fused add + RMSNorm kernel
    for every residual add and the norm after it."""
    from tpuslo_torch.ops import rms_norm as rn

    cfg, params, cache = _pass_model(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    K = 5 if pass_ == "verify" else 1
    tokens = torch.randint(0, cfg.vocab_size, (8, K), generator=gen, device=cuda_device)
    fronts = torch.tensor([100, 40, 150, 7, 120, 60, 186, 90], device=cuda_device)
    logits = {}
    for n in (1, 2, 8):
        c = _rows_of(cache, n)
        c["length"] = fronts[0].clone() if n == 1 else fronts[:n].clone()
        k2, norms, fused, lanes = (paged_decode_attention.launches, rn.rms_norm.launches,
                                   rn.add_rms_norm.launches, launch_counts.cached_layers)
        if pass_ == "verify":
            out, _ = llama.verify_chunk(params, tokens[:n], c, cfg)
        else:
            out, _ = llama.decode_step(params, tokens[:n, 0], c, cfg)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches - k2 == cfg.n_layers
        assert launch_counts.cached_layers - lanes == cfg.n_layers
        assert rn.rms_norm.launches - norms == 1  # the first attn_norm
        assert rn.add_rms_norm.launches - fused == 2 * cfg.n_layers
        logits[n] = out[0]
    assert torch.isfinite(logits[1]).all()
    assert torch.equal(logits[1], logits[2]) and torch.equal(logits[1], logits[8])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 128])
def test_a_batched_prefill_gives_each_row_a_lone_prefills_bits(cuda_device, S):
    """A batched admission's prefill (4 rows at one bucket, each its own
    true length) gives every row the logits and cache bits of that row's
    lone prefill, at a bucket the plain attention takes (64) and at one
    K1 takes (128): each row's weight products run at the lone
    prefill's shape."""
    cfg, params, _ = _pass_model(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (4, S), generator=gen, device=cuda_device)
    lengths = torch.tensor([S, S - 5, S // 2, 3], device=cuda_device)
    batch, cache = llama.prefill(params, tokens, llama.init_kv_cache(cfg, 4, device=cuda_device),
                                 cfg, true_length=lengths)
    for r in range(4):
        lone, one = llama.prefill(params, tokens[r:r + 1],
                                  llama.init_kv_cache(cfg, 1, device=cuda_device), cfg,
                                  true_length=lengths[r:r + 1])
        assert torch.isfinite(lone).all()
        assert torch.equal(batch[r], lone[0]), r
        for side in ("k", "v"):
            assert torch.equal(cache[side][:, r, :S], one[side][:, 0, :S]), (r, side)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 64])
def test_a_batched_prompt_chunk_gives_each_row_a_lone_chunks_bits(cuda_device, K):
    """A prompt chunk appended to 4 rows' caches (each its own frontier)
    gives every row the logits and cache bits of that row's chunk
    appended alone: each row's weight products run at the lone chunk's
    shape, and K2 reads the caches once per layer."""
    cfg, params, cache = _pass_model(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (4, K), generator=gen, device=cuda_device)
    fronts = torch.tensor([100, 7, 150 - K, 60], device=cuda_device)
    c = _rows_of(cache, 4)
    c["length"] = fronts.clone()
    k2 = paged_decode_attention.launches
    batch, _ = llama.verify_chunk(params, tokens, c, cfg, prompt_chunk=True)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches - k2 == cfg.n_layers
    for r in range(4):
        one = {side: cache[side][:, r:r + 1].clone() for side in ("k", "v")}
        one["length"] = fronts[r:r + 1].clone()
        lone, _ = llama.verify_chunk(params, tokens[r:r + 1], one, cfg, prompt_chunk=True)
        assert torch.isfinite(lone).all()
        assert torch.equal(batch[r], lone[0]), r
        for side in ("k", "v"):
            assert torch.equal(c[side][:, r], one[side][:, 0]), (r, side)


@pytest.mark.cuda
def test_replays_count_the_kernels_they_launch(cuda_device):
    """A graphed dispatch's kernels are counted where they run: the
    capture's warm-up launches them once, the capture itself (recording)
    adds nothing, and every replay adds what it launches: K2 once per
    layer of each of a round's cached passes (the target's verify, the
    draft's k steps and its fill), two rounds per dispatch."""
    target, draft = _spec_pair(cuda_device)
    k, rounds = 3, 2
    per_dispatch = rounds * (target.cfg.n_layers + (k + 1) * draft.cfg.n_layers)
    # Each admission suffix graph's warm-up: one pass over its engine's layers.
    suffixes = len(target.prefill_buckets) * (target.cfg.n_layers + draft.cfg.n_layers)
    k2, lanes = paged_decode_attention.launches, launch_counts.cached_layers
    fd = frontdoor.FrontDoorEngine(target, draft, k=k, max_slots=4, rounds_per_step=rounds)
    assert fd._dispatch.graph is not None
    assert paged_decode_attention.launches - k2 == per_dispatch + suffixes
    assert launch_counts.cached_layers - lanes == per_dispatch + suffixes
    fd.submit("a stream that keeps going", max_new_tokens=40, stop_at_eos=False)
    fd.submit("another one", max_new_tokens=40, stop_at_eos=False)
    for _ in range(3):
        k2, lanes = paged_decode_attention.launches, launch_counts.cached_layers
        fd.step()
        assert paged_decode_attention.launches - k2 == per_dispatch
        assert launch_counts.cached_layers - lanes == per_dispatch


# ---- the fused add + RMSNorm kernel ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(3072, torch.bfloat16), (2048, torch.bfloat16),
                                     (64, torch.bfloat16), (256, torch.float32),
                                     (3072, torch.float32), (256, torch.float16),
                                     (100, torch.bfloat16), (16384, torch.bfloat16),
                                     (1100, torch.bfloat16)])
def test_fused_add_rms_norm_against_the_plain_add_and_norm(cuda_device, D, dtype):
    """The fused kernel's sum equals the eager ``h + d`` bit for bit and
    its norm is within one bf16 ulp of the plain norm of that sum, at the
    models' widths, on 16-byte packs and on the scalar path (D 100), and
    on rows too wide for the registers (D 16,384 on packs, 1,100 off
    them), with one launch per call."""
    from tpuslo_torch.ops import rms_norm as rn

    gen = torch.Generator(device=cuda_device).manual_seed(D)
    h = (3 * torch.randn((3, 7, D), generator=gen, device=cuda_device)).to(dtype)
    d = torch.randn((3, 7, D), generator=gen, device=cuda_device).to(dtype)
    w = (1 + 0.1 * torch.randn((D,), generator=gen, device=cuda_device)).to(dtype)
    before = rn.add_rms_norm.launches
    got_h, got_y = rn.add_rms_norm(h, d, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.add_rms_norm.launches == before + 1
    ref_h, ref_y = rn.add_rms_norm_reference(h, d, w, 1e-5)
    assert got_h.shape == got_y.shape == h.shape and got_y.dtype == dtype
    assert torch.equal(got_h, ref_h)
    ref = ref_y.float()
    bf16_ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert ((got_y.float() - ref).abs() <= bf16_ulp).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3072, 2048, 16384])
def test_fused_add_rms_norm_is_batch_invariant(cuda_device, D):
    """Row r of the fused kernel alone and inside batches of 2 to 200
    rows: both outputs bit for bit, the other rows random."""
    from tpuslo_torch.ops import rms_norm as rn

    gen = torch.Generator(device=cuda_device).manual_seed(D + 1)
    big = max(INVARIANCE_BATCHES)
    h = (3 * torch.randn((big, D), generator=gen, device=cuda_device)).bfloat16()
    d = torch.randn((big, D), generator=gen, device=cuda_device).bfloat16()
    w = (1 + 0.1 * torch.randn((D,), generator=gen, device=cuda_device)).bfloat16()
    alone = [rn.add_rms_norm(h[r:r + 1], d[r:r + 1], w, 1e-5) for r in range(big)]
    for n in INVARIANCE_BATCHES:
        hs, ys = rn.add_rms_norm(h[:n], d[:n], w, 1e-5)
        for r in _rows_checked(n):
            assert torch.equal(hs[r], alone[r][0][0]) and torch.equal(ys[r], alone[r][1][0]), (
                n, r)


@pytest.mark.cuda
def test_fused_add_rms_norm_never_falls_back(cuda_device):
    from tpuslo_torch.ops import rms_norm as rn

    h = torch.ones((4, 64), dtype=torch.bfloat16, device=cuda_device)
    w = torch.ones(64, dtype=torch.bfloat16, device=cuda_device)
    before = rn.add_rms_norm.launches
    with pytest.raises(ValueError, match="one dtype"):
        rn.add_rms_norm(h, h.float(), w, 1e-5)
    with pytest.raises(ValueError, match="update"):
        rn.add_rms_norm(h, h[:2], w, 1e-5)
    with pytest.raises(ValueError, match="weight"):
        rn.add_rms_norm(h, h, w[:32], 1e-5)
    assert rn.add_rms_norm.launches == before


# ---- admissions as graph replays ---------------------------------------------


def _tiny_pair(device, max_seq_len=1024):
    cfg = llama.llama_tiny(max_seq_len=max_seq_len)
    return (serve.ServeEngine(cfg, rng_seed=0, device=device),
            serve.ServeEngine(cfg, rng_seed=1, device=device))


def _same_rows(got: dict, want: dict, lengths) -> None:
    """Two caches' K/V equal bit for bit on each row's first
    ``lengths[b]`` positions (above them a row holds nothing it reads)."""
    for side in ("k", "v"):
        for b, n in enumerate(lengths):
            assert torch.equal(got[side][:, b, :n], want[side][:, b, :n]), (side, b)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[serve.BOS] + rng.integers(0, 256, n - 1).tolist() for n in lengths]


@pytest.mark.cuda
def test_graphed_admissions_equal_their_eager_bodies_at_every_key(cuda_device):
    """Every key of an 8-slot llama_tiny front door's admission graphs,
    replayed, gives the eager path's logits and cache rows bit for bit:
    each (batch bucket, prefill bucket) cold prefill, each suffix chunk
    of a warm prefix admission, a batched admission whose longest row
    runs two chunks past its head, and a snapshot-restored teacher
    forcing; every admission chunk went through a graph."""
    target, draft = _tiny_pair(cuda_device)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=8)
    adm = target._admission
    assert fd.admission_captures == 2 * (4 * 4 + 4) and adm.captures == 4 * 4 + 4
    buckets = target.prefill_buckets
    for B in (1, 2, 4, 8):
        for i, S in enumerate(buckets):
            lo = buckets[i - 1] + 1 if i else 2
            lengths = [S] + list(np.random.default_rng(B * S).integers(lo - 1, S, B - 1) + 1)
            rows = _prompts(B * 1000 + S, lengths)
            want_logits, want = target._prefill_rows(rows, 0)
            got_logits, got = adm.prefill_rows(rows)
            torch.cuda.synchronize()
            assert torch.equal(got_logits, want_logits), (B, S)
            assert torch.equal(got["length"], want["length"])
            _same_rows(got, want, lengths)
    # A batch whose longest row runs two chunks past the head (600 ids).
    rows = _prompts(5, [600, 40, 300, 9])
    want_logits, want = target._prefill_rows(rows, 0)
    got_logits, got = adm.prefill_rows(rows)
    assert torch.equal(got_logits, want_logits)
    _same_rows(got, want, [600, 40, 300, 9])
    # Warm prefix admissions: a tail at each suffix bucket.
    prefix = "You are the serving team's assistant. "
    prefix_ids, _ = serve.prefix_prompt_ids(prefix, "", target.cfg.max_seq_len)
    for S in buckets:
        ids = prefix_ids + _prompts(S, [S + 1])[0][1:]
        want_logits, want = target.ingest_ids(ids, prefix, prefix_ids)
        got_logits, got = adm.ingest_ids(ids, prefix, prefix_ids)
        assert torch.equal(got_logits, want_logits), S
        assert got["length"] == want["length"] == len(ids)
        _same_rows(got, want, [len(ids)])
    # A snapshot-restored request: the prompt and its emitted tokens.
    context = _prompts(9, [330])[0]
    want_logits, want = target.ingest_ids(context)
    got_logits, got = adm.ingest_ids(context)
    assert torch.equal(got_logits, want_logits)
    _same_rows(got, want, [len(context)])
    assert adm.eager_chunks == 0


@pytest.mark.cuda
def test_a_graphed_admission_equals_its_eager_body_at_3b_widths(cuda_device):
    """One key at llama32_3b's widths (4 of its 28 layers): an 8-row cold
    admission at bucket 256 and a 256-bucket suffix chunk, replayed, give
    the eager path's bits."""
    cfg = dataclasses.replace(llama.llama32_3b(max_seq_len=1024), n_layers=4)
    engine = serve.ServeEngine(cfg, rng_seed=0, device=cuda_device)
    adm = engine.admission_graphs((1, 8))
    assert adm.prefills[(8, 256)].run.graph is not None
    lengths = [256, 200, 129, 250, 131, 256, 180, 140]
    rows = _prompts(3, lengths)
    want_logits, want = engine._prefill_rows(rows, 0)
    got_logits, got = adm.prefill_rows(rows)
    assert torch.equal(got_logits, want_logits)
    _same_rows(got, want, lengths)
    ids = _prompts(4, [256 + 250])[0]
    want_logits, want = engine.ingest_ids(ids)
    got_logits, got = adm.ingest_ids(ids)
    assert torch.equal(got_logits, want_logits)
    _same_rows(got, want, [len(ids)])


@pytest.mark.cuda
def test_two_front_doors_over_the_same_engines_capture_once(cuda_device):
    """Under the benches' audit: the first front door over a pair of
    engines captures its dispatch and both engines' admission graphs; a
    second one captures its dispatch only, and nothing is a recapture.
    Its admissions replay the first one's graphs with no eager chunk."""
    from tpuslo_torch.analysis import jitaudit

    target, draft = _tiny_pair(cuda_device, max_seq_len=512)
    jitaudit.install()
    audit = jitaudit.registry()
    audit.reset()
    try:
        first = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=8)
        second = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=4)
        assert first.admission_captures > 0 and second.admission_captures == 0
        assert audit.capture_count() == 2 + first.admission_captures
        for i in range(6):
            second.submit(f"request {i} " * (i + 1), max_new_tokens=4, stop_at_eos=False,
                          prefix="shared system prompt. " if i % 2 else None)
        second.run()
        assert audit.steady_compile_count() == 0 and second.eager_admissions == 0
    finally:
        jitaudit.uninstall()
        audit.reset()


@pytest.mark.cuda
def test_an_admission_leaves_what_an_earlier_one_kept_unchanged(cuda_device):
    """The prefix cache's snapshot and logits, kept from a first
    admission, are copies: a second admission's replays (a batch of
    plain prompts and another prefix) leave them bit for bit."""
    target, draft = _tiny_pair(cuda_device, max_seq_len=512)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=4)
    fd.submit("first question", max_new_tokens=3, stop_at_eos=False, prefix="kept prefix. ")
    fd.run()
    entry = target._prefix_cache["kept prefix. "]
    kept = [entry.cache["k"].clone(), entry.cache["v"].clone(), entry.logits.clone()]
    for i in range(4):
        fd.submit(f"plain {i} " * 20, max_new_tokens=3, stop_at_eos=False)
    fd.submit("another", max_new_tokens=3, stop_at_eos=False, prefix="another prefix. ")
    fd.run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        kept, [entry.cache["k"], entry.cache["v"], entry.logits]))


@pytest.mark.cuda
def test_the_capture_prints_its_stage_split(cuda_device, tmp_path, capsys):
    """A capture over a front-door step times each stage of its exit, and
    the spans it reads from the profiler's in-memory events equal those
    read back from the trace it exported (times to a nanosecond: the two
    round differently)."""
    from tpuslo_torch.otel import xla_spans

    target, draft = _spec_pair(cuda_device)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=2, rounds_per_step=2)
    for i in range(2):
        fd.submit(f"split {i}", max_new_tokens=100, stop_at_eos=False)
    fd.step()
    with xla_spans.capture(str(tmp_path), include_ops=True) as cap:
        fd.step()
    with capsys.disabled():
        print(f"capture: stages (ms) {({k: round(v, 2) for k, v in cap.stages_ms.items()})}, "
              f"{len(cap.spans)} spans, module lane from {cap.module_source}")
    assert list(cap.stages_ms) == ["synchronize", "stop", "export", "events", "source", "parse"]
    assert cap.module_source == "kernel_segments"
    assert {s.module_name for s in cap.launches()} == {"spec_multi_round"}
    exported = xla_spans.load_trace_file(cap.trace_path, include_ops=True,
                                         anchor_unix_ns=cap.anchor_unix_ns)

    def key(spans):
        return sorted((s.lane, s.name, s.launch_id, s.start_us, s.duration_us) for s in spans)

    got, want = key(cap.spans), key(exported)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert all(abs(g[3] - w[3]) < 1e-3 and abs(g[4] - w[4]) < 1e-3 for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_activity_alone_records_no_dispatch_range(cuda_device, tmp_path):
    """Why the capture keeps CPU activity: profiled with CUDA activity
    alone, a front-door step's trace holds its kernels but no
    ``record_function`` range, on the host or on the device, so no
    module lane can be read from it."""
    from torch.profiler import ProfilerActivity, profile

    from tpuslo_torch.otel import xla_spans

    target, draft = _spec_pair(cuda_device)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=2, rounds_per_step=2)
    fd.submit("cuda only", max_new_tokens=100, stop_at_eos=False)
    fd.step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.step()
        torch.cuda.synchronize()
    path = str(tmp_path / "cuda_only.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    cats = {e.get("cat") for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert "kernel" in cats
    assert not cats & {xla_spans.CAT_CPU_ANNOTATION, xla_spans.CAT_GPU_ANNOTATION}
    assert xla_spans.module_lane_source(doc) == "cpu_annotation"
    assert not [s for s in xla_spans.parse_trace_events(doc) if s.lane == xla_spans.MODULES_LANE]


@pytest.mark.cuda
def test_a_fill_of_warm_admissions_reads_once_and_never_synchronizes(cuda_device):
    """Four prefix requests on a warm snapshot admit one by one through
    their graph replays and read their first tokens once for the whole
    fill; under the benches' audit (PyTorch's sync debug mode) the fill
    makes no synchronizing call (the read is a pinned copy and an event).
    Each stream equals the one the same front door gives its request
    admitted alone (the per-stream engine prefills ``prefix + suffix`` as
    one sequence, which is other arithmetic: ROADMAP F8)."""
    from tpuslo_torch.analysis import jitaudit

    target, draft = _spec_pair(cuda_device)
    fd = frontdoor.FrontDoorEngine(target, draft, k=3, max_slots=4, rounds_per_step=2)
    prefix = "a shared system prompt "
    fd.submit("warm up", prefix=prefix, max_new_tokens=2, stop_at_eos=False)
    fd.run()
    users = [f"user {i}" for i in range(4)]
    ids = [fd.submit(u, prefix=prefix, max_new_tokens=12, stop_at_eos=False) for u in users]
    torch.cuda.synchronize()
    jitaudit.install()
    audit = jitaudit.registry()
    try:
        before = (audit.syncs, audit.host_reads)
        fd._fill_slots()
        torch.cuda.synchronize()
        assert (audit.syncs - before[0], audit.host_reads - before[1]) == (0, 1)
    finally:
        jitaudit.uninstall()
        audit.reset()
    assert all(fd._slots) and not fd._queue
    results = fd.run()
    for u, rid in zip(users, ids):
        alone = fd.submit(u, prefix=prefix, max_new_tokens=12, stop_at_eos=False)
        assert fd.run()[alone] == results[rid]


# --- the MoE family and the CUDA probe surface -------------------------


def _moe_cfg(dim: int = 512, ffn: int = 1024):
    from tpuslo_torch.ops import moe

    return moe.MoEConfig(dim=dim, ffn_dim=ffn, n_experts=4, top_k=2, capacity_factor=2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ffn", [(512, 1024), (2048, 5632)])
def test_the_moe_block_is_batch_invariant(cuda_device, dim, ffn):
    """Row r of the MoE block alone has the bits it has inside batches of
    2 to 200 rows (drop-free routing, bf16, mixtral_2b6's widths too)."""
    from tpuslo_torch.ops import moe

    cfg = _moe_cfg(dim, ffn)
    params = moe.init_moe_params(0, cfg, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    X = torch.randn((200, dim), generator=gen, device=cuda_device).bfloat16()
    for n in (2, 5, 8, 16, 40, 80, 200):
        y = moe.moe_mlp(params, X[:n], cfg)
        for r in (0, n // 2, n - 1):
            assert torch.equal(y[r], moe.moe_mlp(params, X[r:r + 1], cfg)[0]), (n, r)


@pytest.mark.cuda
def test_the_moe_block_on_the_card_matches_the_cpu(cuda_device):
    from tpuslo_torch.ops import moe

    cfg = _moe_cfg()
    params = moe.init_moe_params(0, cfg, device=cuda_device)
    x = torch.randn((64, cfg.dim), generator=torch.Generator().manual_seed(1)).bfloat16()
    got = moe.moe_mlp(params, x.to(cuda_device), cfg).float().cpu()
    want = moe.moe_mlp({k: v.cpu() for k, v in params.items()}, x, cfg).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_the_moe_paged_engine_reads_its_pool_through_k2(cuda_device):
    """On the card the MoE paged engine's steps launch K2 once per layer,
    and its streams equal the per-stream MoE engine's or leave them at a
    near-tie."""
    from tpuslo_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.mixtral_tiny(max_seq_len=256), dim=256, n_heads=2,
                              n_kv_heads=1)
    ref = mixtral.MoEServeEngine(cfg, rng_seed=3, device=cuda_device)
    engine = mixtral.MoEPagedBatchingEngine(cfg, params=ref.params, max_slots=3,
                                            block_size=64, device=cuda_device)
    assert engine.pallas_attention
    prompts = ["paged experts", "a second request", "and a third one"]
    ids = [engine.submit(p, 12, stop_at_eos=False) for p in prompts]
    k2 = paged_decode_attention.launches + paged_decode_attention.f32_launches
    engine.run()
    launched = paged_decode_attention.launches + paged_decode_attention.f32_launches - k2
    assert launched == engine.steps * cfg.n_layers
    for rid, prompt in zip(ids, prompts):
        want = [e.token_id for e in ref.generate(prompt, 12, stop_at_eos=False)]
        got = engine.results[rid]
        k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if k is not None:
            logits, _ = ref.prefill_ids(serve.encode_bytes(prompt, ref.generation_prompt_cap())
                                        + want[:k])
            top2 = torch.topk(logits[0].float(), 2).values
            assert float(top2[0] - top2[1]) < 2 * LOGIT_TOL, (k, got, want)


@pytest.mark.cuda
def test_find_libcuda_returns_the_library_this_process_maps(cuda_device):
    from tpuslo_torch.collector import symbols

    torch.ones(1, device=cuda_device)  # CUDA is initialised in this process
    path = symbols.find_libcuda(env={})
    assert path and "libcuda.so" in path
    with open("/proc/self/maps", encoding="utf-8") as fh:
        mapped = {line.split()[-1] for line in fh if len(line.split()) >= 6}
    assert path in mapped
    assert symbols.resolve_elf_symbol(path, ["cuMemAlloc_v2"]).name == "cuMemAlloc_v2"
