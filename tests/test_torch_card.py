"""Card-only tests of the port: the CUDA kernel and the engine on a GPU.

They import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_card.py

Without a CUDA device every test skips (the kernel has no CPU mode); the
decision is taken inside a fixture, never at import.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tpuslo_torch.models import llama, serve  # noqa: E402
from tpuslo_torch.ops import flash_attention  # noqa: E402
from tpuslo_torch.ops.flash_attention import flash_attention_reference  # noqa: E402

# bf16 output rounding and bf16 p in p.v (see the kernel's source note);
# the JAX package's own bf16 kernel test uses the same bound.
KERNEL_TOL = 3e-2
# The same roundings relative to each output row's RMS: ~2^-6 by a CPU
# model of the kernel's arithmetic; a dropped key tile is ~1 or more.
KERNEL_ROW_TOL = 2.0**-5
# Card vs CPU bf16 logits: other summation order and kernel vs plain
# attention; 4 bf16 ulps at |logit| in [4, 8).
LOGIT_TOL = 0.125


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
@pytest.mark.parametrize("B,S,H,KV,causal", [
    (1, 128, 24, 8, True),
    (4, 128, 24, 8, True),
    (4, 256, 24, 8, True),
    (1, 256, 24, 8, False),
    (2, 512, 4, 2, True),
])
def test_kernel_matches_plain(cuda_device, B, S, H, KV, causal):
    q, k, v = _qkv(7, B, S, H, KV, 128, cuda_device)
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
    """What the kernel does not take raises on the card; it is never
    served by the plain version."""
    q, k, v = _qkv(9, 1, 128, 4, 2, 128, cuda_device)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q[:, :100], k[:, :100], v[:, :100])
    assert flash_attention.launches == before


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
