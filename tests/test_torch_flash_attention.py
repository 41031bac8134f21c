"""Flash attention: the port's plain path against the Pallas kernel.

On the CPU, ``tpuslo_torch.ops.flash_attention.flash_attention`` runs its
plain PyTorch version; it is held to
``tpuslo.ops.flash_attention.flash_attention(..., interpret=True)`` on the
same numpy inputs, mirroring the forward cases of
``tests/test_flash_attention.py``.  Tolerances: 2e-5 in f32 (both sides
compute the same f32 math in another summation order), 3e-2 in bf16
(bf16 inputs, f32 math, outputs rounded to bf16 on both sides).

The CUDA kernel itself runs only on the card: ``tests/test_torch_card.py``
holds it to the plain version there and skips elsewhere.
"""

from __future__ import annotations

import stat

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.ops import flash_attention as jfa  # noqa: E402
from tpuslo_torch.ops import _build  # noqa: E402
from tpuslo_torch.ops import flash_attention as tfa_fn  # noqa: E402
from tpuslo_torch.ops.flash_attention import (  # noqa: E402
    _check_kernel_inputs,
    flash_attention_reference,
    flash_eligible,
)

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(seed: int, B: int, S: int, H: int, KV: int, D: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal=True, dtype=torch.float32):
    out = tfa_fn(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal
    )
    assert out.dtype == dtype
    return out.float().numpy()


def _pallas(q, k, v, causal=True, dtype=jnp.float32, **blocks):
    out = jfa.flash_attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)),
        causal=causal, interpret=True, **blocks,
    )
    return np.asarray(out, np.float32)


def test_matches_pallas_f32():
    q, k, v = _qkv(0, 2, 256, 4, 2, 128)
    err = np.abs(_port(q, k, v) - _pallas(q, k, v)).max()
    assert err < F32_TOL


def test_matches_pallas_bf16():
    q, k, v = _qkv(1, 1, 256, 4, 4, 128)
    port = _port(q, k, v, dtype=torch.bfloat16)
    pallas = _pallas(q, k, v, dtype=jnp.bfloat16)
    assert np.abs(port - pallas).max() < BF16_TOL
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v)]
    exact = _port(*bf)  # f32 math on the bf16-rounded inputs
    assert np.abs(port - exact).max() < BF16_TOL


def test_uneven_pallas_blocks_cover_sequence():
    """The Pallas kernel at block_k != block_q (its last-relevant-k
    epilogue bookkeeping) computes the function the port computes."""
    q, k, v = _qkv(2, 1, 512, 2, 2, 128)
    err = np.abs(_port(q, k, v) - _pallas(q, k, v, block_q=128, block_k=256)).max()
    assert err < F32_TOL


def test_gqa_head_mapping():
    """Each q-head group must attend to ITS kv head: make the kv heads
    wildly different."""
    q, k, v = _qkv(3, 1, 128, 8, 2, 128)
    k[:, :, 1] *= 10.0
    v[:, :, 1] += 5.0
    err = np.abs(_port(q, k, v) - _pallas(q, k, v)).max()
    assert err < 2e-4


def test_causality_strict():
    """Changing future k/v rows must not change earlier outputs."""
    q, k, v = _qkv(4, 1, 256, 2, 2, 128)
    out1 = _port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, 200:] = 99.0
    v2[:, 200:] = -99.0
    out2 = _port(q, k2, v2)
    np.testing.assert_allclose(out1[:, :200], out2[:, :200], atol=1e-5, rtol=0)
    assert not np.allclose(out1[:, 200:], out2[:, 200:], atol=1e-2)


def test_non_causal_matches_pallas():
    q, k, v = _qkv(5, 1, 256, 4, 2, 128)
    err = np.abs(_port(q, k, v, causal=False) - _pallas(q, k, v, causal=False)).max()
    assert err < F32_TOL


@pytest.mark.parametrize(
    "shape,kv",
    [
        ((2, 256, 4, 128), 2),
        ((2, 200, 4, 128), 2),  # ragged seq
        ((2, 256, 4, 64), 2),  # sub-lane head dim
        ((2, 256, 3, 128), 2),  # H % KV != 0
        ((2, 128, 24, 128), 8),  # llama32_3b at the 128 bucket
        ((256, 4, 128), 2),  # wrong rank
    ],
)
def test_eligibility_gate_matches_jax(shape, kv):
    assert flash_eligible(shape, kv) == jfa.flash_eligible(shape, kv)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 128, 4, 2, 128))
    before = tfa_fn.launches
    out = tfa_fn(q, k, v)
    assert tfa_fn.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, flash_attention_reference(q, k, v, True))


def _valid_bf16():
    return (
        torch.zeros(1, 128, 4, 128, dtype=torch.bfloat16),
        torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16),
        torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16),
    )


@pytest.mark.parametrize(
    "case", ["f32", "head_dim_64", "ragged_seq", "inner_stride", "kv_shape"]
)
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take is refused before launch."""
    q, k, v = _valid_bf16()
    _check_kernel_inputs(q, k, v)
    if case == "f32":
        q = q.float()
    elif case == "head_dim_64":
        q, k, v = (t[..., :64].contiguous() for t in (q, k, v))
    elif case == "ragged_seq":
        q, k, v = q[:, :100], k[:, :100], v[:, :100]
    elif case == "inner_stride":
        q = torch.zeros(1, 128, 4, 256, dtype=torch.bfloat16)[..., ::2]
    else:
        k = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        _check_kernel_inputs(q, k, v)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as an exception with its output; no
    library is left behind for a later load to pick up."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build("flash_attention")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    # Writes the -o target and reports like ptxas -v.
    fake.write_text(
        "#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
        "touch \"$2\"; fi; shift; done\necho 'Used 8 registers' >&2\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    first = _build.build("flash_attention")
    again = _build.build("flash_attention")
    assert first.path == again.path and first.path.exists()
    assert again.seconds == 0.0 and "Used 8 registers" in again.ptxas
    assert first.path.parent.name.startswith("flash_attention-")
