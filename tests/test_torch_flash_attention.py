"""Flash attention: the port's plain path against the Pallas kernel.

On the CPU, ``tpuslo_torch.ops.flash_attention.flash_attention`` runs its
plain PyTorch version; it is held to
``tpuslo.ops.flash_attention.flash_attention(..., interpret=True)`` on the
same numpy inputs, mirroring the forward cases of
``tests/test_flash_attention.py``.  Tolerances: 2e-5 in f32 (both sides
compute the same f32 math in another summation order), 3e-2 in bf16
(bf16 inputs, f32 math, outputs rounded to bf16 on both sides).

The CUDA kernels themselves run only on the card:
``tests/test_torch_card.py`` holds them to the plain version there and
skips elsewhere.  Here: which kernel the wrapper routes a CUDA input to
(by dtype and head dim alone), and the JAX package's f32 head-dim-128
model on the port's plain path against JAX's logits.
"""

from __future__ import annotations

import importlib
import shutil
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

# The module (the package re-exports its function under the same name).
tfa = importlib.import_module("tpuslo_torch.ops.flash_attention")

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


def test_head_dim_256_is_eligible_in_both_gates_but_refused_by_the_cuda_kernel():
    """Both eligibility gates accept any head dim that is a multiple of
    128, and the JAX kernel computes at 256.  The wgmma kernel (K1) is
    instantiated for head dims 128 and 256: it takes 256 and refuses the
    next multiple, 384, before launch (on the card 384 routes to K1-f32;
    the card tests hold both to the plain version); on the CPU the plain
    version computes."""
    shape, kv = (1, 128, 2, 256), 1
    assert flash_eligible(shape, kv) is True
    assert jfa.flash_eligible(shape, kv) is True
    q = torch.zeros(*shape, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 128, kv, 256, dtype=torch.bfloat16)
    _check_kernel_inputs(q, k, v)
    wide = torch.zeros(1, 128, 2, 384, dtype=torch.bfloat16)
    assert flash_eligible(tuple(wide.shape), kv) is True
    with pytest.raises(ValueError, match=r"built for head dims \(128, 256\), got 384"):
        _check_kernel_inputs(wide, wide[:, :, :1], wide[:, :, :1])
    assert tfa_fn(q, k, v).shape == q.shape  # CPU tensors: the plain version
    qj, kj, vj = (a.astype(np.float32) for a in _qkv(9, 1, 128, 2, 1, 256))
    assert np.isfinite(_pallas(qj, kj, vj, causal=True)).all()


@pytest.mark.parametrize(
    "shape,kv,takes",
    [
        ((1, 256, 4, 256), 4, True),  # the JAX gate's head dim 256
        ((2, 128, 2, 256), 1, True),
        ((2, 128, 24, 128), 8, True),  # llama32_3b at the 128 bucket
        ((1, 128, 2, 384), 1, False),  # flash-eligible, not instantiated
        ((1, 128, 2, 512), 2, False),
    ],
)
def test_cuda_kernel_takes_the_instantiated_head_dims(shape, kv, takes):
    """Every shape here passes both gates; the wgmma kernel's input check
    takes head dims 128 and 256 and refuses the rest before launch (a
    CUDA tensor at those head dims routes to K1-f32; it never runs the
    plain version)."""
    assert flash_eligible(shape, kv) is jfa.flash_eligible(shape, kv) is True
    B, S, H, D = shape
    q = torch.zeros(*shape, dtype=torch.bfloat16)
    k = v = torch.zeros(B, S, kv, D, dtype=torch.bfloat16)
    if takes:
        _check_kernel_inputs(q, k, v)
    else:
        with pytest.raises(ValueError, match="built for head dims"):
            _check_kernel_inputs(q, k, v)


def test_plain_attention_at_head_dim_256_matches_pallas():
    """At head dim 256 the port's flash attention on the CPU (the plain
    version of the kernel) and the plain GQA attention under the causal
    mask both compute what the Pallas kernel computes."""
    from tpuslo_torch.models import llama as tl

    B, S, H, KV, D = 1, 256, 4, 2, 256
    q, k, v = _qkv(10, B, S, H, KV, D)
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    want = _pallas(q, k, v)
    port = tl.attention(*(torch.from_numpy(a) for a in (q, k, v)), mask, H // KV)
    assert np.abs(port.numpy() - want).max() < F32_TOL
    assert np.abs(_port(q, k, v) - want).max() < F32_TOL


@pytest.mark.parametrize("head_dim,launches", [(256, 1), (128, 1)])
def test_attention_block_routes_by_the_kernels_head_dim(monkeypatch, head_dim, launches):
    """A causal full-sequence block calls ``flash_attention`` at both
    head dims the kernel is built for (on the card a head dim it is not
    built for raises there), and equals the same block through the plain
    attention."""
    import dataclasses

    from tpuslo_torch.models import llama as tl

    torch.set_num_threads(1)
    cfg = dataclasses.replace(
        tl.llama_tiny(max_seq_len=128), dim=2 * head_dim, n_heads=2, n_kv_heads=1,
        dtype=torch.float32,
    )
    assert cfg.head_dim == head_dim
    params = tl.init_params(3, cfg, "cpu")
    layer = tl._layer(params, 0)
    S = 128
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(1, S, cfg.dim, generator=gen)
    cos, sin = tl.rope_frequencies(cfg, torch.arange(S)[None])
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    calls = []
    real = tl.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tl, "flash_attention", counted)
    out, _ = tl.attention_block(cfg, h, layer, cos, sin, mask, causal=True)
    assert len(calls) == launches
    plain, _ = tl.attention_block(cfg, h, layer, cos, sin, mask, causal=False)
    assert (out - plain).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtypes,head_dim,route", [
    ((torch.bfloat16,) * 3, 128, "wgmma"),
    ((torch.bfloat16,) * 3, 256, "wgmma"),
    ((torch.float32,) * 3, 128, "f32"),
    ((torch.float32,) * 3, 256, "f32"),
    ((torch.float16,) * 3, 128, "f32"),
    ((torch.bfloat16,) * 3, 384, "f32"),
    ((torch.bfloat16,) * 3, 512, "f32"),
    ((torch.float32,) * 3, 512, "f32"),
    ((torch.float32, torch.bfloat16, torch.bfloat16), 128, "f32"),
    ((torch.bfloat16,) * 3, 640, "head dim 640"),
    ((torch.float32,) * 3, 1024, "head dim 1024"),
    ((torch.float64,) * 3, 128, "f32, bf16 or f16"),
    ((torch.bfloat16,) * 3, 64, "K1-f32 takes"),
])
def test_kernel_route_by_dtype_and_head_dim(dtypes, head_dim, route):
    """K1 serves bf16 at the head dims it is built for, K1-f32 every other
    shape the JAX gate admits up to head dim 512; past that, or for a
    dtype neither reads, the choice raises, naming why (a choice on
    shapes alone, made before any launch)."""
    if route in ("wgmma", "f32"):
        assert tfa.kernel_route(dtypes, head_dim) == route
    else:
        with pytest.raises(ValueError, match=route):
            tfa.kernel_route(dtypes, head_dim)


def test_f32_check_refuses_what_no_kernel_reads():
    """The shape checks both kernels share raise before any routing."""
    q = torch.zeros(1, 128, 4, 256)[..., ::2]  # inner stride 2
    k = v = torch.zeros(1, 128, 2, 128)
    with pytest.raises(ValueError, match="unit inner stride"):
        tfa._check_shapes(q, k, v)
    with pytest.raises(ValueError, match="flash-eligible"):
        tfa._check_shapes(*(t[:, :100] for t in (torch.zeros(1, 128, 4, 128), k, v)))


@pytest.mark.parametrize("case,copied", [
    ("contiguous", False),
    ("head_slice", False),  # q[:, :, ::2]: strides stay multiples of 4
    ("odd_offset", True),  # starts one element in: not 16-byte aligned
    ("odd_row_stride", True),  # rows 130 elements apart
])
def test_f32_kernel_reads_aligned_rows_in_place(case, copied):
    """K1-f32 reads rows four elements at a time: a tensor it can read
    that way is passed as it is, any other as an equal contiguous copy."""
    base = torch.arange(2 * 128 * 4 * 130, dtype=torch.float32).reshape(2, 128, 4, 130)
    t = {
        "contiguous": base[..., :128].contiguous(),
        "head_slice": base[..., :128].contiguous()[:, :, ::2],
        "odd_offset": base.reshape(-1)[1:1 + 2 * 128 * 4 * 128].reshape(2, 128, 4, 128),
        "odd_row_stride": base[..., :128],
    }[case]
    got = tfa._vector_rows(t)
    assert (got is not t) is copied
    assert torch.equal(got, t)
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0


def test_jax_f32_model_on_the_plain_path_matches_jax(monkeypatch):
    """The JAX package's f32 head-dim-128 model
    (``tests/test_flash_attention.py::TestModelIntegration``), same weights
    through numpy: the port's forward on the CPU (its flash-eligible
    attention through the plain version of K1-f32's arithmetic) against
    the JAX forward with the Pallas kernel in interpret mode, 1e-4."""
    import dataclasses

    import jax

    from tpuslo.models import llama as jl
    from tpuslo_torch.models import bridge
    from tpuslo_torch.models import llama as tl

    kw = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
              ffn_dim=512, max_seq_len=128)
    cj = dataclasses.replace(jl.LlamaConfig(**kw), dtype=jnp.float32)
    ct = dataclasses.replace(tl.LlamaConfig(**kw), dtype=torch.float32)
    assert ct.head_dim == 128
    pj = jl.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (2, 128))
    monkeypatch.setenv("TPUSLO_FLASH_ATTENTION", "1")
    want = np.asarray(jl.forward(pj, jnp.asarray(tokens), cj), np.float32)
    calls = []
    real = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    got = tl.forward(pt, torch.from_numpy(tokens), ct)
    assert calls == [torch.float32] * ct.n_layers
    assert tfa.kernel_route(calls[:1] * 3, ct.head_dim) == "f32"
    assert np.abs(got.numpy() - want).max() < 1e-4


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


def test_header_edit_changes_the_build_directory(tmp_path, monkeypatch):
    """A build depends on the shared headers too: editing one under
    ``csrc/`` gives a new build directory (and a new nvcc run), never the
    stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
        "touch \"$2\"; fi; shift; done\necho built >> \"$(dirname \"$0\")/runs\"\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    first = _build.build("paged_attention")
    assert _build.build("paged_attention").path == first.path
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    second = _build.build("paged_attention")
    assert second.path.parent != first.path.parent
    assert second.path.exists() and second.seconds > 0.0
    assert (tmp_path / "runs").read_text().count("built") == 2
