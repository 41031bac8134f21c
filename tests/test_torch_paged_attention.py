"""Paged decode attention (K2): ``tpuslo_torch.ops.paged_attention`` against
the JAX package.

On the CPU the port's ``paged_decode_attention`` is its plain version,
``paged_decode_attention_reference``; it is held to the Pallas kernel
``tpuslo.ops.paged_attention.paged_decode_attention`` in interpret mode
(the same kernel code a TPU runs) on the same numpy inputs, at the
geometry of ``tests/test_paged_attention_kernel.py``.  Tolerances are the
JAX test's: 2e-5 absolute / 1e-4 relative for f32 pools (both sides
accumulate in f32, in another order), 5e-4 / 1e-3 for int8 pools.  The
plain physical-pool path (``pool_visibility_mask`` + ``_pool_attention``)
is held to JAX's too, the mask exactly.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import kv_cache as jkv  # noqa: E402
from tpuslo.models import paged_kv as jpk  # noqa: E402
from tpuslo.ops import paged_attention as jpa  # noqa: E402
from tpuslo_torch.models import paged_kv as tpk  # noqa: E402
from tpuslo_torch.ops import paged_attention as tpa  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=1e-4)
INT8_TOL = dict(atol=5e-4, rtol=1e-3)
BS = 8


def _setup(B=3, MB=4, N=10, KV=2, n_rep=2, HD=16, seed=0, quantized=False,
           lengths=None):
    """The JAX kernel test's geometry as numpy: lane b owns blocks
    ``1 + b*MB ..`` (mod N-1), the last lane is parked (zeroed table),
    lengths straddle block boundaries."""
    rng = np.random.RandomState(seed)
    H = KV * n_rep
    q = rng.randn(B, H, HD).astype(np.float32)
    k = rng.randn(N, BS, KV, HD).astype(np.float32)
    v = rng.randn(N, BS, KV, HD).astype(np.float32)
    if quantized:
        k = {n: np.asarray(a) for n, a in jkv.quantize_kv(jnp.asarray(k)).items()}
        v = {n: np.asarray(a) for n, a in jkv.quantize_kv(jnp.asarray(v)).items()}
    table = np.zeros((B, MB), np.int32)
    for b in range(B - 1):
        table[b] = np.arange(1 + b * MB, 1 + (b + 1) * MB) % (N - 1)
    lens = np.asarray(lengths if lengths is not None else [5, BS * 2 + 3, 7][:B], np.int32)
    return q, k, v, table, lens


def _jax(x):
    return {n: jnp.asarray(a) for n, a in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _torch(x):
    if isinstance(x, dict):
        return {n: torch.from_numpy(np.array(a)) for n, a in x.items()}
    return torch.from_numpy(np.array(x))


def _both(q, k, v, table, lens):
    want = jpa.paged_decode_attention(
        _jax(q), _jax(k), _jax(v), _jax(table), _jax(lens),
        block_size=BS, interpret=True,
    )
    got = tpa.paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=BS
    )
    return np.asarray(want), got.numpy()


def test_f32_pool_matches_pallas_interpret():
    before = tpa.paged_decode_attention.launches
    want, got = _both(*_setup())
    assert got.dtype == np.float32 and got.shape == (3, 4, 16)
    np.testing.assert_allclose(got[:2], want[:2], **F32_TOL)
    # The parked lane reads the null block: finite in both.
    assert np.isfinite(got[2]).all() and np.isfinite(want[2]).all()
    np.testing.assert_allclose(got[2], want[2], **F32_TOL)
    assert tpa.paged_decode_attention.launches == before  # CPU: no kernel


def test_int8_pool_matches_pallas_interpret():
    want, got = _both(*_setup(quantized=True))
    np.testing.assert_allclose(got, want, **INT8_TOL)


def test_blocks_past_length_change_nothing():
    """Poisoning every block but lane 0's first leaves lane 0 alone."""
    q, k, v, table, lens = _setup()
    clean = tpa.paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=BS
    )
    poison = k.copy()
    for n in range(poison.shape[0]):
        if n != table[0, 0]:
            poison[n] = 1e4
    dirty = tpa.paged_decode_attention(
        _torch(q), _torch(poison), _torch(v), _torch(table), _torch(lens), block_size=BS
    )
    np.testing.assert_allclose(dirty[0].numpy(), clean[0].numpy(), atol=1e-5)
    want, got = _both(q, poison, v, table, lens)
    np.testing.assert_allclose(got[0], want[0], **F32_TOL)


def test_lanes_sharing_blocks_match_pallas_interpret():
    """Two lanes whose tables point at the same physical prefix blocks
    (copy-on-write sharing), each with its own private tail."""
    q, k, v, table, lens = _setup(lengths=[BS * 2 + 5, BS * 3 + 1, 0])
    table[1, :2] = table[0, :2]
    want, got = _both(q, k, v, table, lens)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # The shared span gives the same scores on both lanes: with one
    # query and one length, the two lanes' outputs coincide.
    q[1] = q[0]
    same = tpa.paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(table),
        _torch(np.asarray([BS * 2 - 1, BS * 2 - 1, 0], np.int32)), block_size=BS,
    )
    np.testing.assert_allclose(same[0].numpy(), same[1].numpy(), atol=1e-6)


def test_length_past_the_table_keeps_every_block_visible():
    """A parked lane's length walks past MB * BS - 1: every block stays
    visible, as the Pallas kernel's relevant test and clamp give."""
    q, k, v, table, lens = _setup(lengths=[4 * BS + 9, 100, 4 * BS - 1])
    want, got = _both(q, k, v, table, lens)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_out_dtype_is_respected(out_dtype):
    q, k, v, table, lens = _setup()
    got = tpa.paged_decode_attention(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens),
        block_size=BS, out_dtype=out_dtype,
    )
    ref = tpa.paged_decode_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=BS
    )
    assert got.dtype == out_dtype
    assert torch.equal(got, ref.to(out_dtype))


def test_other_devices_raise():
    q, k, v, table, lens = _setup()
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_decode_attention(
            _torch(q).to("meta"), _torch(k), _torch(v), _torch(table),
            _torch(lens), block_size=BS,
        )
    with pytest.raises(ValueError, match="block_size"):
        tpa.paged_decode_attention(
            _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=4
        )


@pytest.mark.parametrize("case", ["random", "shared", "parked", "all_zero"])
def test_pool_visibility_mask_equals_jax(case):
    rng = np.random.RandomState(3)
    B, MB, N = 4, 5, 12
    # Each lane owns distinct blocks, as the allocator hands them out.
    table = np.stack([rng.permutation(np.arange(1, N))[:MB] for _ in range(B)])
    table = table.astype(np.int32)
    lens = rng.randint(0, MB * BS + 6, size=(B,)).astype(np.int32)
    if case == "shared":
        table[2, :3] = table[1, :3]
    if case == "parked":
        table[0] = 0
        table[3, 2:] = 0
    if case == "all_zero":
        table[:] = 0
    want = np.asarray(jpk.pool_visibility_mask(jnp.asarray(table), jnp.asarray(lens), N, BS))
    got = tpk.pool_visibility_mask(torch.from_numpy(table), torch.from_numpy(lens), N, BS)
    assert got.dtype == torch.bool and got.shape == (B, N * BS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_pool_attention_matches_jax(quantized):
    """The plain physical-pool path on the mask: f32 inputs (int8 pools
    dequantized to f32 first, as the JAX kernel test's reference does)."""
    q, k, v, table, lens = _setup(quantized=quantized)
    n = 10  # the pool's blocks
    jmask = jpk.pool_visibility_mask(jnp.asarray(table), jnp.asarray(lens), n, BS)
    want = jpk._pool_attention(
        jnp.asarray(q), jkv.kv_load(_jax(k), jnp.float32),
        jkv.kv_load(_jax(v), jnp.float32), jmask, 2,
    )
    tmask = tpk.pool_visibility_mask(torch.from_numpy(table), torch.from_numpy(lens), n, BS)
    from tpuslo_torch.models import kv_cache as tkv

    got = tpk._pool_attention(
        torch.from_numpy(q), tkv.kv_load(_torch(k), torch.float32),
        tkv.kv_load(_torch(v), torch.float32), tmask, 2,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # Live lanes: the kernel's plain version agrees with the pool path.
    ref = tpa.paged_decode_attention_reference(
        torch.from_numpy(q), _torch(k), _torch(v), torch.from_numpy(table),
        torch.from_numpy(lens), block_size=BS,
    )
    np.testing.assert_allclose(ref[:2].numpy(), got[:2].numpy(), **INT8_TOL)


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("q_dtype,pool_dtype,int8,head_dim,out_dtype,route", [
    (BF16, BF16, False, 128, None, "split"),
    (BF16, torch.int8, True, 128, None, "split"),
    (F32, F32, False, 128, None, "f32"),
    # The pairings below raised before K2-f32 took every input the
    # Pallas kernel takes; they are read as f32, as Pallas casts.
    (F32, BF16, False, 128, None, "f32"),
    (BF16, F32, False, 128, None, "f32"),
    (F32, torch.int8, True, 128, None, "f32"),
    (F16, F16, False, 128, None, "f32"),
    # Head dims K2 is not built for, and outputs it does not write.
    (BF16, BF16, False, 16, None, "f32"),  # llama_tiny
    (BF16, torch.int8, True, 32, None, "f32"),
    (F32, F32, False, 256, None, "f32"),
    (BF16, BF16, False, 64, F16, "f32"),
    (BF16, BF16, False, 64, F32, "split"),
    (F16, torch.int8, True, 16, BF16, "f32"),
    # What neither kernel is built for raises, naming it.
    (F32, F32, False, 96, None, "head dim 96"),
    (torch.float64, F32, False, 128, None, "float64 q"),
    (F32, torch.float64, False, 128, None, "float64 pool"),
    (F32, F32, False, 128, torch.float64, "float64 output"),
    (BF16, BF16, True, 128, None, "int8 codes"),
])
def test_kernel_route_by_dtype(q_dtype, pool_dtype, int8, head_dim, out_dtype, route):
    """K2 serves a bf16 q over bf16 or int8 pools at head dims 64 and 128
    with a bf16 or f32 output; K2-f32 every other f32, bf16 or f16 q over
    f32, bf16, f16 or int8 pools at head dims 16-256; anything else raises
    before launch (a choice on dtypes and head dim alone)."""
    if route in ("split", "f32"):
        assert tpa.kernel_route(q_dtype, pool_dtype, int8, head_dim, out_dtype) == route
    else:
        with pytest.raises(ValueError, match=route):
            tpa.kernel_route(q_dtype, pool_dtype, int8, head_dim, out_dtype)


@pytest.mark.parametrize("case,ok", [
    ("f32_hd128", True), ("f32_hd64", True), ("f32_q_bf16_pool", True),
    ("f32_hd96", False), ("f32_group5", False), ("f32_long_table", False),
    ("f32_hd16", True), ("f32_hd32", True), ("f32_hd256", True),
    ("f32_q_int8_pool", True), ("f16_q_f16_pool", True), ("bf16_hd16_f16_out", True),
    ("f32_hd16_misaligned_rows", False),
])
def test_kernel_input_checks_take_f32_pools(case, ok):
    """The input checks in front of both kernels take what K2-f32 is built
    for (every pairing of f32, bf16 and f16 q over f32, bf16, f16 or int8
    pools, head dims 16-256, groups of 1, 2, 3, 4 or 8) and raise, naming
    it, on what it is not: head dim 96, group 5, an int64 table, pool rows
    that are not 16-byte aligned."""
    HD = {"f32_hd64": 64, "f32_hd96": 96, "f32_hd16": 16, "f32_hd32": 32,
          "f32_hd256": 256, "bf16_hd16_f16_out": 16, "f32_hd16_misaligned_rows": 18}.get(case, 128)
    KV, n_rep = 2, 5 if case == "f32_group5" else 3
    q_dtype = {"f16_q_f16_pool": F16, "bf16_hd16_f16_out": BF16}.get(case, F32)
    q = torch.zeros(2, KV * n_rep, HD, dtype=q_dtype)
    pool_dtype = {"f32_q_bf16_pool": BF16, "f16_q_f16_pool": F16, "bf16_hd16_f16_out": BF16,
                  "f32_q_int8_pool": torch.int8}.get(case, F32)
    k = torch.zeros(6, 16, KV, HD, dtype=pool_dtype)
    if case == "f32_hd16_misaligned_rows":  # 16-element rows 18 elements apart
        k = k[..., :16]
        q = q[..., :16]
    scales = torch.ones(6, 16, KV) if pool_dtype == torch.int8 else None
    table = torch.zeros(2, 4, dtype=torch.int64 if case == "f32_long_table" else torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    out_dtype = F16 if case == "bf16_hd16_f16_out" else F32
    args = (q, k, scales, k, scales, table, lengths, 16, out_dtype)
    if ok:
        assert tpa._check_kernel_inputs(*args) == "f32"
    else:
        with pytest.raises(ValueError):
            tpa._check_kernel_inputs(*args)


@pytest.mark.parametrize("case", ["f32_q_int8_pool", "bf16_hd16", "f16"])
def test_f6_inputs_match_pallas_interpret(case):
    """The inputs the CUDA route refused before K2-f32 took them, through
    the plain version against the Pallas kernel in interpret mode: an f32
    q over int8 pools, bf16 q and pools at llama_tiny's head dim 16, and
    f16 q and pools.  Both sides cast to f32 (Pallas in the kernel, the
    plain version on its inputs): in f32 out, the f32 tolerance (int8's
    for int8 pools); in the inputs' dtype, half an output ulp more."""
    quantized = case == "f32_q_int8_pool"
    q, k, v, table, lens = _setup(quantized=quantized)
    dtype = {"bf16_hd16": (jnp.bfloat16, BF16), "f16": (jnp.float16, F16)}.get(case)
    jq, tq = _jax(q), _torch(q)
    jk, jv, tk, tv = _jax(k), _jax(v), _torch(k), _torch(v)
    if dtype:
        jq, jk, jv = (x.astype(dtype[0]) for x in (jq, jk, jv))
        tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype[1])
                      for x in (jq, jk, jv))
    tol = INT8_TOL if quantized else F32_TOL
    for out in ("f32", "input"):
        out_dtype = F32 if out == "f32" or not dtype else dtype[1]
        want = jpa.paged_decode_attention(
            jq, jk, jv, _jax(table), _jax(lens), block_size=BS, interpret=True,
            out_dtype=jnp.float32 if out == "f32" else None)
        got = tpa.paged_decode_attention(tq, tk, tv, _torch(table), _torch(lens),
                                         block_size=BS, out_dtype=F32 if out == "f32" else None)
        assert got.dtype == out_dtype
        want = np.asarray(want.astype(jnp.float32))
        # Each side rounds its f32 result once to the output type.
        half_ulp = {BF16: 2.0**-8, F16: 2.0**-11}.get(out_dtype, 0.0)
        bound = tol["atol"] + (tol["rtol"] + 2 * half_ulp) * np.abs(want)
        assert (np.abs(got.float().numpy() - want) <= bound).all()


def test_cpu_f32_pools_take_the_plain_path():
    q, k, v, table, lens = _setup(HD=64)
    before = (tpa.paged_decode_attention.launches, tpa.paged_decode_attention.f32_launches)
    out = tpa.paged_decode_attention(_torch(q), _torch(k), _torch(v), _torch(table),
                                     _torch(lens), block_size=BS)
    assert (tpa.paged_decode_attention.launches,
            tpa.paged_decode_attention.f32_launches) == before
    assert torch.equal(out, tpa.paged_decode_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=BS))
