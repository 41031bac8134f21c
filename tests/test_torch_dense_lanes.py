"""The dense KV cache read as K2's lanes (``tpuslo_torch.ops.dense_lanes``),
on the CPU.

On the card the decode, verify and draft passes attend over the dense
cache through K2, one lane per query: the layer's cache side is a pool of
``B * T / BS`` blocks, a lane's page-table row holds its batch row's blocks
and its length is the query's position.  On the CPU the same call runs
K2's plain version (``paged_decode_attention_reference``), which these
tests hold to:

* ``llama.attention`` over the dense cache under the causal mask the
  passes build, at the positions decode (an int, a ``(B,)`` and a 0-d
  length) and verify (chunks of 1 and 5, per-row frontiers, a frontier
  near the cache end, inactive rows) give, over bf16, f32 and int8 caches,
  head dims 16, 64 and 128 and caches of 128, 160, 192 and 2048 positions:
  within 1e-5 in f32, K2's 2e-2 in bf16 (the plain attention rounds the
  softmax weights to bf16 and an int8 cache's dequantized values to the
  model dtype; K2 keeps both in f32);
* the Pallas kernel ``tpuslo.ops.paged_attention.paged_decode_attention``
  in interpret mode on the same numpy inputs (the lane formulation
  against the JAX package), within the same bounds;
* the page-table and lengths functions, and the fixed-shape ``_matmul``
  against ``torch.matmul``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.ops import paged_attention as jpa  # noqa: E402
from tpuslo_torch.models import kv_cache as kvc  # noqa: E402
from tpuslo_torch.models import llama  # noqa: E402
from tpuslo_torch.ops import dense_lanes as dl  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# How a pass sets its queries' positions (B rows, K queries each, a cache
# of T positions): decode with one int length, per-row lengths or a 0-d
# frontier; verify chunks of 1 and of 5 from per-row frontiers, one of
# them within K of the cache end, and with a row parked at position 0 (an
# inactive front-door slot keeps decoding from its frozen frontier).
KINDS = ("decode-int", "decode-rows", "decode-0d", "verify-1", "verify-5",
         "verify-5-end", "verify-5-inactive")
GEOMETRIES = ((16, 4, 2, 128), (64, 8, 2, 160), (128, 6, 2, 192), (64, 8, 2, 2048))
CACHES = ("f32", "bf16", "int8")


def _positions(kind: str, B: int, T: int, rng) -> torch.Tensor:
    """(B, K) positions of one pass, as decode_step / verify_chunk build
    them from the cache's length."""
    if kind == "decode-int":
        return torch.full((B, 1), int(rng.integers(0, T)))
    if kind == "decode-rows":
        return torch.from_numpy(rng.integers(0, T, size=(B, 1)))
    if kind == "decode-0d":
        return torch.tensor(int(rng.integers(0, T))).expand(B)[:, None]
    K = 1 if kind == "verify-1" else 5
    start = torch.from_numpy(rng.integers(0, T - K, size=(B,)))
    if kind == "verify-5-end":
        start[0] = T - 2  # positions T-2 .. T+2: past the end, every position stays visible
    if kind == "verify-5-inactive":
        start[-1] = 0
    return start[:, None] + torch.arange(K)[None, :]


def _inputs(cache: str, HD: int, H: int, KV: int, T: int, kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    B = 3
    pos = _positions(kind, B, T, rng)
    K = pos.shape[1]
    q = rng.standard_normal((B, K, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    dtype = torch.float32 if cache == "f32" else torch.bfloat16
    return q, k, v, pos, dtype


def _sides(k, v, cache: str, dtype):
    kt, vt = torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype)
    if cache == "int8":
        return kvc.quantize_kv(kt.float()), kvc.quantize_kv(vt.float())
    return kt, vt


@pytest.mark.parametrize("HD,H,KV,T", GEOMETRIES, ids=lambda g: str(g))
@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("kind", KINDS)
def test_lanes_equal_the_plain_attention_over_the_cache(kind, cache, HD, H, KV, T):
    q, k, v, pos, dtype = _inputs(cache, HD, H, KV, T, kind)
    qt = torch.from_numpy(q).to(dtype)
    k_side, v_side = _sides(k, v, cache, dtype)
    got = dl.dense_lane_attention(qt, k_side, v_side, pos)
    mask = torch.arange(T)[None, None, :] <= pos[:, :, None]
    want = llama.attention(qt, kvc.kv_load(k_side, dtype), kvc.kv_load(v_side, dtype), mask,
                           H // KV)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("HD,H,KV,T", GEOMETRIES[:3], ids=lambda g: str(g))
@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("kind", ("decode-rows", "verify-5", "verify-5-end"))
def test_lanes_equal_the_pallas_kernel(kind, cache, HD, H, KV, T):
    """The lane formulation against JAX's K2 in interpret mode: the same
    pool view, table and lengths, as numpy."""
    q, k, v, pos, dtype = _inputs(cache, HD, H, KV, T, kind, seed=1)
    qt = torch.from_numpy(q).to(dtype)
    k_side, v_side = _sides(k, v, cache, dtype)
    got = dl.dense_lane_attention(qt, k_side, v_side, pos)
    B, K = pos.shape
    BS = dl.lane_block_size(T)
    table = dl.lane_table(B, K, T, BS, torch.device("cpu")).numpy()
    lengths = dl.lane_lengths(pos, T).numpy()

    def to_jax(side):
        pool = dl.pool_view(side, BS)
        if isinstance(pool, dict):
            return {n: jnp.asarray(t.numpy()) for n, t in pool.items()}
        return jnp.asarray(pool.float().numpy()).astype(
            jnp.float32 if dtype == torch.float32 else jnp.bfloat16)

    jq = jnp.asarray(qt.float().numpy().reshape(B * K, H, HD)).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    want = jpa.paged_decode_attention(
        jq, to_jax(k_side), to_jax(v_side), jnp.asarray(table), jnp.asarray(lengths),
        block_size=BS, out_dtype=jnp.float32, interpret=True,
    )
    np.testing.assert_allclose(got.float().numpy().reshape(B * K, H, HD),
                               np.asarray(want, np.float32), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("T,BS", [(128, 128), (160, 160), (192, 192), (1024, 1024),
                                  (2048, 1024), (3000, 1000), (4096, 1024), (1031, 1)])
def test_block_size_is_the_fewest_equal_blocks(T, BS):
    assert dl.lane_block_size(T) == BS


@pytest.mark.parametrize("B,K,T", [(1, 1, 192), (1, 5, 192), (2, 5, 2048), (8, 5, 2048),
                                   (16, 5, 192), (3, 1, 160)])
def test_table_and_lengths(B, K, T):
    BS = dl.lane_block_size(T)
    nb = T // BS
    table = dl.lane_table(B, K, T, BS, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (B * K, nb) and table.is_contiguous()
    want = np.repeat(np.arange(B), K)[:, None] * nb + np.arange(nb)[None, :]
    np.testing.assert_array_equal(table.numpy(), want)
    assert dl.lane_table(B, K, T, BS, torch.device("cpu")) is table  # built once per shape
    pos = torch.arange(B * K).reshape(B, K) * 97 % (T + 7)
    lengths = dl.lane_lengths(pos, T)
    assert lengths.dtype == torch.int32 and lengths.shape == (B * K,)
    np.testing.assert_array_equal(lengths.numpy(), np.minimum(pos.reshape(-1).numpy(), T - 1))


def test_pool_view_is_a_view_of_the_cache():
    cache = llama.init_kv_cache(llama.llama_tiny(max_seq_len=2048), 2, kv_dtype="int8",
                                device="cpu")
    side = {n: t[1] for n, t in cache["k"].items()}  # layer 1, (B, T, KV, HD)
    pool = dl.pool_view(side, 1024)
    assert pool["q"].shape == (4, 1024, 2, 16) and pool["s"].shape == (4, 1024, 2)
    pool["q"][3, 5, 1, 0] = 7
    assert side["q"][1, 1024 + 5, 1, 0] == 7


@pytest.mark.parametrize("rows", [1, 5, 40, 128, 129, 300])
@pytest.mark.parametrize("int8", [False, True])
def test_fixed_shape_matmul_equals_one_product(rows, int8):
    """The card's weight products (pieces of ``GEMM_ROWS`` rows, the last
    zero-padded), run on CPU tensors: the values of one product, in the
    input's leading shape."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    wq = llama._quantize_leaf(w) if int8 else w
    want = llama._matmul(x, wq)
    np.testing.assert_allclose(llama._matmul_fixed(x, wq).numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    got = llama._matmul_fixed(x.reshape(1, rows, 64), wq)
    assert got.shape == (1, rows, 48)
    np.testing.assert_array_equal(got[0].numpy(), llama._matmul_fixed(x, wq).numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_per_row_matmul_equals_one_product(int8):
    """The card's full-sequence weight products (one per batch row, at a
    lone prefill's shape), run on CPU tensors: the values of one product
    over the whole batch, in its shape."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 7, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    wq = llama._quantize_leaf(w) if int8 else w
    want = llama._seq_matmul(x, wq)
    got = llama._matmul_rows(x, wq)
    assert got.shape == (3, 7, 48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    for b in range(3):
        np.testing.assert_array_equal(got[b:b + 1].numpy(),
                                      llama._seq_matmul(x[b:b + 1], wq).numpy())
