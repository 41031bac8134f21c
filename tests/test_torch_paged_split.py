"""K2's split over pool blocks, on the CPU: the split plan, and the plain
PyTorch model of the kernel's split-then-combine arithmetic
(``paged_decode_attention_split``) against the kernel's plain version and
the Pallas kernel in interpret mode.

Tolerance: 1e-5 absolute and relative in f32.  All three sides compute
in f32 from the same numpy inputs; they differ only in the order of the
sums and in the extra rescale of the combine (a few f32 ulps of outputs
near 1).  A span read twice, dropped or weighted wrongly moves an output
by O(0.1).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import kv_cache as jkv  # noqa: E402
from tpuslo.ops import paged_attention as jpa  # noqa: E402
from tpuslo_torch.ops import paged_attention as tpa  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bs,mb,want", [
    (64, 32, (1, 1, 64, 32)),   # the paged phase: one pool block per span
    (16, 6, (4, 1, 16, 2)),     # four whole blocks per span
    (8, 4, (8, 1, 8, 1)),
    (48, 5, (1, 1, 48, 5)),     # 64 // 48 = 1 block, 48 positions
    (1, 130, (64, 1, 1, 3)),
    (100, 3, (1, 2, 64, 6)),    # chunks of 64 and 36 positions
    (1024, 2, (1, 16, 64, 32)),
])
def test_split_plan_from_shapes(bs, mb, want):
    plan = tpa.split_plan(8, 8, 3, 128, bs, mb)
    got = (plan.blocks_per_split, plan.chunks_per_block, plan.chunk, plan.n_split)
    assert got == want
    assert plan.scratch_shape == (8, 8, plan.n_split, 3, 130)


@pytest.mark.parametrize("bs", [1, 7, 8, 48, 64, 65, 100, 1024])
def test_split_plan_covers_every_position_once(bs):
    """Every logical position lies in exactly one span, no span holds
    more than SPAN positions, and every span index is used."""
    mb = 5
    plan = tpa.split_plan(1, 1, 1, 64, bs, mb)
    which = tpa._split_of_position(plan, bs, mb * bs)
    counts = torch.bincount(which, minlength=plan.n_split)
    assert counts.numel() == plan.n_split
    assert int(counts.min()) >= 1 and int(counts.max()) <= tpa.SPAN


@pytest.mark.parametrize("bs,mb", [(0, 4), (1025, 1), (64, 0), (1024, 4096)])
def test_split_plan_refuses_what_the_kernel_is_not_built_for(bs, mb):
    with pytest.raises(ValueError):
        tpa.split_plan(1, 1, 1, 64, bs, mb)


def _inputs(seed, B, MB, N, BS, KV=2, n_rep=3, HD=16, quantized=False):
    """Random numpy q, pools and a table where lane b owns distinct
    blocks 1.. of the pool (0 is the null block)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV * n_rep, HD)).astype(np.float32)
    k = rng.standard_normal((N, BS, KV, HD)).astype(np.float32)
    v = rng.standard_normal((N, BS, KV, HD)).astype(np.float32)
    if quantized:
        k = {n: np.asarray(a) for n, a in jkv.quantize_kv(jnp.asarray(k)).items()}
        v = {n: np.asarray(a) for n, a in jkv.quantize_kv(jnp.asarray(v)).items()}
    table = (1 + rng.permutation(N - 1)[: B * MB].reshape(B, MB)).astype(np.int32)
    return q, k, v, table


def _torch(x):
    if isinstance(x, dict):
        return {n: torch.from_numpy(np.array(a)) for n, a in x.items()}
    return torch.from_numpy(np.array(x))


def _jax(x):
    return {n: jnp.asarray(a) for n, a in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _model(q, k, v, table, lens, bs):
    return tpa.paged_decode_attention_split(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=bs
    ).numpy()


def _reference(q, k, v, table, lens, bs):
    return tpa.paged_decode_attention_reference(
        _torch(q), _torch(k), _torch(v), _torch(table), _torch(lens), block_size=bs
    ).numpy()


def _pallas(q, k, v, table, lens, bs):
    return np.asarray(jpa.paged_decode_attention(
        _jax(q), _jax(k), _jax(v), _jax(table), _jax(lens),
        block_size=bs, interpret=True,
    ))


def _hold(q, k, v, table, lens, bs):
    got = _model(q, k, v, table, lens, bs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _reference(q, k, v, table, lens, bs), **TOL)
    np.testing.assert_allclose(got, _pallas(q, k, v, table, lens, bs), **TOL)
    return got


@pytest.mark.parametrize("bs,mb", [(64, 3), (128, 2), (8, 12)],
                         ids=["block-span", "chunked-block", "multi-block-span"])
def test_lengths_at_and_past_a_span_boundary(bs, mb):
    """Length 63 fills the first span exactly (the next one does not
    run); 64 puts one position in the next span; 127/128 likewise at the
    second boundary."""
    q, k, v, table = _inputs(0, 4, mb, 4 * mb + 1, bs)
    lens = np.asarray([63, 64, 127, 128], np.int32)
    _hold(q, k, v, table, lens, bs)


def test_empty_span_contributes_nothing():
    """A middle block whose table entry lies outside the pool leaves its
    span with max -inf and sum 0: the lane equals the same lane with that
    block taken out (attention does not depend on the order of keys)."""
    bs = 64
    q, k, v, table = _inputs(1, 2, 3, 8, bs)
    lens = np.asarray([2 * bs + 20, 2 * bs + 20], np.int32)
    holed = table.copy()
    holed[0, 1] = 8  # == N: outside [0, N)
    holed[1, 1] = -3
    got = _model(q, k, v, holed, lens, bs)
    assert np.isfinite(got).all()
    closed = np.stack([table[:, 0], table[:, 2], np.zeros(2, np.int32)], axis=1)
    want = _reference(q, k, v, closed, lens - bs, bs)
    np.testing.assert_allclose(got, want, **TOL)


def test_lane_with_every_entry_out_of_range_returns_zeros():
    bs = 16
    q, k, v, table = _inputs(2, 3, 5, 16, bs)
    lens = np.asarray([70, 33, 79], np.int32)
    bad = table.copy()
    bad[1] = [16, 17, -1, 99, 1 << 20]
    got = _model(q, k, v, bad, lens, bs)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    keep = [0, 2]
    np.testing.assert_allclose(
        got[keep], _reference(q[keep], k, v, table[keep], lens[keep], bs), **TOL
    )


def test_parked_lane_past_the_table_reads_the_null_block():
    """A released lane: zeroed table, length past MB * BS; every block
    stays visible and reads block 0."""
    bs = 64
    q, k, v, table = _inputs(3, 3, 3, 10, bs)
    table[2] = 0
    lens = np.asarray([100, 3 * bs - 1, 3 * bs + 37], np.int32)
    _hold(q, k, v, table, lens, bs)


def test_shared_blocks_are_read_by_both_lanes():
    bs = 16
    q, k, v, table = _inputs(4, 3, 6, 19, bs)
    table[1, :3] = table[0, :3]
    q[1] = q[0]
    lens = np.asarray([45, 45, 90], np.int32)
    got = _hold(q, k, v, table, lens, bs)
    np.testing.assert_allclose(got[0], got[1], atol=1e-6)


@pytest.mark.parametrize("bs,mb", [(64, 3), (16, 6)])
def test_int8_pools(bs, mb):
    q, k, v, table = _inputs(5, 3, mb, 3 * mb + 2, bs, n_rep=2, quantized=True)
    table[2] = 0
    lens = np.asarray([bs * mb - 1, bs + 3, bs * mb + 9], np.int32)
    _hold(q, k, v, table, lens, bs)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_model_respects_out_dtype(out_dtype):
    q, k, v, table = _inputs(6, 2, 2, 5, 8)
    got = tpa.paged_decode_attention_split(
        _torch(q), _torch(k), _torch(v), _torch(table),
        _torch(np.asarray([5, 12], np.int32)), block_size=8, out_dtype=out_dtype,
    )
    assert got.dtype == out_dtype and got.shape == (2, 6, 16)
