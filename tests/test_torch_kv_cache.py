"""KV-cache parity: ``tpuslo_torch.models.kv_cache`` against the JAX
module on the same numpy inputs, for the dense and int8 representations.

The JAX functions return new arrays; the port writes in place.  Each
test hands both the same starting cache and compares the results.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import kv_cache as jkv  # noqa: E402
from tpuslo_torch.models import kv_cache as tkv  # noqa: E402

B, S, KV, HD = 2, 16, 2, 8
REPS = ("bf16", "int8")


def _rand(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_side(rep: str, dense: np.ndarray):
    """A JAX cache side holding ``dense`` (f32) in representation ``rep``."""
    if rep == "int8":
        return jkv.quantize_kv(jnp.asarray(dense))
    return jnp.asarray(dense)


def _torch_side(rep: str, dense: np.ndarray):
    if rep == "int8":
        return tkv.quantize_kv(torch.from_numpy(dense))
    return torch.from_numpy(dense.copy())


def _assert_same(jside, tside, atol: float = 0.0):
    if isinstance(jside, dict):
        np.testing.assert_array_equal(np.asarray(jside["q"]), tside["q"].numpy())
        np.testing.assert_allclose(
            np.asarray(jside["s"]), tside["s"].numpy(), rtol=1e-6, atol=0
        )
    else:
        np.testing.assert_allclose(
            np.asarray(jside, np.float32), tside.float().numpy(), rtol=0, atol=atol
        )


def test_quantize_kv_matches_and_rounds_half_to_even():
    x = _rand(0, (B, S, KV, HD))
    # One row with exact .5 quotients at scale 1: 63.5 -> 64, 2.5 -> 2,
    # -0.5 -> 0 under round-half-to-even.
    x[0, 0, 0] = [127.0, 63.5, -0.5, 2.5, 0.0, 1.5, -2.5, 3.0]
    jq = jkv.quantize_kv(jnp.asarray(x))
    tq = tkv.quantize_kv(torch.from_numpy(x))
    _assert_same(jq, tq)
    assert tq["q"][0, 0, 0].tolist() == [127, 64, 0, 2, 0, 2, -2, 3]


def test_quantize_zero_input_safe():
    qs = tkv.quantize_kv(torch.zeros((1, 4, 2, 8), dtype=torch.bfloat16))
    assert not torch.isnan(tkv.kv_load(qs)).any()


@pytest.mark.parametrize("rep", REPS)
def test_kv_load(rep):
    x = _rand(1, (B, S, KV, HD))
    jl = jkv.kv_load(_jax_side(rep, x), jnp.float32)
    tl = tkv.kv_load(_torch_side(rep, x), torch.float32)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("start", [0, 5, S - 4])
def test_kv_write_seq(rep, start):
    base = _rand(2, (B, S, KV, HD))
    new = _rand(3, (B, 4, KV, HD))
    jout = jkv.kv_write_seq(_jax_side(rep, base), jnp.asarray(new), start)
    tside = _torch_side(rep, base)
    tout = tkv.kv_write_seq(tside, torch.from_numpy(new), start)
    _assert_same(jout, tout)
    # In place: the returned side is the cache that was passed in.
    assert (tout["q"] if rep == "int8" else tout) is (
        tside["q"] if rep == "int8" else tside
    )


@pytest.mark.parametrize("rep", REPS)
def test_kv_write_seq_past_end_raises(rep):
    """``dynamic_update_slice`` would clamp the start backwards and
    overwrite earlier positions; the port refuses."""
    side = _torch_side(rep, _rand(4, (B, S, KV, HD)))
    before = tkv.kv_load(side, torch.float32).clone()
    with pytest.raises(ValueError, match="past the cache end"):
        tkv.kv_write_seq(side, torch.zeros((B, 4, KV, HD)), S - 3)
    assert torch.equal(tkv.kv_load(side, torch.float32), before)


@pytest.mark.parametrize("rep", REPS)
def test_kv_write_stacked(rep):
    L = 3
    base = _rand(5, (L, B, S, KV, HD))
    new = _rand(6, (L, B, 7, KV, HD))
    jout = jkv.kv_write_stacked(_jax_side(rep, base), jnp.asarray(new))
    tout = tkv.kv_write_stacked(_torch_side(rep, base), torch.from_numpy(new))
    _assert_same(jout, tout)


@pytest.mark.parametrize("rep", REPS)
def test_kv_write_rows(rep):
    base = _rand(7, (B, S, KV, HD))
    new = _rand(8, (B, KV, HD))
    pos = np.array([3, 11])
    jout = jkv.kv_write_rows(
        _jax_side(rep, base), jnp.asarray(new), jnp.arange(B), jnp.asarray(pos)
    )
    tout = tkv.kv_write_rows(
        _torch_side(rep, base), torch.from_numpy(new), torch.arange(B),
        torch.from_numpy(pos),
    )
    _assert_same(jout, tout)


@pytest.mark.parametrize("rep", REPS)
def test_kv_write_rows_seq(rep):
    base = _rand(9, (B, S, KV, HD))
    new = _rand(10, (B, 3, KV, HD))
    pos = np.array([0, 9])
    jout = jkv.kv_write_rows_seq(
        _jax_side(rep, base), jnp.asarray(new), jnp.arange(B), jnp.asarray(pos)
    )
    tout = tkv.kv_write_rows_seq(
        _torch_side(rep, base), torch.from_numpy(new), torch.arange(B),
        torch.from_numpy(pos),
    )
    _assert_same(jout, tout)


@pytest.mark.parametrize("rep", REPS)
def test_init_kv_and_bytes(rep):
    shape = (2, B, S, KV, HD)
    jside = jkv.init_kv(shape, jnp.bfloat16, rep)
    tside = tkv.init_kv(shape, torch.bfloat16, rep, "cpu")
    _assert_same(jside, tside)
    if rep == "int8":
        assert tside["q"].dtype == torch.int8 and tside["s"].dtype == torch.float32
        assert tuple(tside["s"].shape) == shape[:-1]
    else:
        assert tside.dtype == torch.bfloat16
    assert tkv.kv_bytes(shape, torch.bfloat16, rep) == jkv.kv_bytes(
        shape, jnp.bfloat16, rep
    )


@pytest.mark.parametrize("rep", REPS)
def test_kv_map_clone_is_independent(rep):
    side = _torch_side(rep, _rand(11, (B, S, KV, HD)))
    clone = tkv.kv_map(torch.clone, side)
    tkv.kv_write_seq(side, torch.full((B, 1, KV, HD), 7.0), 0)
    a = tkv.kv_load(side, torch.float32)
    b = tkv.kv_load(clone, torch.float32)
    assert not torch.equal(a[:, 0], b[:, 0])
    assert torch.equal(a[:, 1:], b[:, 1:])


def test_validate_kv_dtype():
    assert tkv.validate_kv_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.validate_kv_dtype("fp8")


@pytest.mark.parametrize("rep", REPS)
def test_init_kv_defaults_to_the_card(rep, monkeypatch):
    """Like every entry point of the port, ``init_kv`` lands on the card
    unless the caller asks for the CPU: without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.init_kv((2, 8, 2, 4), torch.bfloat16, rep)
    side = tkv.init_kv((2, 8, 2, 4), torch.bfloat16, rep, device="cpu")
    leaf = side["q"] if rep == "int8" else side
    assert leaf.device.type == "cpu"
