"""Llama parity: ``tpuslo_torch.models.llama`` against the JAX module.

Weights come from the JAX initialisers and are carried over through
numpy (``tpuslo_torch.models.bridge``); token inputs are numpy arrays
from a seed.  Bounds:

* f32 logits within 1e-4 (same math, other summation order and other
  ``pow``/``cos`` implementations, ~1e-6 observed);
* f32 caches within 1e-5 (rotated keys and values before any matmul);
* bf16 logits within ``BF16_LOGIT_TOL``: both frameworks round at the
  same points, but bf16 matmul outputs that land on a rounding boundary
  can round apart, and one bf16 ulp of a hidden state moves a logit by
  about 1e-2 on these small configs;
* int8 KV: a key or value that lands within ~1e-6 of a rounding
  boundary of its int8 code may round the other way, so codes may
  differ by one step at a few entries and logits by ``INT8_KV_TOL``
  (one step is amax/127 of that row; 1.3e-3 observed).

The head-dim-128 config takes the flash path on both sides: the Pallas
kernel in interpret mode (``TPUSLO_FLASH_ATTENTION=1``) and the port's
plain flash version.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402

F32_TOL = 1e-4
CACHE_TOL = 1e-5
BF16_LOGIT_TOL = 5e-2
INT8_KV_TOL = 5e-3

_JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _configs(name: str):
    """(JAX config, port config, flash) for a named test config."""
    if name == "hd128":
        kw = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                  ffn_dim=512, max_seq_len=256)
        dt, flash = "f32", True
        cj, ct = jl.LlamaConfig(**kw), tl.LlamaConfig(**kw)
    else:
        dt, flash = name.split("_")[1], False
        cj, ct = jl.llama_tiny(max_seq_len=64), tl.llama_tiny(max_seq_len=64)
    cj = dataclasses.replace(cj, dtype=_JAX_DTYPE[dt])
    ct = dataclasses.replace(ct, dtype=_TORCH_DTYPE[dt])
    return cj, ct, flash


_PAIRS: dict = {}


def _pair(name: str, quantized: bool = False):
    """(cfg_j, cfg_t, params_j, params_t, flash), cached per module."""
    key = (name, quantized)
    if key not in _PAIRS:
        cj, ct, flash = _configs(name)
        init = jl.init_params_quantized if quantized else jl.init_params
        pj = init(jax.random.PRNGKey(0), cj)
        pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu")
        _PAIRS[key] = (cj, ct, pj, pt, flash)
    return _PAIRS[key]


@pytest.fixture
def flash_env(monkeypatch):
    """Route the JAX side's eligible prefills through the Pallas kernel
    (interpret mode on the CPU), as the port's flash path is taken."""
    monkeypatch.setenv("TPUSLO_FLASH_ATTENTION", "1")


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _logit_tol(ct) -> float:
    return F32_TOL if ct.dtype == torch.float32 else BF16_LOGIT_TOL


def _close(jx, tt, tol):
    err = np.abs(np.asarray(jx, np.float32) - tt.float().numpy()).max()
    assert err < tol, err


def _same_cache(cj_cache, ct_cache):
    got = bridge.cache_to_numpy(ct_cache)
    for side in ("k", "v"):
        js, ts = cj_cache[side], got[side]
        if isinstance(js, dict):
            dq = np.abs(np.asarray(js["q"], np.int32) - ts["q"].astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).mean() < 1e-2, (dq.max(), (dq > 0).sum())
            np.testing.assert_allclose(np.asarray(js["s"]), ts["s"], rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(
                np.asarray(js, np.float32), ts, rtol=0, atol=CACHE_TOL
            )
    np.testing.assert_array_equal(np.asarray(cj_cache["length"]), got["length"])


@pytest.mark.parametrize("name", ["tiny_f32", "tiny_bf16", "hd128"])
def test_forward(name, flash_env):
    cj, ct, pj, pt, _ = _pair(name)
    S = 128 if name == "hd128" else 24
    toks = _tokens(1, (2, S), cj.vocab_size)
    lj = jl.forward(pj, jnp.asarray(toks), cj)
    lt = tl.forward(pt, torch.from_numpy(toks), ct)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, S, ct.vocab_size)
    _close(lj, lt, _logit_tol(ct))


def _prefill_both(name, lengths, seed=2, kv_dtype="bf16", quantized=False):
    """Prefill the same padded tokens on both sides; returns everything
    a follow-up step needs."""
    cj, ct, pj, pt, flash = _pair(name, quantized)
    B = len(lengths)
    S = 128 if flash else 16
    toks = _tokens(seed, (B, S), cj.vocab_size)
    if len(set(lengths)) == 1 and B == 1:
        tlj, tlt = jnp.asarray(lengths[0], jnp.int32), lengths[0]
    else:
        tlj = jnp.asarray(lengths, jnp.int32)
        tlt = torch.tensor(lengths)
    lj, cache_j = jl.prefill(
        pj, jnp.asarray(toks), jl.init_kv_cache(cj, B, kv_dtype), cj, true_length=tlj
    )
    lt, cache_t = tl.prefill(
        pt, torch.from_numpy(toks), tl.init_kv_cache(ct, B, kv_dtype, "cpu"), ct,
        true_length=tlt,
    )
    return (cj, ct, pj, pt), (lj, cache_j), (lt, cache_t)


@pytest.mark.parametrize("name", ["tiny_f32", "tiny_bf16", "hd128"])
@pytest.mark.parametrize("lengths", [[11], [16, 5]], ids=["scalar", "vector"])
def test_prefill(name, lengths, flash_env):
    if name == "hd128":
        lengths = [128] if len(lengths) == 1 else [128, 77]
    (_, ct, _, _), (lj, cache_j), (lt, cache_t) = _prefill_both(name, lengths)
    _close(lj, lt, _logit_tol(ct))
    if ct.dtype == torch.float32:
        _same_cache(cache_j, cache_t)


@pytest.mark.parametrize("name", ["tiny_f32", "hd128"])
@pytest.mark.parametrize("lengths", [[9], [12, 3]], ids=["scalar", "vector"])
def test_decode_step(name, lengths, flash_env):
    if name == "hd128":  # prefill through flash, decode through plain attention
        lengths = [128] if len(lengths) == 1 else [128, 40]
    (cj, ct, pj, pt), (_, cache_j), (_, cache_t) = _prefill_both(name, lengths)
    B = len(lengths)
    for step in range(3):
        tok = _tokens(10 + step, (B,), cj.vocab_size)
        lj, cache_j = jl.decode_step(pj, jnp.asarray(tok, jnp.int32), cache_j, cj)
        lt, cache_t = tl.decode_step(pt, torch.from_numpy(tok), cache_t, ct)
        _close(lj, lt, F32_TOL)
        _same_cache(cache_j, cache_t)


@pytest.mark.parametrize("lengths", [[7], [10, 4]], ids=["scalar", "vector"])
def test_verify_chunk(lengths):
    (cj, ct, pj, pt), (_, cache_j), (_, cache_t) = _prefill_both("tiny_f32", lengths)
    toks = _tokens(20, (len(lengths), 4), cj.vocab_size)
    lj, cache_j = jl.verify_chunk(pj, jnp.asarray(toks, jnp.int32), cache_j, cj)
    lt, cache_t = tl.verify_chunk(pt, torch.from_numpy(toks), cache_t, ct)
    assert tuple(lt.shape) == (len(lengths), 4, ct.vocab_size)
    _close(lj, lt, F32_TOL)
    _same_cache(cache_j, cache_t)  # length unchanged, chunk KV written


@pytest.mark.parametrize("lengths", [[6], [13, 2]], ids=["scalar", "vector"])
def test_decode_chunk_greedy(lengths):
    (cj, ct, pj, pt), (lj, cache_j), (lt, cache_t) = _prefill_both("tiny_f32", lengths)
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = lt.argmax(-1)
    np.testing.assert_array_equal(np.asarray(tok_j), tok_t.numpy())
    toks_j, last_j, cache_j = jl.decode_chunk(pj, tok_j, cache_j, cj, num_tokens=6)
    toks_t, last_t, cache_t = tl.decode_chunk(pt, tok_t, cache_t, ct, num_tokens=6)
    np.testing.assert_array_equal(np.asarray(toks_j), toks_t.numpy())
    np.testing.assert_array_equal(np.asarray(last_j), last_t.numpy())
    _same_cache(cache_j, cache_t)


def test_int8_weights_from_jax():
    """int8 {"q","s"} leaves carried over as they are (never re-quantized)
    serve the same logits."""
    (cj, ct, pj, pt), (lj, cache_j), (lt, cache_t) = _prefill_both(
        "tiny_f32", [10, 4], quantized=True
    )
    assert isinstance(pt["layers"]["wq"], dict) and pt["layers"]["wq"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(
        np.asarray(pj["layers"]["w2"]["q"]), pt["layers"]["w2"]["q"].numpy()
    )
    _close(lj, lt, F32_TOL)
    tok = _tokens(30, (2,), cj.vocab_size)
    lj, cache_j = jl.decode_step(pj, jnp.asarray(tok, jnp.int32), cache_j, cj)
    lt, cache_t = tl.decode_step(pt, torch.from_numpy(tok), cache_t, ct)
    _close(lj, lt, F32_TOL)
    _same_cache(cache_j, cache_t)


@pytest.mark.parametrize("lengths", [[12], [12, 6]], ids=["scalar", "vector"])
def test_int8_kv(lengths):
    (cj, ct, pj, pt), (lj, cache_j), (lt, cache_t) = _prefill_both(
        "tiny_f32", lengths, kv_dtype="int8"
    )
    _close(lj, lt, F32_TOL)  # prefill attends over unquantized k/v
    _same_cache(cache_j, cache_t)
    tok = _tokens(31, (len(lengths),), cj.vocab_size)
    lj, cache_j = jl.decode_step(pj, jnp.asarray(tok, jnp.int32), cache_j, cj)
    lt, cache_t = tl.decode_step(pt, torch.from_numpy(tok), cache_t, ct)
    _close(lj, lt, INT8_KV_TOL)
    _same_cache(cache_j, cache_t)


def test_quantize_params_matches_jax():
    """Same scales; the same codes except where a quotient sits on a .5
    boundary, which XLA's fused divide may round the other way (the
    reason the bridge copies int8 leaves instead of re-quantizing)."""
    cj, ct, pj, pt, _ = _pair("tiny_bf16")
    qj = jl.quantize_params(pj)
    qt = tl.quantize_params(pt)
    for leaf_j, leaf_t in (
        (qj["layers"]["wq"], qt["layers"]["wq"]),
        (qj["layers"]["w2"], qt["layers"]["w2"]),
        (qj["embed"], qt["embed"]),
    ):
        dq = np.abs(np.asarray(leaf_j["q"], np.int32) - leaf_t["q"].numpy().astype(np.int32))
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
        np.testing.assert_allclose(
            np.asarray(leaf_j["s"]), leaf_t["s"].numpy(), rtol=1e-6, atol=0
        )
    assert qt["final_norm"] is pt["final_norm"]


@pytest.mark.parametrize(
    "factory", ["llama_tiny", "llama32_1b", "llama32_3b", "llama3_8b", "llama3_70b"]
)
def test_size_arithmetic_matches_jax(factory):
    cj, ct = getattr(jl, factory)(), getattr(tl, factory)()
    assert dataclasses.asdict(cj) | {"dtype": None} == dataclasses.asdict(ct) | {"dtype": None}
    assert tl.param_count(ct) == jl.param_count(cj)
    assert tl.quantized_bytes(ct) == jl.quantized_bytes(cj)
    for kv in ("bf16", "int8"):
        assert tl.kv_cache_bytes(ct, 2, kv) == jl.kv_cache_bytes(cj, 2, kv)


def test_init_params_layout_and_scale():
    cfg = tl.llama_tiny()
    pt = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    pj = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jl.llama_tiny()))
    assert set(pt) == set(pj) and set(pt["layers"]) == set(pj["layers"])
    for name, leaf in pj["layers"].items():
        assert tuple(pt["layers"][name].shape) == leaf.shape
        assert pt["layers"][name].dtype == torch.bfloat16
    assert tuple(pt["embed"].shape) == pj["embed"].shape
    assert tuple(pt["output"].shape) == pj["output"].shape
    # fan-in scaling: std of w1 is dim ** -0.5
    std = pt["layers"]["w1"].float().std().item()
    assert abs(std - cfg.dim**-0.5) < 0.01
    assert torch.equal(pt["layers"]["attn_norm"], torch.ones(cfg.n_layers, cfg.dim, dtype=torch.bfloat16))
    again = tl.init_params(0, cfg, "cpu")
    assert torch.equal(again["layers"]["wq"], tl.init_params(0, cfg, "cpu")["layers"]["wq"])


def test_rms_norm_scales_after_cast_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    oj = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
    ot = tl.rms_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-5
    )
    np.testing.assert_array_equal(np.asarray(oj, np.float32), ot.float().numpy())


def test_sample_greedy_is_argmax():
    logits = np.random.default_rng(4).standard_normal((3, 50)).astype(np.float32)
    got = tl.sample_from_logits(torch.from_numpy(logits), None, tl.GREEDY)
    want = jl.sample_from_logits(jnp.asarray(logits), jax.random.PRNGKey(0), jl.GREEDY)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def jax_kept_set(logits: np.ndarray, sampling, monkeypatch) -> np.ndarray:
    """The tokens JAX's ``sample_from_logits`` may draw: capture the
    filtered logits it hands to ``jax.random.categorical``."""
    seen = {}

    def capture(key, filtered, axis=-1):
        seen["logits"] = np.asarray(filtered)
        return jnp.zeros(filtered.shape[:-1], jnp.int32)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", capture)
        jl.sample_from_logits(
            jnp.asarray(logits), jax.random.PRNGKey(0),
            jl.SamplingConfig(sampling.temperature, sampling.top_k, sampling.top_p),
        )
    return np.isfinite(seen["logits"])


@pytest.mark.parametrize(
    "sampling",
    [
        tl.SamplingConfig(temperature=0.8, top_k=5),
        tl.SamplingConfig(temperature=1.0, top_p=0.6),
        tl.SamplingConfig(temperature=0.7, top_k=8, top_p=0.5),
        tl.SamplingConfig(temperature=1.0, top_p=0.0),
    ],
    ids=["top_k", "top_p", "both", "top_p_zero"],
)
def test_sampled_tokens_stay_in_jax_kept_set(sampling, monkeypatch):
    logits = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    kept = jax_kept_set(logits, sampling, monkeypatch)
    gen = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(logits)
    draws = np.stack([tl.sample_from_logits(lt, gen, sampling).numpy() for _ in range(200)])
    for row in range(4):
        assert kept[row, draws[:, row]].all()
        if kept[row].sum() > 1:
            assert len(set(draws[:, row])) > 1  # it does sample


def test_sampling_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        tl.sample_from_logits(torch.zeros(1, 4), None, tl.SamplingConfig(temperature=1.0))
