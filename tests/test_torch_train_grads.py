"""Gradients of the port's training path against JAX's on the CPU.

* K1's backward helper (``flash_attention_backward``) against ``jax.vjp``
  of ``tpuslo.ops.flash_attention.flash_attention(..., interpret=True)``
  at S 128, D 128, 2 heads over 1 kv head, causal and not (f32: 1e-5 of
  the largest value; bf16 inputs: within 2 bf16 ulps of the largest
  value, 2**-7, since each side rounds its f32 result once);
* the norm backwards (``rms_norm_backward``, ``add_rms_norm_backward``)
  against ``jax.vjp`` of JAX's ``rms_norm`` and of the residual add and
  norm (f32 1e-5 relative to the largest value; bf16 within 2**-7);
* ``llama.loss_fn`` / ``mixtral.loss_fn`` and their gradients against
  ``jax.value_and_grad`` of the JAX loss on the same weights: f32 loss to
  rtol 1e-5 and each gradient leaf to 1e-4 of its largest value; the bf16
  loss within 2e-2 (bf16 products round at every layer on both sides);
* ``remat=True`` gives the same loss and gradients as ``remat=False``,
  bitwise.
"""

from __future__ import annotations

import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import mixtral as jm  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402
from tpuslo_torch.models.train import param_leaves, trainable  # noqa: E402

# The modules (both packages re-export the function under the module's name).
jfa = importlib.import_module("tpuslo.ops.flash_attention")
tfa = importlib.import_module("tpuslo_torch.ops.flash_attention")
trn = importlib.import_module("tpuslo_torch.ops.rms_norm")

F32_REL = 1e-5
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
BF16_REL = 2.0**-7
BF16_LOSS_ATOL = 2e-2


def _close_rel(got: np.ndarray, want: np.ndarray, rel: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32))


# --- K1's backward ---------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_backward_matches_jax_vjp(causal, dtype):
    B, S, H, KV, D = 1, 128, 2, 1, 128
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    want_out, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal, interpret=True), jq, jk, jv)
    wants = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    gots = tfa.flash_attention_backward(tq, tk, tv, tdo, causal)
    rel = F32_REL if dtype == "f32" else BF16_REL
    for name, got, want in zip(("dq", "dk", "dv"), gots, wants):
        assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
        _close_rel(_np(got), _np(want), rel, name)
    # The autograd path (forward plain on the CPU, backward the helper).
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal)
    _close_rel(_np(out.detach()), _np(want_out), rel, "out")
    out.backward(tdo)
    for leaf, got in zip(leaves, gots):
        assert torch.equal(leaf.grad, got)


def test_flash_autograd_counts_no_launch_on_the_cpu():
    before = (tfa.flash_attention.launches, tfa.flash_attention.f32_launches)
    q = torch.randn(1, 128, 2, 128, requires_grad=True)
    kv = torch.randn(1, 128, 1, 128, requires_grad=True)
    tfa.flash_attention(q, kv, kv).sum().backward()
    assert (tfa.flash_attention.launches, tfa.flash_attention.f32_launches) == before
    assert q.grad is not None and kv.grad is not None


# --- the norms' backwards --------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_backward_matches_jax_vjp(dtype):
    rng = np.random.default_rng(3)
    x, w, dy = (rng.standard_normal(s).astype(np.float32) for s in ((6, 64), (64,), (6, 64)))
    w = 1.0 + 0.1 * w
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jl.rms_norm(a, b, 1e-5), jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(dy, jdt))
    got_dx, got_dw = trn.rms_norm_backward(torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(w).to(tdt), 1e-5,
                                           torch.from_numpy(dy).to(tdt))
    rel = F32_REL if dtype == "f32" else BF16_REL
    _close_rel(_np(got_dx), _np(want_dx), rel, "dx")
    _close_rel(_np(got_dw), _np(want_dw), rel if dtype == "f32" else 2 * rel, "dweight")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_add_rms_norm_backward_matches_jax_vjp(dtype):
    rng = np.random.default_rng(4)
    h, d, w, dh, dy = (rng.standard_normal(s).astype(np.float32)
                       for s in ((5, 64), (5, 64), (64,), (5, 64), (5, 64)))
    w = 1.0 + 0.1 * w
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)

    def pair(a, b, c):
        s = a + b
        return s, jl.rms_norm(s, c, 1e-5)

    _, vjp = jax.vjp(pair, *(jnp.asarray(a, jdt) for a in (h, d, w)))
    want_dh, want_dd, want_dw = vjp((jnp.asarray(dh, jdt), jnp.asarray(dy, jdt)))
    th, td, tw = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (h, d, w))
    s, y = trn.add_rms_norm(th, td, tw, 1e-5)
    torch.autograd.backward((s, y), (torch.from_numpy(dh).to(tdt), torch.from_numpy(dy).to(tdt)))
    rel = F32_REL if dtype == "f32" else BF16_REL
    _close_rel(_np(th.grad), _np(want_dh), rel, "dh")
    _close_rel(_np(td.grad), _np(want_dd), rel, "dd")
    _close_rel(_np(tw.grad), _np(want_dw), rel if dtype == "f32" else 2 * rel, "dweight")


# --- the models' losses and gradients --------------------------------------

LLAMA_J = dataclasses.replace(jl.llama_tiny(max_seq_len=64), dtype=jnp.float32)
LLAMA_T = dataclasses.replace(tl.llama_tiny(max_seq_len=64), dtype=torch.float32)
MIXTRAL_J = dataclasses.replace(jm.mixtral_tiny(max_seq_len=64), dtype=jnp.float32)
MIXTRAL_T = dataclasses.replace(tm.mixtral_tiny(max_seq_len=64), dtype=torch.float32)
FAMILIES = {
    "llama": (jl.init_params, jl.loss_fn, tl.loss_fn, LLAMA_J, LLAMA_T),
    "mixtral": (jm.init_params, jm.loss_fn, tm.loss_fn, MIXTRAL_J, MIXTRAL_T),
}


def _batch(seed: int, vocab: int, shape=(2, 32)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def _port_grads(params) -> dict[str, np.ndarray]:
    return {path: t.grad.float().numpy() for path, t in param_leaves(params)}


def _jax_grads(grads) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {"/".join(k.key for k in path): np.asarray(leaf, np.float32) for path, leaf in flat}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax_f32(family):
    init_j, loss_j, loss_t, cfg_j, cfg_t = FAMILIES[family]
    pj = init_j(jax.random.PRNGKey(0), cfg_j)
    tok, tgt = _batch(11, cfg_t.vocab_size)
    want, grads_j = jax.value_and_grad(loss_j)(pj, jnp.asarray(tok), jnp.asarray(tgt), cfg_j)
    pt = trainable(bridge.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, "cpu"))
    got = loss_t(pt, torch.from_numpy(tok), torch.from_numpy(tgt), cfg_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    gj, gt = _jax_grads(grads_j), _port_grads(pt)
    assert sorted(gj) == sorted(gt)
    for path in gj:
        _close_rel(gt[path], gj[path], GRAD_REL, f"{family} grad {path}")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_matches_jax_bf16(family):
    init_j, loss_j, loss_t, cfg_j, cfg_t = FAMILIES[family]
    cfg_j = dataclasses.replace(cfg_j, dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(cfg_t, dtype=torch.bfloat16)
    pj = init_j(jax.random.PRNGKey(1), cfg_j)
    tok, tgt = _batch(12, cfg_t.vocab_size)
    want = loss_j(pj, jnp.asarray(tok), jnp.asarray(tgt), cfg_j)
    pt = trainable(bridge.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, "cpu"))
    got = loss_t(pt, torch.from_numpy(tok), torch.from_numpy(tgt), cfg_t)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= BF16_LOSS_ATOL
    assert all(torch.isfinite(t.grad).all() for _, t in param_leaves(pt))


def _loss_with_remat(family, params, tok, tgt, cfg, remat: bool):
    if family == "llama":
        return tl.nll_loss(tl.forward(params, tok, cfg, remat=remat), tgt)
    logits, aux = tm.forward(params, tok, cfg, remat=remat, return_aux=True)
    return tl.nll_loss(logits, tgt) + cfg.router_aux_coef * aux


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gives_the_same_loss_and_grads_bitwise(family):
    _, _, loss_t, _, cfg_t = FAMILIES[family]
    init_t = tl.init_params if family == "llama" else tm.init_params
    tok, tgt = (torch.from_numpy(a) for a in _batch(13, cfg_t.vocab_size))
    runs = []
    for remat in (True, False):
        pt = trainable(init_t(5, cfg_t, "cpu"))
        loss = _loss_with_remat(family, pt, tok, tgt, cfg_t, remat)
        loss.backward()
        runs.append((loss.detach(), _port_grads(pt)))
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    pt = trainable(init_t(5, cfg_t, "cpu"))
    assert torch.equal(loss_t(pt, tok, tgt, cfg_t).detach(), l1)  # loss_fn remats
    for path in g1:
        assert np.array_equal(g1[path], g2[path]), path


def test_mixtral_router_and_every_expert_get_gradient():
    pj = jm.init_params(jax.random.PRNGKey(2), MIXTRAL_J)
    pt = trainable(bridge.params_from_numpy(jax.tree.map(np.asarray, pj), MIXTRAL_T, "cpu"))
    tok, tgt = (torch.from_numpy(a) for a in _batch(14, MIXTRAL_T.vocab_size, (4, 32)))
    tm.loss_fn(pt, tok, tgt, MIXTRAL_T).backward()
    assert pt["layers"]["router"].grad.abs().sum() > 0
    for name in ("w1", "w3", "w2"):
        per_expert = pt["layers"][name].grad.abs().flatten(2).sum(-1)  # (L, E)
        assert (per_expert > 0).all(), name


def test_serving_forward_is_unchanged_without_gradient():
    """With no gradient the forward is the serving pass (row-wise
    products, no remat): the same logits as before training existed, here
    the prefill's logits at the last position."""
    cfg = LLAMA_T
    pt = tl.init_params(9, cfg, "cpu")
    tok = torch.from_numpy(_batch(15, cfg.vocab_size)[0]).long()
    with torch.no_grad():
        full = tl.forward(pt, tok, cfg)
    logits, _ = tl.prefill(pt, tok, tl.init_kv_cache(cfg, 2, device="cpu"), cfg)
    assert torch.equal(full[:, -1], logits)
    assert not full.requires_grad


def test_the_expert_products_backward_is_autograd_of_the_cpu_product():
    """The card's ``torch.bmm(..., out_dtype=f32)`` has no derivative in
    PyTorch; ``f32_product_backward`` (its gradient there) equals what
    autograd gives the CPU's ``piece.float() @ w.float()``, bitwise."""
    from tpuslo_torch.ops import moe

    gen = torch.Generator().manual_seed(6)
    piece = torch.randn((4, 128, 64), generator=gen).bfloat16().requires_grad_()
    w = torch.randn((4, 64, 96), generator=gen).bfloat16().requires_grad_()
    g = torch.randn((4, 128, 96), generator=gen)
    moe._f32_product(piece, w).backward(g)
    got = moe.f32_product_backward(piece.detach(), w.detach(), g)
    assert torch.equal(got[0], piece.grad) and got[0].dtype == torch.bfloat16
    assert torch.equal(got[1], w.grad) and got[1].dtype == torch.bfloat16
