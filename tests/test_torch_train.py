"""The port's AdamW train step against ``tpuslo.models.train`` on the CPU.

Both packages start from the same JAX-initialised f32 ``llama_tiny``
weights (carried over as numpy by ``bridge``) and take the same batches.

* three steps from zero moments: losses to rtol 1e-5; params, ``mu`` and
  ``nu`` after the steps within an f32 bound of 1e-5 of each leaf's
  largest value (the gradients agree to ~1e-6 relative; Adam's
  ``mu / sqrt(nu)`` turns a leaf's gradient into its sign-like update,
  so the bound is held on the moments and the params, not tighter);
* one step from the same non-zero moments (JAX's after its three steps,
  loaded through ``bridge.adamw_state_from_numpy``), to the same bounds;
* the optimizer's settings are optax's ``adamw`` defaults.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import train as jtrain  # noqa: E402
from tpuslo.models.data import tokenize_corpus, window_batches  # noqa: E402
from tpuslo.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from tpuslo.parallel.mesh import plan_for_devices as jplan  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import train as ttrain  # noqa: E402
from tpuslo_torch.parallel.mesh import make_mesh, plan_for_devices  # noqa: E402

LOSS_RTOL = 1e-5
STATE_REL = 1e-5
CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=64), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=64), dtype=torch.float32)
CORPUS = [f"sample {i}: pack my box with five dozen liquor jugs" for i in range(60)]

_SHARED: dict = {}


def _batches(n: int):
    it = window_batches(tokenize_corpus(CORPUS), 4, 32, seed=3, epochs=10)
    return [next(it) for _ in range(n)]


def _jax_run():
    """JAX's 4 steps: (initial params, [(params, adam state, loss) after
    each step])."""
    if not _SHARED:
        step, init = jtrain.build_sharded_train_step(jmake_mesh(jplan(1)), CFG_J)
        params, opt = init(jax.random.PRNGKey(0))
        _SHARED["p0"] = jax.tree.map(np.asarray, params)
        after = []
        for tok, tgt in _batches(4):
            params, opt, loss = step(params, opt, jnp.asarray(tok), jnp.asarray(tgt))
            adam = opt[0]
            after.append((jax.tree.map(np.asarray, params),
                          {"count": np.asarray(adam.count),
                           "mu": jax.tree.map(np.asarray, adam.mu),
                           "nu": jax.tree.map(np.asarray, adam.nu)},
                          float(loss)))
        _SHARED["after"] = after
    return _SHARED["p0"], _SHARED["after"]


def _close_tree(got: dict, want: dict, what: str) -> None:
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        g = np.asarray(flat_g[path], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= STATE_REL * scale, f"{what} {jax.tree_util.keystr(path)}: {err} vs {scale}"


def _port_step():
    return ttrain.build_sharded_train_step(make_mesh(plan_for_devices(1), ["cpu"]), CFG_T)[0]


def test_optimizer_is_optax_adamw_defaults():
    opt = ttrain.make_optimizer()
    assert (opt.lr, opt.weight_decay, ttrain.BETAS, ttrain.EPS) == (3e-4, 0.1, (0.9, 0.95), 1e-8)
    pt = ttrain.trainable(tl.init_params(0, CFG_T, "cpu"))
    group = opt.init(pt).param_groups[0]
    assert group["betas"] == (0.9, 0.95) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.1 and group["lr"] == 3e-4
    assert len(group["params"]) == len(jax.tree.leaves(jl.init_params(
        jax.random.PRNGKey(0), CFG_J)))


def test_three_steps_from_zero_moments_match_jax():
    p0, after = _jax_run()
    pt = ttrain.trainable(bridge.params_from_numpy(p0, CFG_T, "cpu"))
    opt = ttrain.make_optimizer().init(pt)
    step = _port_step()
    for i, (tok, tgt) in enumerate(_batches(3)):
        pt, opt, loss = step(pt, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
        np.testing.assert_allclose(float(loss), after[i][2], rtol=LOSS_RTOL)
    want_params, want_state, _ = after[2]
    _close_tree(bridge.params_to_numpy(pt), want_params, "params")
    got_state = bridge.adamw_state_to_numpy(opt, pt)
    assert int(got_state["count"]) == int(want_state["count"]) == 3
    _close_tree(got_state["mu"], want_state["mu"], "mu")
    _close_tree(got_state["nu"], want_state["nu"], "nu")


def test_one_step_from_the_same_nonzero_moments_matches_jax():
    _, after = _jax_run()
    params3, state3, _ = after[2]
    pt = ttrain.trainable(bridge.params_from_numpy(params3, CFG_T, "cpu"))
    opt = bridge.adamw_state_from_numpy(state3, ttrain.make_optimizer().init(pt), pt)
    round_trip = bridge.adamw_state_to_numpy(opt, pt)
    for side in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(round_trip[side]), jax.tree.leaves(state3[side])):
            np.testing.assert_array_equal(a, b)
    tok, tgt = _batches(4)[3]
    pt, opt, loss = _port_step()(pt, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
    want_params, want_state, want_loss = after[3]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _close_tree(bridge.params_to_numpy(pt), want_params, "params")
    got_state = bridge.adamw_state_to_numpy(opt, pt)
    assert int(got_state["count"]) == 4
    _close_tree(got_state["mu"], want_state["mu"], "mu")
    _close_tree(got_state["nu"], want_state["nu"], "nu")


def test_the_step_refuses_tokens_on_another_device():
    pt = ttrain.trainable(tl.init_params(0, CFG_T, "cpu"))
    opt = ttrain.make_optimizer().init(pt)
    tok = torch.zeros((2, 8), dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="trains on cpu"):
        _port_step()(pt, opt, tok, tok)
