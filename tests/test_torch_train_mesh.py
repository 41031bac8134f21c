"""The port's sharded Llama train step (``build_sharded_train_step`` over a
mesh of gloo ranks on the CPU) against ``tpuslo.models.train``'s on a
JAX mesh of the same plan (the conftest's CPU devices), and the training
layouts against ``tpuslo.parallel.mesh``'s.

The same llama_tiny weights (JAX's ``init_params``, carried over as
numpy) and the same global batch go through both; each port rank takes
its rows by ``batch_sharding``.  For dp 2, fsdp 2, tp 2, dp 2 x fsdp 2 x
tp 2 and dcn 2 x fsdp 2 x tp 2, in f32 and bf16, one AdamW step:

* the loss within 1e-4 (f32) or JAX's 2e-2 (bf16, the multi-chip
  checklist's ``loss`` / ``dcn2_loss`` bound) of JAX's step;
* the gradients gathered whole within 1e-4 (f32) of ``jax.grad``; bf16,
  relative to each leaf's largest value, within 5e-2 of the port's
  one-device gradients and of JAX's;
* (f32) the parameters after the step within 2 lr of JAX's: AdamW's
  first step moves an entry by about lr times the sign of its gradient,
  so a gradient near zero may flip.

The two rank groups (2 and 8 ranks) run every mesh of their size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_mesh_ranks as ranks  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import train as jtrain  # noqa: E402
from tpuslo.parallel import mesh as jmesh  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

PLANS = {
    "dp2": dict(dp=2),
    "fsdp2": dict(fsdp=2),
    "tp2": dict(tp=2),
    "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2),
    "dcn2_fsdp2_tp2": dict(dcn=2, fsdp=2, tp=2),
}
DTYPES = ("f32", "bf16")
LOSS_TOL = {"f32": 1e-4, "bf16": 2e-2}
GRAD_TOL = {"f32": 1e-4, "bf16": 5e-2}
LR = 3e-4
B, S = 8, 32
JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _jcfg(dtype: str):
    return dataclasses.replace(jl.llama_tiny(max_seq_len=64), dtype=JDTYPES[dtype])


def _key(name: str, dtype: str):
    return (tuple(sorted(PLANS[name].items())), dtype)


def _n(name: str) -> int:
    return tmesh.MeshPlan(**PLANS[name]).n_devices


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), _jcfg("f32")))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, 512), np.int64)
    return params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def port(inputs):
    """(plan, dtype) key -> each rank's observations: one gloo group of 2
    ranks for the 2-device plans, one of 8 for the others."""
    out = {}
    for world in (2, 8):
        runs = [(PLANS[name], dtype) for name in PLANS if _n(name) == world for dtype in DTYPES]
        got = tmesh.run_ranks(ranks.train_step_rank, world, timeout_s=ranks.RANK_TIMEOUT_S,
                              args=(*inputs, runs))
        for key in got[0]:
            out[key] = [r[key] for r in got]
    return out


@pytest.fixture(scope="module")
def jax_side(inputs):
    """(plan, dtype) -> JAX's step on its mesh of that plan: loss, params
    after; dtype -> jax.grad of the loss (the mesh does not change it)."""
    params, tokens, targets = inputs
    out = {}
    for dtype in DTYPES:
        cfg = _jcfg(dtype)
        p0 = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params)
        tok, tgt = jnp.asarray(tokens, jnp.int32), jnp.asarray(targets, jnp.int32)
        out[dtype] = jax.tree.map(lambda g: np.asarray(g, np.float32),
                                  jax.grad(jtrain.loss_fn)(p0, tok, tgt, cfg))
        for name, plan in PLANS.items():
            mesh = jmesh.make_mesh(jmesh.MeshPlan(**plan))
            step, _ = jtrain.build_sharded_train_step(mesh, cfg)
            placed = jax.device_put(  # fresh buffers: the step donates them
                jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params),
                jmesh.param_shardings(mesh))
            opt = jtrain.make_optimizer().init(placed)
            new, _, loss = step(placed, opt, tok, tgt)
            out[(name, dtype)] = {"loss": float(loss),
                                  "params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                         new)}
    return out


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path)
        else:
            yield path, tree[k]


def _pairs(got: dict, want: dict):
    want = dict(_leaves(want))
    for path, g in _leaves(got):
        yield path, g, want[path]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_step_loss_matches_jax(port, jax_side, name, dtype):
    losses = [r["loss"] for r in port[_key(name, dtype)]]
    assert len(set(losses)) == 1  # the global loss on every rank
    err = abs(losses[0] - jax_side[(name, dtype)]["loss"])
    assert err < LOSS_TOL[dtype], f"{name} {dtype}: {losses[0]} vs {jax_side[(name, dtype)]}"


@pytest.fixture(scope="module")
def one_device(inputs):
    """dtype -> the port's one-device gradients of the same loss."""
    from tpuslo_torch.models import bridge, llama, train

    params, tokens, targets = inputs
    out = {}
    for dtype in DTYPES:
        cfg = ranks.llama_cfg(dtype)
        p = train.trainable(bridge.params_from_numpy(params, cfg, "cpu"))
        llama.loss_fn(p, torch.from_numpy(tokens), torch.from_numpy(targets), cfg).backward()
        out[dtype] = {path: t.grad.float().numpy() for path, t in train.param_leaves(p)}
    return out


@pytest.mark.parametrize("name", sorted(PLANS))
def test_f32_gathered_gradients_match_jax(port, jax_side, name):
    for path, g, want in _pairs(port[_key(name, "f32")][0]["grads"], jax_side["f32"]):
        err = float(np.abs(g - want).max())
        assert err <= GRAD_TOL["f32"], f"{name} {path}: {err}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bf16_gathered_gradients_match_jax(port, jax_side, one_device, name):
    """bf16: each leaf within 5e-2 of its largest value of the port's
    one-device gradient (what the sharding adds: the tp partial products
    round before their sum) and of JAX's (the two frameworks' one-device
    gradients already differ by up to 2.9e-2 of a norm leaf's largest
    value), the bound chip_smoke's phase 23 holds two bf16 backward passes
    to: the cotangents round to bf16 at every op of both."""
    for path, g, want in _pairs(port[_key(name, "bf16")][0]["grads"], jax_side["bf16"]):
        for ref, what in ((one_device["bf16"][path], "one device"), (want, "JAX")):
            err = float(np.abs(g - ref).max()) / float(np.abs(ref).max())
            assert err <= GRAD_TOL["bf16"], f"{name} {path}: {err} from {what}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_f32_params_after_the_step_match_jax(port, jax_side, name):
    for path, p, want in _pairs(port[_key(name, "f32")][0]["params"],
                                jax_side[(name, "f32")]["params"]):
        err = float(np.abs(p - want).max())
        assert err <= 2 * LR, f"{name} {path}: {err}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_each_rank_holds_its_shards(port, inputs, name):
    params, _, _ = inputs
    plan = tmesh.MeshPlan(**PLANS[name])
    for r in port[_key(name, "f32")]:
        for path, spec in tmesh.PARAM_SHARDINGS.items():
            want = list(dict(_leaves(params))[path].shape)
            for dim, axis in spec.items():
                want[dim] //= getattr(plan, axis)
            assert r["shapes"][path] == tuple(want), (name, path)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_collectives_follow_the_plan(port, name):
    """fsdp gathers and reduce-scatters, tp reduces inside the layers and
    takes the vocab max, dp/dcn reduce only the gradients and the loss."""
    plan = tmesh.MeshPlan(**PLANS[name])
    calls = port[_key(name, "f32")][0]["calls"]
    assert ("all_gather" in calls) == (plan.fsdp > 1)
    assert ("reduce_scatter" in calls) == (plan.fsdp > 1)
    assert ("all_reduce_max" in calls) == (plan.tp > 1)
    if plan.tp == 1 and plan.fsdp == 1:
        assert calls == {"all_reduce": 2}  # one gradient bucket, the loss


def _specs(tree: dict, prefix: str = ""):
    """(path, layout) of a tree whose leaves are ``{dim: axis}`` layouts."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict) and any(isinstance(key, str) for key in v):
            yield from _specs(v, path)
        else:
            yield path, v


def _jax_spec(spec) -> dict:
    return {i: a for i, a in enumerate(spec) if a is not None}


@pytest.mark.parametrize("n,slices", [(2, 1), (4, 1), (8, 1), (8, 2)])
def test_the_training_layouts_are_jaxs(n, slices):
    import optax

    plan = jmesh.plan_for_devices(n, slices)
    jm = jmesh.make_mesh(plan)
    tm = tmesh.Mesh(tmesh.plan_for_devices(n, slices), torch.device("cpu"))
    shard = jmesh.param_shardings(jm)
    want = {path: _jax_spec(s.spec) for path, s in _leaves(shard)}
    assert tmesh.param_shardings(tm) == want
    for seq in (None, "tp"):
        assert tmesh.batch_sharding(tm, seq) == _jax_spec(jmesh.batch_sharding(jm, seq).spec)
    cfg = _jcfg("f32")
    abstract = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), cfg))
    opt_abstract = jax.eval_shape(optax.adamw(LR).init, abstract)
    jstate = jmesh.optimizer_state_shardings(opt_abstract, shard, jm)[0]
    tree = {"count": 0, "mu": abstract, "nu": abstract}
    got = tmesh.optimizer_state_shardings(tree, tmesh.param_shardings(tm), tm)
    assert got["count"] == _jax_spec(jstate.count.spec) == {}
    for moment in ("mu", "nu"):
        assert dict(_specs(got[moment])) == {
            p: _jax_spec(s.spec) for p, s in _leaves(getattr(jstate, moment))}
