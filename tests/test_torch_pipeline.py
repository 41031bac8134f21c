"""The port's GPipe pipeline (``tpuslo_torch/parallel/pipeline.py``) against
``tpuslo/parallel/pipeline.py`` and against the port's one-device forward.

The same llama_tiny weights at 8 layers (JAX's ``init_params``, carried
over as numpy) and the same tokens go through both packages.  The port
runs each pipeline as gloo ranks on the CPU, one group per pp size; JAX
runs ``pipelined_forward`` / ``pipelined_loss`` on the conftest's CPU
devices (a fast subset of ``tests/test_pipeline.py``, which is ``slow``):

* ``pipelined_forward`` at ``(pp, M)`` in (2, 4), (4, 2), (8, 4): f32
  within 1e-5 of the port's one-device forward and of JAX's pipeline;
  bf16 within JAX's 2e-2 of the one-device forward and, against JAX's
  pipeline, within 2e-2 more than the two frameworks' bf16 forwards
  differ; every stage holds the same logits;
* ``pipelined_loss`` at pp 4 (2 microbatches, f32): the loss and every
  gradient leaf within 1e-4 of ``jax.grad`` of JAX's ``pipelined_loss``,
  and every stage's layers get a nonzero gradient;
* JAX's validation errors, raised before any collective.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_train_mesh_ranks as ranks  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.parallel import pipeline as jp  # noqa: E402
from tpuslo_torch.models import bridge, llama as tl  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402
from tpuslo_torch.parallel import pipeline as tp  # noqa: E402

CASES = [(2, 4), (4, 2), (8, 4)]
GRAD_PP, GRAD_MB = 4, 2
F32_TOL = 1e-5
BF16_TOL = 2e-2  # tests/test_pipeline.py's bound
GRAD_TOL = 1e-4
JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _jcfg(dtype: str):
    return dataclasses.replace(jl.llama_tiny(max_seq_len=32), n_layers=8, dtype=JDTYPES[dtype])


def _jmesh(pp: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:pp]), ("pp",))


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), _jcfg("f32")))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 512), np.int64)
    return params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def port(inputs):
    """pp -> each stage's observations (one group of gloo ranks per pp)."""
    params, tokens, targets = inputs
    out = {}
    for pp in sorted({pp for pp, _ in CASES}):
        forwards = [(dtype, mb) for p, mb in CASES if p == pp for dtype in ("f32", "bf16")]
        out[pp] = tmesh.run_ranks(ranks.pipeline_rank, pp, timeout_s=ranks.RANK_TIMEOUT_S,
                                  args=(params, tokens, targets, forwards,
                                        GRAD_MB if pp == GRAD_PP else None))
    return out


def _jax_pipelined(params, tokens, dtype: str, pp: int, n_mb: int) -> np.ndarray:
    cfg = _jcfg(dtype)
    mesh = _jmesh(pp)
    placed = jp.place_pipeline_params(jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype), params),
                                      mesh)
    fn = jax.jit(lambda p, t: jp.pipelined_forward(p, t, cfg, mesh, n_microbatches=n_mb))
    return np.asarray(fn(placed, jnp.asarray(tokens, jnp.int32)), np.float32)


@pytest.mark.parametrize("pp,n_mb", CASES)
def test_f32_pipelined_forward_matches_the_one_device_forward(inputs, port, pp, n_mb):
    params, tokens, _ = inputs
    cfg = ranks.llama_cfg("f32", n_layers=8)
    with torch.no_grad():
        plain = tl.forward(bridge.params_from_numpy(params, cfg, "cpu"),
                           torch.from_numpy(tokens), cfg).numpy()
    for stage in port[pp]:
        assert stage["stage_layers"] == 8 // pp
        np.testing.assert_allclose(stage["logits"][("f32", n_mb)], plain, rtol=0, atol=F32_TOL)


def _plain(params, tokens, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """(the port's, JAX's) one-device forward logits, no remat."""
    cfg = ranks.llama_cfg(dtype, n_layers=8)
    with torch.no_grad():
        port = tl.forward(bridge.params_from_numpy(params, cfg, "cpu"),
                          torch.from_numpy(tokens), cfg).float().numpy()
    jcfg = _jcfg(dtype)
    want = jl.forward(jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), params),
                      jnp.asarray(tokens, jnp.int32), jcfg, remat=False)
    return port, np.asarray(want, np.float32)


def _stage_logits(port, pp: int, key) -> np.ndarray:
    got = [stage["logits"][key] for stage in port[pp]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])  # replicated on every stage
    return got[0]


@pytest.mark.parametrize("pp,n_mb", CASES)
def test_f32_pipelined_forward_matches_jax(inputs, port, pp, n_mb):
    params, tokens, _ = inputs
    want = _jax_pipelined(params, tokens, "f32", pp, n_mb)
    err = float(np.abs(_stage_logits(port, pp, ("f32", n_mb)) - want).max())
    assert err < F32_TOL, f"pp={pp} n_mb={n_mb}: {err}"


@pytest.mark.parametrize("pp,n_mb", CASES)
def test_bf16_pipelined_forward_matches_jax(inputs, port, pp, n_mb):
    """bf16: the pipeline within JAX's 2e-2 of the one-device forward, as
    JAX's test holds its own; against JAX's pipeline, within 2e-2 more
    than the two frameworks' one-device bf16 forwards differ (a matmul
    output on a rounding boundary can round apart, 0.07 of logits ~4 at 8
    layers, the bound ``test_torch_llama.py`` states)."""
    params, tokens, _ = inputs
    got = _stage_logits(port, pp, ("bf16", n_mb))
    plain_port, plain_jax = _plain(params, tokens, "bf16")
    err_plain = float(np.abs(got - plain_port).max())
    assert err_plain < BF16_TOL, f"pp={pp} n_mb={n_mb}: {err_plain} from the plain forward"
    frameworks = float(np.abs(plain_port - plain_jax).max())
    err = float(np.abs(got - _jax_pipelined(params, tokens, "bf16", pp, n_mb)).max())
    assert err < frameworks + BF16_TOL, f"pp={pp} n_mb={n_mb}: {err} (plain {frameworks})"


@pytest.mark.parametrize("pp,n_mb", CASES)
def test_the_schedule_hops_once_a_tick_and_sums_once(port, pp, n_mb):
    calls = port[pp][0]["forward_calls"][("f32", n_mb)]
    assert calls == {"shift": n_mb + pp - 2, "all_reduce": 1}


def test_pipelined_loss_gradients_match_jax(inputs, port):
    params, tokens, targets = inputs
    cfg = _jcfg("f32")
    mesh = _jmesh(GRAD_PP)
    placed = jp.place_pipeline_params(jax.tree.map(jnp.asarray, params), mesh)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jp.pipelined_loss(
        p, jnp.asarray(tokens, jnp.int32), jnp.asarray(targets, jnp.int32), cfg, mesh,
        n_microbatches=GRAD_MB)))(placed)
    grads = jax.tree.map(np.asarray, grads)
    for stage in port[GRAD_PP]:
        assert abs(stage["loss"] - float(loss)) < GRAD_TOL
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            keys = [k.key for k in path]
            got = stage["grads"]
            for k in keys:
                got = got[k]
            np.testing.assert_allclose(got, g, rtol=0, atol=GRAD_TOL, err_msg=str(keys))


def test_every_stage_gets_a_gradient_for_each_of_its_layers(port):
    for stage in port[GRAD_PP]:
        assert len(stage["own_layer_grads"]) == 8 // GRAD_PP
        assert min(stage["own_layer_grads"]) > 0.0
    whole = port[GRAD_PP][0]["grads"]["layers"]["wq"]
    assert float(np.square(whole).sum(axis=(1, 2)).min()) > 0.0


def test_the_layout_is_jaxs():
    specs = jp.pipeline_param_specs()
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        want["/".join(k.key for k in path)] = {i: a for i, a in enumerate(spec) if a is not None}
    assert tp.pipeline_param_specs() == want


@pytest.mark.parametrize("case", ["layers", "batch"])
def test_indivisible_shapes_raise_jaxs_errors(case):
    cfg = tl.llama_tiny(max_seq_len=32)  # 2 layers
    pp = 4 if case == "layers" else 2
    mesh = tmesh.Mesh(None, torch.device("cpu"), axes=(("pp",), (pp,)))
    tokens = torch.zeros((6 if case == "batch" else 4, 8), dtype=torch.long)
    match = "not divisible by pp" if case == "layers" else "not divisible by n_microbatches"
    with pytest.raises(ValueError, match=match):
        tp.pipelined_forward({}, tokens, cfg, mesh, n_microbatches=4)
    jcfg = jl.llama_tiny(max_seq_len=32)
    with pytest.raises(ValueError, match=match):
        jp.pipelined_forward({}, jnp.zeros(tuple(tokens.shape), jnp.int32), jcfg, _jmesh(pp),
                             n_microbatches=4)
