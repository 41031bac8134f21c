"""Mixtral serving over tp and ep meshes, and the token-sharded expert
exchange: the port's engines over gloo ranks on the CPU against the JAX
engines over ``Mesh(devices[:n], ("tp",))`` and ``("ep",)`` on JAX's
virtual CPU devices.

Both sides serve the same f32 ``mixtral_tiny`` weights (4 query heads
over 2 kv heads, FFN 128, 4 experts, top 2, vocabulary 512: tp 2 and ep
2 divide them), drawn by JAX and carried over as numpy.  The port's side
runs once per world size in spawned ranks (``test_torch_moe_mesh_ranks``),
every engine of a world in one group, and each test reads its part:

* tp 2 and ep 2 prefill logits within 1e-4 of JAX's tp 2 and ep 2
  engines (f32; the partial sums are added in another order than XLA's);
* greedy streams identical to JAX's for ``MoEServeEngine``, the
  continuous engine and the paged engine over each mesh, and for int8 KV
  under tp (mirrors of ``tests/test_moe_sharded.py`` and the tp, int8 and
  paged tests of ``tests/test_mixtral.py``);
* ``moe_mlp_sharded`` at ep 2 and ep 4 within 1e-5 of JAX's, in a config
  that drops tokens and in a drop-free one, and there also within 1e-5 of
  the port's ``moe_mlp``;
* every shard equal to JAX's ``addressable_shards[r].data``, the sharded
  init equal to the shards of the whole tree, tp 1 and ep 1 over one rank
  bit for bit the engines without a mesh, ``mesh=None`` calling no
  collective, and JAX's messages for the meshes it refuses.
"""

from __future__ import annotations

import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_moe_mesh_ranks as ranks  # noqa: E402
from tpuslo.models import mixtral as jm  # noqa: E402
from tpuslo.ops import moe as jmoe  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402
from tpuslo_torch.ops import moe as tmoe  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

LOGIT_TOL = 1e-4
MLP_TOL = 1e-5
CFG_J = dataclasses.replace(jm.mixtral_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = ranks.f32_tiny()
SCRIPT = {
    "prefill_ids": [256, 104, 105, 33],
    "prompts": ["moe mesh parity", "a longer prompt for the sharded experts"],
    "n": 12,
    "batch_prompts": ["tp moe batch", "second moe mesh request", "third"],
    "batch_n": 6,
}
# (name, MoEConfig fields, tokens): both at 8 experts, top 2; the first
# drops tokens at each rank's capacity, the second (cf = E / k) drops none.
MLP_CASES = [("drops", dict(dim=32, ffn_dim=64, n_experts=8, top_k=2, capacity_factor=1.0), 32),
             ("drop_free", dict(dim=32, ffn_dim=64, n_experts=8, top_k=2,
                                capacity_factor=4.0), 32)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(axis: str, n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (axis,))


@pytest.fixture(scope="module")
def weights():
    return jm.init_params(jax.random.PRNGKey(0), CFG_J)


@pytest.fixture(scope="module")
def mlp_cases():
    """Each case's JAX config, weights (f32 numpy) and tokens."""
    out = []
    for i, (name, fields, T) in enumerate(MLP_CASES):
        cj = jmoe.MoEConfig(**fields, dtype=jnp.float32)
        pj = jmoe.init_moe_params(jax.random.PRNGKey(10 + i), cj)
        x = np.random.default_rng(20 + i).standard_normal((T, cj.dim)).astype(np.float32)
        out.append({"name": name, "cfg": fields, "jax_cfg": cj, "params": _np(pj), "x": x})
    return out


def _rank_cases(cases):
    return [{k: c[k] for k in ("cfg", "params", "x")} for c in cases]


@pytest.fixture(scope="module")
def port(weights, mlp_cases):
    """One group of 2 gloo ranks running every engine over tp 2 and ep 2,
    and moe_mlp_sharded at ep 2: each rank's observations, in rank order."""
    return tmesh.run_ranks(ranks.moe_mesh_serving, 2, timeout_s=ranks.RANK_TIMEOUT_S,
                           args=(_np(weights), SCRIPT, _rank_cases(mlp_cases)))


@pytest.fixture(scope="module")
def port_ep4(mlp_cases):
    return tmesh.run_ranks(ranks.moe_sharded_mlp, 4, timeout_s=ranks.RANK_TIMEOUT_S,
                           args=(_rank_cases(mlp_cases),))


@pytest.fixture(scope="module")
def port_one(weights):
    (got,) = tmesh.run_ranks(ranks.moe_mesh_one, 1, timeout_s=ranks.RANK_TIMEOUT_S,
                             args=(_np(weights), SCRIPT))
    return got


_JAX: dict = {}


def _jax_side(weights, axis: str, kv_dtype: str = "bf16") -> dict:
    """What JAX's three MoE engines emit over a 2-device ``axis`` mesh
    (computed once per axis and KV dtype)."""
    key = (axis, kv_dtype)
    if key not in _JAX:
        mesh = _mesh(axis, 2)
        kw = dict(cfg=CFG_J, params=weights, mesh=mesh, kv_dtype=kv_dtype, **ranks.ENGINE_KW)
        eng = jm.MoEServeEngine(**kw)
        logits, _ = eng.prefill_ids(SCRIPT["prefill_ids"])
        got = {"logits": np.asarray(logits, np.float32),
               "streams": ranks.streams(eng, SCRIPT["prompts"], SCRIPT["n"])}
        for name, cls, extra in (("batching", jm.MoEContinuousBatchingEngine, {}),
                                 ("paged", jm.MoEPagedBatchingEngine, {"block_size": 16})):
            got[name] = ranks.drive(cls(max_slots=2, **extra, **kw), SCRIPT["batch_prompts"],
                                    SCRIPT["batch_n"])
        _JAX[key] = got
    return _JAX[key]


# --- the group of two ranks --------------------------------------------------


def test_ranks_observe_the_same(port):
    """Every rank holds the whole logits and samples the same tokens."""
    a, b = port
    for axis in ("tp", "ep"):
        for key in ("streams", "batching", "paged", "calls_one_stream"):
            assert a[axis][key] == b[axis][key], (axis, key)
        np.testing.assert_array_equal(a[axis]["logits"], b[axis]["logits"])
    assert a["tp_int8"] == b["tp_int8"]


def test_tp_ranks_hold_their_shards_and_their_kv_heads(port):
    got = port[0]["tp"]
    L, D, F, E, HD = CFG_T.n_layers, CFG_T.dim, CFG_T.ffn_dim, CFG_T.n_experts, CFG_T.head_dim
    assert got["shard_shapes"]["wq"] == (L, D, 2 * HD)
    assert got["shard_shapes"]["wk"] == (L, D, 1 * HD)
    assert got["shard_shapes"]["router"] == (L, D, E)
    assert got["shard_shapes"]["w1"] == got["shard_shapes"]["w3"] == (L, E, D, F // 2)
    assert got["shard_shapes"]["w2"] == (L, E, F // 2, D)
    assert got["embed_shape"] == (CFG_T.vocab_size // 2, D)
    assert got["cache_shape"] == (L, 1, CFG_T.max_seq_len, 1, HD)
    assert got["pool_shape"][3] == 1 and got["tp_ep"] == (2, 1)
    assert got["sharded_tree_kept"]


def test_ep_ranks_hold_half_the_experts_and_everything_else_whole(port):
    got = port[1]["ep"]
    L, D, F, E, HD = CFG_T.n_layers, CFG_T.dim, CFG_T.ffn_dim, CFG_T.n_experts, CFG_T.head_dim
    assert got["shard_shapes"]["w1"] == got["shard_shapes"]["w3"] == (L, E // 2, D, F)
    assert got["shard_shapes"]["w2"] == (L, E // 2, F, D)
    assert got["shard_shapes"]["wq"] == (L, D, CFG_T.n_heads * HD)
    assert got["embed_shape"] == (CFG_T.vocab_size, D)
    assert got["cache_shape"] == (L, 1, CFG_T.max_seq_len, CFG_T.n_kv_heads, HD)
    assert got["pool_shape"][3] == CFG_T.n_kv_heads and got["tp_ep"] == (1, 2)
    assert got["sharded_tree_kept"]


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_prefill_logits_match_jax(port, weights, axis):
    np.testing.assert_allclose(port[0][axis]["logits"], _jax_side(weights, axis)["logits"],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("engine", ["streams", "batching", "paged"])
@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_greedy_streams_equal_jax(port, weights, axis, engine):
    """``MoEServeEngine.generate``, the continuous engine and the paged
    engine over each mesh, against JAX's engine of the same kind over its
    mesh (three requests through two slots: one queues)."""
    want = _jax_side(weights, axis)[engine]
    assert port[0][axis][engine] == want
    n = SCRIPT["n"] if engine == "streams" else SCRIPT["batch_n"]
    assert [len(s) for s in want] == [n] * len(want)


@pytest.mark.parametrize("engine", ["streams", "batching", "paged"])
def test_int8_kv_under_tp_equals_jax(port, weights, engine):
    assert port[0]["tp_int8"][engine] == _jax_side(weights, "tp", "int8")[engine]


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_batched_streams_equal_the_unsharded_single_request_engine(port, weights, axis):
    """The schedulers ride each mesh unchanged: each batched request's
    stream is JAX's unsharded single-request stream (the claim of JAX's
    ``test_moe_batched_tensor_parallel_matches_single_device`` and
    ``test_ep_moe_continuous_batching_matches_plain``)."""
    single = jm.MoEServeEngine(cfg=CFG_J, params=weights, **ranks.ENGINE_KW)
    want = ranks.streams(single, SCRIPT["batch_prompts"], SCRIPT["batch_n"])
    assert port[0][axis]["batching"] == want
    assert port[0][axis]["paged"] == want


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_one_stream_reduces_once_per_moe_block(port, axis):
    """Per pass, tp: the embedding's all_reduce, wo's and the MoE block's
    in each layer, one all_gather of the logits; ep: the MoE block's one
    all_reduce per layer, nothing else."""
    calls = port[0][axis]["calls_one_stream"]
    L = CFG_T.n_layers
    if axis == "tp":
        passes = calls["all_gather"]
        assert set(calls) == {"all_reduce", "all_gather"}
        assert calls["all_reduce"] == passes * (1 + 2 * L)
    else:
        assert set(calls) == {"all_reduce"} and calls["all_reduce"] % L == 0


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_sharded_init_keeps_only_the_rank_shard(port, axis):
    """``params=None`` with a mesh draws the tree leaf by leaf and keeps
    the rank's shard: the shards of ``init_params`` on the same seed."""
    for r, rank in enumerate(port):
        got = rank[axis]["sharded_init"]
        assert got["equal_to_the_cut"], r
        assert got["tokens"] == 4
    L, D, F, E = CFG_T.n_layers, CFG_T.dim, CFG_T.ffn_dim, CFG_T.n_experts
    HQ = CFG_T.n_heads * CFG_T.head_dim
    want = {"tp": ((L, E, D, F // 2), (L, D, HQ // 2)), "ep": ((L, E // 2, D, F), (L, D, HQ))}
    got = port[0][axis]["sharded_init"]
    assert (got["w1"], got["wq"]) == want[axis]


# --- the token-sharded expert exchange ---------------------------------------


def _jax_sharded(case, n: int) -> np.ndarray:
    x = jnp.asarray(case["x"])
    return np.asarray(jmoe.moe_mlp_sharded(case["params"], x, case["jax_cfg"],
                                           _mesh("ep", n)))


@pytest.mark.parametrize("case", range(len(MLP_CASES)), ids=[c[0] for c in MLP_CASES])
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_mlp_sharded_matches_jax(port, port_ep4, mlp_cases, ep, case):
    """Each rank's rows, stacked in rank order, against JAX's output; the
    rank's placed shard gives the same bits as the whole tree, and each
    call exchanges twice."""
    ranks_out = [r["sharded_mlp"][case] for r in port] if ep == 2 else [
        r[case] for r in port_ep4]
    got = np.concatenate([r["rows"] for r in ranks_out])
    np.testing.assert_allclose(got, _jax_sharded(mlp_cases[case], ep), atol=MLP_TOL, rtol=0)
    for r in ranks_out:
        assert r["from_shard_equal"] and r["calls"] == {"all_to_all": 2}


def test_the_cases_drop_where_jax_drops(mlp_cases):
    """The first case drops choices at every rank's capacity, at ep 2 and
    ep 4; the second drops none."""
    for case, dropping in zip(mlp_cases, (True, False)):
        cj = case["jax_cfg"]
        for ep in (2, 4):
            for rows in np.split(case["x"], ep):
                logits = jmoe.router_logits(case["params"], jnp.asarray(rows))
                dispatch, _ = jmoe._routing(logits, cj, cj.capacity(rows.shape[0]))
                dropped = rows.shape[0] * cj.top_k - int(np.asarray(dispatch).sum())
                assert (dropped > 0) == dropping, (case["name"], ep)


@pytest.mark.parametrize("ep", [2, 4])
def test_drop_free_sharded_equals_moe_mlp(port, port_ep4, mlp_cases, ep):
    """Without drops the exchange computes the block itself: the port's
    sharded rows within 1e-5 of its ``moe_mlp`` over the whole batch."""
    case = mlp_cases[1]
    cfg = tmoe.MoEConfig(**case["cfg"], dtype=torch.float32)
    params = {k: torch.tensor(v) for k, v in case["params"].items()}
    want = tmoe.moe_mlp(params, torch.from_numpy(case["x"]), cfg).numpy()
    rows = [r["sharded_mlp"][1]["rows"] for r in port] if ep == 2 else [
        r[1]["rows"] for r in port_ep4]
    np.testing.assert_allclose(np.concatenate(rows), want, atol=MLP_TOL, rtol=0)


# --- layouts, shards and refusals --------------------------------------------


def _jax_split(spec, axis: str):
    return list(spec).index(axis) if axis in spec else None


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_the_layout_tables_name_jaxs_split_dims(axis):
    fake = tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=((axis,), (2,)))
    if axis == "tp":
        want_tree = jm.tp_serve_param_shardings(_mesh("tp", 2))
        got = tm.tp_serve_param_shardings(fake)
    else:
        want_tree = jm.ep_serve_param_shardings(_mesh("ep", 2))
        got = tm.ep_serve_param_shardings(fake)
        assert got == tm.param_shardings(fake)
        assert _flat_splits(jm.param_shardings(_mesh("ep", 2)), "ep") == got
    assert _flat_splits(want_tree, axis) == got


def _flat_splits(tree, axis: str) -> dict:
    """A JAX shardings tree as the port's table: path -> split dim."""
    out = {k: _jax_split(v.spec, axis) for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": _jax_split(v.spec, axis) for k, v in tree["layers"].items()})
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_shard_moe_serve_params_equal_jax_addressable_shards(weights, axis, n):
    mesh = _mesh(axis, n)
    shardings = (jm.tp_serve_param_shardings(mesh) if axis == "tp"
                 else jm.ep_serve_param_shardings(mesh))
    placed = jax.device_put(weights, shardings)
    full = bridge.params_from_numpy(_np(weights), CFG_T, "cpu")
    layout = bridge.MOE_TP_SPLIT_AXIS if axis == "tp" else bridge.MOE_EP_SPLIT_AXIS
    for r in range(n):
        got = bridge.params_to_numpy(bridge.shard_moe_serve_params(full, layout, n, r))
        got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            shard = next(s for s in leaf.addressable_shards if s.device == mesh.devices[r])
            np.testing.assert_array_equal(got_flat[path], np.asarray(shard.data),
                                          err_msg=jax.tree_util.keystr(path))


def _fake(axes: tuple, sizes: tuple):
    return tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=(axes, sizes))


@pytest.mark.parametrize("case", ["both", "neither", "tp_indivisible", "ep_indivisible"])
def test_refused_meshes_raise_jaxs_messages(case):
    """Raised before any collective, so mesh objects without ranks behind
    them show it."""
    devs = np.array(jax.devices()[:4])
    jax_mesh, port_mesh = {
        "both": (Mesh(devs.reshape(2, 2), ("tp", "ep")), _fake(("tp", "ep"), (2, 2))),
        "neither": (Mesh(devs[:2], ("dp",)), _fake(("dp",), (2,))),
        "tp_indivisible": (Mesh(devs, ("tp",)), _fake(("tp",), (4,))),
        "ep_indivisible": (Mesh(devs[:3], ("ep",)), _fake(("ep",), (3,))),
    }[case]
    with pytest.raises(ValueError) as jax_err:
        jm.MoEServeEngine(cfg=CFG_J, mesh=jax_mesh)
    with pytest.raises(ValueError) as port_err:
        tm.MoEServeEngine(cfg=CFG_T, mesh=port_mesh, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    for cls in (tm.MoEContinuousBatchingEngine, tm.MoEPagedBatchingEngine):
        with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
            cls(cfg=CFG_T, mesh=port_mesh, device="cpu")


# --- one rank, and no mesh ----------------------------------------------------


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_one_rank_is_bit_for_bit_the_engines_without_a_mesh(port_one, axis):
    got, plain = port_one[axis], port_one["plain"]
    assert torch.equal(got["logits"], plain["logits"])
    for key in ("streams", "batching", "paged"):
        assert got[key] == plain[key], key
    assert got["calls"]["all_reduce"] > 0


def test_mesh_none_calls_no_collective(weights, monkeypatch):
    """Without a mesh the engines run no collective: each wrapper raises
    if called, and the streams are JAX's unsharded ones."""
    def refuse(*a, **k):
        raise AssertionError("a collective without a mesh")

    for name in ("all_reduce", "all_gather", "reduce_scatter", "shift", "all_to_all"):
        monkeypatch.setattr(tmesh, name, refuse)
    params = bridge.params_from_numpy(_np(weights), CFG_T, "cpu")
    eng = tm.MoEServeEngine(CFG_T, params, device="cpu", **ranks.ENGINE_KW)
    assert type(eng.params) is dict and eng.mesh is None and (eng.tp, eng.ep) == (1, 1)
    want = ranks.streams(jm.MoEServeEngine(cfg=CFG_J, params=weights, **ranks.ENGINE_KW),
                         SCRIPT["prompts"][:1], SCRIPT["n"])
    assert ranks.streams(eng, SCRIPT["prompts"][:1], SCRIPT["n"]) == want
    paged = tm.MoEPagedBatchingEngine(CFG_T, params, max_slots=2, block_size=16,
                                      device="cpu", **ranks.ENGINE_KW)
    assert ranks.drive(paged, SCRIPT["prompts"][:1], SCRIPT["n"]) == want
