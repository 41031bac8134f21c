"""Tensor-parallel serving: the port's engines over a tp mesh of gloo
ranks on the CPU against the JAX engines over ``Mesh(devices[:tp],
("tp",))`` on JAX's virtual CPU devices.

Both sides serve the same f32 ``llama_tiny`` weights (4 query heads over
2 kv heads, FFN 128, vocabulary 512: tp 2 divides them all), drawn by
JAX and carried over as numpy.  The port's side runs once per group in
spawned ranks (``test_torch_tp_ranks.tp_serving``), every engine in one
group, and each test reads its part:

* tp 2 prefill logits within 1e-4 of JAX's tp 2 (f32; the partial
  products are summed in another order than XLA's);
* greedy streams identical to JAX's tp 2 engine and to the port's
  unsharded engine, for ``ServeEngine``, ``generate_batch``, the
  batching and paged engines (plain pool attention and K2's plain
  version), a speculative engine with a tp target and an unsharded draft,
  and the front door over a tp engine (admissions, sheds, preemptions,
  rounds and streams equal to JAX's front door over its tp engine);
* JAX's int8-KV stream-parity rule (``tests/test_serve_sharded.py``),
  the quantized engine, the sharded init, paged int8 and shared-prefix
  parity (``tests/test_paged_sharded.py``);
* ``shard_serve_params`` leaves equal to the JAX mesh's
  ``addressable_shards[r].data``; an indivisible tp raises JAX's
  message; tp 1 over a one-rank group is bit for bit the engine without
  a mesh, and ``mesh=None`` calls no collective.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_tp_ranks as ranks  # noqa: E402
from tpuslo.models import batching as jb  # noqa: E402
from tpuslo.models import frontdoor as jfd  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import paged_kv as jp  # noqa: E402
from tpuslo.models import serve as js  # noqa: E402
from tpuslo.models import speculative as jsp  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import serve as ts  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

LOGIT_TOL = 1e-4
CFG_J = dataclasses.replace(jl.llama_tiny(max_seq_len=128), dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)
SCRIPT = {
    "prefill_ids": [256, 104, 105, 33, 10],
    "prompts": ["tp parity", "a longer prompt for the sharded engine"],
    "n": 12,
    "batch_prompts": ["a", "bb", "ccc"],
    "paged_prompts": ["tp paged one", "a different second request", "third"],
    "prefix": "system: shared preamble for tp. ",
    "suffixes": ["tp one", "tp two", "tp three"],
    "frontdoor": [("first", "a"), ("second one", "b"), ("third", "a"), ("fourth", "b"),
                  ("fifth", "a"), ("sixth", "b")],
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    target = jl.init_params(jax.random.PRNGKey(0), CFG_J)
    return {"target": target, "target_q": jl.quantize_params(target),
            "draft": jl.init_params(jax.random.PRNGKey(7), CFG_J)}


@pytest.fixture(scope="module")
def port(weights):
    """One tp 2 group of gloo ranks running every engine: each rank's
    observations, in rank order."""
    return tmesh.run_ranks(
        ranks.tp_serving, 2, timeout_s=ranks.RANK_TIMEOUT_S,
        args=(_np(weights["target"]), _np(weights["target_q"]), _np(weights["draft"]),
              SCRIPT))


def _tp_mesh(tp: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:tp]), ("tp",))


@pytest.fixture(scope="module")
def jax_tp(weights):
    """JAX's tp 2 engines over the same weights."""
    mesh = _tp_mesh(2)
    return {"engine": js.ServeEngine(cfg=CFG_J, params=weights["target"], mesh=mesh),
            "draft": js.ServeEngine(cfg=CFG_J, params=weights["draft"]),
            "mesh": mesh}


def _jax_streams(engine, prompts, n):
    return [[e.token_id for e in engine.generate(p, n, stop_at_eos=False)] for p in prompts]


def _jax_drive(engine, prompts, n, prefix=None):
    ids = [engine.submit(p, max_new_tokens=n, stop_at_eos=False, prefix=prefix)
           for p in prompts]
    results = engine.run()
    return [results[i] for i in ids]


def test_ranks_observe_the_same(port):
    """Every rank gathers the whole logits and samples the same tokens:
    both ranks' observations are equal."""
    a, b = port
    for key in ("streams", "batch", "plain_streams", "batching", "paged", "paged_k2",
                "paged_int8", "paged_prefix", "spec", "frontdoor"):
        assert a[key] == b[key], key
    np.testing.assert_array_equal(a["prefill_logits"], b["prefill_logits"])


def test_each_rank_holds_its_shards_and_its_kv_heads(port):
    got = port[0]
    D, F, HD = CFG_T.dim, CFG_T.ffn_dim, CFG_T.head_dim
    L = CFG_T.n_layers
    assert got["shard_shapes"]["wq"] == (L, D, 2 * HD)  # 2 of 4 heads
    assert got["shard_shapes"]["wk"] == (L, D, 1 * HD)  # 1 of 2 kv heads
    assert got["shard_shapes"]["wo"] == (L, 2 * HD, D)
    assert got["shard_shapes"]["w1"] == (L, D, F // 2)
    assert got["shard_shapes"]["w2"] == (L, F // 2, D)
    assert got["cache_shape"] == (L, 1, CFG_T.max_seq_len, 1, HD)
    assert got["pool_shape"][3] == 1


def test_tp2_prefill_logits_match_jax_tp2(port, jax_tp):
    want, _ = jax_tp["engine"].prefill_ids(SCRIPT["prefill_ids"])
    np.testing.assert_allclose(port[0]["prefill_logits"], np.asarray(want, np.float32),
                               atol=LOGIT_TOL, rtol=0)


def test_tp2_greedy_streams_equal_jax_tp2_and_the_unsharded_port(port, jax_tp):
    want = _jax_streams(jax_tp["engine"], SCRIPT["prompts"], SCRIPT["n"])
    assert port[0]["streams"] == want
    assert port[0]["plain_streams"] == want


def test_tp2_batch_generation_equals_jax(port, jax_tp):
    want = jax_tp["engine"].generate_batch(SCRIPT["batch_prompts"], max_new_tokens=4,
                                           stop_at_eos=False)
    assert port[0]["batch"] == want
    assert [len(r) for r in want] == [4, 4, 4]


def test_one_stream_reduces_twice_per_layer_and_gathers_once_per_pass(port):
    """Per pass: one all_reduce for the embedding, one after wo and one
    after w2 in each layer, one all_gather of the logits."""
    calls = port[0]["calls_one_stream"]
    passes = calls["all_gather"]
    assert calls["all_reduce"] == passes * (1 + 2 * CFG_T.n_layers)
    assert set(calls) == {"all_reduce", "all_gather"}


def test_int8_kv_stream_parity_rule(port):
    """JAX's rule (``tests/test_serve_sharded.py``): every position's
    teacher-forced logits within 7.5e-2 of the unsharded int8 engine, a
    flip only at a near-tie."""
    report = port[0]["int8_parity"]
    assert report["ok"], report
    assert len(report["tokens_candidate"]) == 8
    assert report["max_logit_diff"] < 7.5e-2
    if report["diverged_at"] is None:
        assert report["tokens_candidate"] == report["tokens_reference"]
    else:
        assert report["tie_margin"] < 0.15


def test_quantized_engine_generates(port, weights):
    quantized, stream = port[0]["quantized"]
    assert quantized and len(stream) == 6
    want = _jax_streams(js.ServeEngine(cfg=CFG_J, params=weights["target_q"], mesh=_tp_mesh(2)),
                        ["int8 tp"], 6)[0]
    assert stream == want


def test_sharded_init_keeps_only_the_rank_shard(port):
    quantized, w1_shape, n = port[0]["sharded_init"]
    assert quantized and n == 4
    assert w1_shape == (CFG_T.n_layers, CFG_T.dim, CFG_T.ffn_dim // 2)


def test_batching_engine_sharded_equals_jax(port, jax_tp, weights):
    eng = jb.ContinuousBatchingEngine(cfg=CFG_J, params=weights["target"], max_slots=2,
                                      mesh=jax_tp["mesh"])
    assert port[0]["batching"] == _jax_drive(eng, SCRIPT["paged_prompts"], 8)


def test_paged_tp_equals_jax_tp_and_the_single_device(port, jax_tp, weights):
    kw = dict(cfg=CFG_J, params=weights["target"], max_slots=2, block_size=16)
    want = _jax_drive(jp.PagedBatchingEngine(mesh=jax_tp["mesh"], **kw),
                      SCRIPT["paged_prompts"], 8)
    assert port[0]["paged"] == want
    assert port[0]["paged_k2"] == want  # K2 (its plain version here) on each rank's kv heads
    assert want == _jax_drive(jp.PagedBatchingEngine(**kw), SCRIPT["paged_prompts"], 8)


def test_paged_tp_int8_equals_jax(port, jax_tp, weights):
    eng = jp.PagedBatchingEngine(cfg=CFG_J, params=weights["target"], max_slots=2,
                                 block_size=16, kv_dtype="int8", mesh=jax_tp["mesh"])
    assert port[0]["paged_int8"] == _jax_drive(eng, SCRIPT["paged_prompts"][:2], 6)


def test_paged_tp_shared_prefix_parity(port):
    hits, shared = port[0]["paged_prefix_stats"]
    assert hits >= 1 and shared == 1
    assert port[0]["paged_prefix"] == port[0]["prefix_single"]


def test_speculative_round_with_a_tp_target_and_an_unsharded_draft(port, jax_tp):
    spec = jsp.SpeculativeEngine(jax_tp["engine"], jax_tp["draft"], k=3)
    want = spec.generate(SCRIPT["prompts"][0], SCRIPT["n"], stop_at_eos=False)
    assert port[0]["spec"] == want == port[0]["streams"][0]
    assert port[0]["spec_counts"] == (spec.rounds, spec.accepted_draft_tokens)


def test_front_door_over_a_tp_engine_equals_jax(port, jax_tp):
    fd = jfd.FrontDoorEngine(jax_tp["engine"], jax_tp["draft"], k=3, max_slots=2,
                             max_queue=2)
    ids = [fd.submit(p, tenant=t, max_new_tokens=6, stop_at_eos=False)
           for p, t in SCRIPT["frontdoor"]]
    results = fd.run()
    want = {"ids": ids, "results": {i: results[i] for i in ids if i is not None},
            "shed": dict(fd.shed_requests), "preemptions": fd.preemptions,
            "rounds": fd.rounds, "accepted": fd.accepted_draft_tokens}
    assert port[0]["frontdoor"] == want
    assert want["shed"], "the script sheds"


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_serve_params_equal_jax_addressable_shards(weights, quantized, tp):
    cfg = dataclasses.replace(CFG_T, n_kv_heads=4) if tp == 4 else CFG_T
    cfg_j = dataclasses.replace(CFG_J, n_kv_heads=4) if tp == 4 else CFG_J
    tree = jl.init_params(jax.random.PRNGKey(3), cfg_j)
    if quantized:
        tree = jl.quantize_params(tree)
    mesh = _tp_mesh(tp)
    placed = jax.device_put(tree, js.serve_param_shardings(tree, mesh))
    full = bridge.params_from_numpy(_np(tree), cfg, "cpu")
    for r in range(tp):
        got = bridge.params_to_numpy(bridge.shard_serve_params(full, tp, r))
        want_leaves = jax.tree_util.tree_leaves_with_path(placed)
        got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in want_leaves:
            shard = next(s for s in leaf.addressable_shards if s.device == mesh.devices[r])
            np.testing.assert_array_equal(got_flat[path], np.asarray(shard.data),
                                          err_msg=jax.tree_util.keystr(path))


def test_an_indivisible_tp_is_rejected_with_jaxs_message():
    """tp 4 over 2 kv heads: JAX's ``ValueError`` (raised before any
    collective, so a mesh object without ranks behind it shows it)."""
    with pytest.raises(ValueError, match="must divide") as jax_err:
        js.ServeEngine(cfg=CFG_J, mesh=_tp_mesh(4))
    fake = tmesh.Mesh(tmesh.MeshPlan(tp=4), torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="must divide") as port_err:
        ts.ServeEngine(cfg=CFG_T, mesh=fake, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    no_tp = tmesh.Mesh(tmesh.MeshPlan(), torch.device("cpu"), backend="gloo")
    no_tp.axis_names = ("dp",)
    with pytest.raises(ValueError, match="must have a 'tp' axis"):
        ts.ServeEngine(cfg=CFG_T, mesh=no_tp, device="cpu")


def test_tp1_over_a_one_rank_group_is_bit_for_bit_the_unsharded_engine(weights):
    (got,) = tmesh.run_ranks(ranks.tp1_bitwise, 1, timeout_s=ranks.RANK_TIMEOUT_S,
                             args=(_np(weights["target"]), SCRIPT))
    assert torch.equal(got["mesh"]["logits"], got["plain"]["logits"])
    assert got["mesh"]["streams"] == got["plain"]["streams"]
    assert got["mesh"]["paged"] == got["plain"]["paged"]
    assert got["calls"]["all_reduce"] > 0 and got["calls"]["all_gather"] > 0


def test_mesh_none_calls_no_collective(weights, monkeypatch):
    """Without a mesh the engines run no collective: each wrapper raises
    if called, and the streams are JAX's unsharded ones."""
    def refuse(*a, **k):
        raise AssertionError("a collective without a mesh")

    for name in ("all_reduce", "all_gather", "reduce_scatter", "shift", "all_to_all"):
        monkeypatch.setattr(tmesh, name, refuse)
    params = bridge.params_from_numpy(_np(weights["target"]), CFG_T, "cpu")
    eng = ts.ServeEngine(CFG_T, params, device="cpu")
    assert type(eng.params) is dict and eng.mesh is None and eng.tp == 1
    want = _jax_streams(js.ServeEngine(cfg=CFG_J, params=weights["target"]),
                        SCRIPT["prompts"][:1], SCRIPT["n"])
    assert ranks._streams(eng, SCRIPT["prompts"][:1], SCRIPT["n"]) == want


def test_graphed_paths_refuse_gloo_over_cuda_tensors():
    """A CUDA graph cannot capture a collective that goes through host
    memory: a speculative or front-door pair over a gloo mesh of CUDA
    tensors is refused, naming why; over NCCL, or gloo on the CPU, the
    mesh is capturable."""
    from types import SimpleNamespace

    from tpuslo_torch.models import speculative as tsp

    cuda = torch.device("cuda", 0)
    gloo_cuda = tmesh.Mesh(tmesh.MeshPlan(tp=2), cuda, backend="gloo")
    assert not gloo_cuda.graph_capturable
    assert tmesh.Mesh(tmesh.MeshPlan(tp=2), cuda, backend="nccl").graph_capturable
    assert tmesh.Mesh(tmesh.MeshPlan(tp=2), torch.device("cpu"), backend="gloo").graph_capturable
    target = SimpleNamespace(device=cuda, mesh=gloo_cuda)
    draft = SimpleNamespace(device=cuda, mesh=None)
    with pytest.raises(ValueError, match="cannot capture collectives"):
        tsp._check_pair(target, draft)
