"""Rank programs for the MoE mesh tests (``test_torch_moe_mesh.py``).

The functions below run inside spawned ranks of one gloo group on the
CPU (``tpuslo_torch.parallel.mesh.run_ranks``), so this module imports
neither JAX nor the JAX package: a spawned rank imports the module that
defines its function.  The JAX side of each comparison runs in the test
process and hands the ranks its weights and inputs as numpy.

Each program serves f32 ``mixtral_tiny`` (4 query heads over 2 kv
heads, FFN 128, 4 experts, top 2, vocabulary 512) through every MoE
engine over the meshes of its group, and returns what each emitted.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tpuslo_torch.parallel import mesh as mesh_mod  # noqa: E402

RANK_TIMEOUT_S = 240.0
#: The JAX MoE mesh tests' engine settings (``tests/test_moe_sharded.py``).
ENGINE_KW = {"prefill_buckets": (16, 32), "decode_chunk_size": 4}


def f32_tiny():
    from tpuslo_torch.models import mixtral

    return dataclasses.replace(mixtral.mixtral_tiny(max_seq_len=128), dtype=torch.float32)


def streams(engine, prompts, n):
    return [[e.token_id for e in engine.generate(p, n, stop_at_eos=False)] for p in prompts]


def drive(engine, prompts, n):
    ids = [engine.submit(p, max_new_tokens=n, stop_at_eos=False) for p in prompts]
    results = engine.run()
    return [results[i] for i in ids]


def _engines(cfg, params, mesh, script: dict, kv_dtype: str = "bf16") -> dict:
    """What the three MoE engines emit over ``mesh`` (or none)."""
    from tpuslo_torch.models import mixtral

    eng = mixtral.MoEServeEngine(cfg, params, mesh=mesh, kv_dtype=kv_dtype, device="cpu",
                                 **ENGINE_KW)
    logits, _ = eng.prefill_ids(script["prefill_ids"])
    batched = mixtral.MoEContinuousBatchingEngine(cfg, params, max_slots=2, mesh=mesh,
                                                  kv_dtype=kv_dtype, device="cpu", **ENGINE_KW)
    paged = mixtral.MoEPagedBatchingEngine(cfg, params, max_slots=2, block_size=16, mesh=mesh,
                                           kv_dtype=kv_dtype, device="cpu", **ENGINE_KW)
    return {"logits": logits, "streams": streams(eng, script["prompts"], script["n"]),
            "batching": drive(batched, script["batch_prompts"], script["batch_n"]),
            "paged": drive(paged, script["batch_prompts"], script["batch_n"]),
            "engine": eng, "paged_engine": paged}


def _sharded_mlp(cases: list[dict], mesh) -> list[dict]:
    """``moe_mlp_sharded`` on each case over ``mesh``'s ep axis: this rank's
    rows from the whole tree and from its placed shard, the mesh's calls."""
    from tpuslo_torch.ops import moe

    out = []
    for case in cases:
        cfg = moe.MoEConfig(**case["cfg"], dtype=torch.float32)
        params = {k: torch.tensor(v) for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"])
        mesh.reset_counts()
        whole = moe.moe_mlp_sharded(params, x, cfg, mesh)
        calls = dict(mesh.calls)
        shard = moe.moe_mlp_sharded(moe.place_moe_params(params, mesh), x, cfg, mesh)
        out.append({"rows": whole.numpy(), "from_shard_equal": bool(torch.equal(whole, shard)),
                    "calls": calls})
    return out


def moe_mesh_serving(rank: int, world: int, params_np: dict, script: dict,
                     cases: list[dict]) -> dict:
    """One rank of a tp and an ep group over the same ranks: every MoE
    engine over each mesh (and int8 KV under tp), the shards each rank
    holds, its cache shapes, the collectives of one stream, a sharded
    init against the whole tree it was cut from, and ``moe_mlp_sharded``
    on ``cases`` over the ep mesh."""
    from tpuslo_torch.models import bridge, mixtral

    torch.set_num_threads(1)
    cfg = f32_tiny()
    params = bridge.params_from_numpy(params_np, cfg, "cpu")
    out: dict = {}
    for axis, mesh in (("tp", mesh_mod.tp_mesh(world, devices=["cpu"])),
                       ("ep", mesh_mod.ep_mesh(world, devices=["cpu"]))):
        got = _engines(cfg, params, mesh, script)
        eng, paged = got.pop("engine"), got.pop("paged_engine")
        got["logits"] = got["logits"].numpy()
        got["shard_shapes"] = {n: tuple(t.shape) for n, t in eng.params["layers"].items()}
        got["embed_shape"] = tuple(eng.params["embed"].shape)
        got["cache_shape"] = tuple(eng._new_cache(1)["k"].shape)
        got["pool_shape"] = tuple(paged._cache["k"].shape)
        got["tp_ep"] = (eng.tp, eng.ep)
        got["sharded_tree_kept"] = mixtral.MoEServeEngine(
            cfg, eng.params, mesh=mesh, device="cpu").params is eng.params
        mesh.reset_counts()
        streams(eng, script["prompts"][:1], script["n"])
        got["calls_one_stream"] = dict(mesh.calls)
        fresh = mixtral.MoEServeEngine(cfg, mesh=mesh, rng_seed=3, device="cpu", **ENGINE_KW)
        whole = mixtral.init_params(3, cfg, "cpu")
        layout = (mixtral.tp_serve_param_shardings(mesh) if axis == "tp"
                  else mixtral.ep_serve_param_shardings(mesh))
        cut = bridge.shard_moe_serve_params(whole, layout, world, mesh.rank(axis))
        got["sharded_init"] = {
            "w1": tuple(fresh.params["layers"]["w1"].shape),
            "wq": tuple(fresh.params["layers"]["wq"].shape),
            "equal_to_the_cut": all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(fresh.params), _leaves(cut))),
            "tokens": len(streams(fresh, ["sharded init"], 4)[0]),
        }
        out[axis] = got
    tp = mesh_mod.tp_mesh(world, devices=["cpu"])
    out["tp_int8"] = {k: v for k, v in _engines(cfg, params, tp, script, "int8").items()
                      if k in ("streams", "batching", "paged")}
    out["sharded_mlp"] = _sharded_mlp(cases, mesh_mod.ep_mesh(world, devices=["cpu"]))
    return out


def _leaves(tree: dict) -> list:
    return [tree["embed"], *[tree["layers"][k] for k in sorted(tree["layers"])],
            tree["final_norm"], tree["output"]]


def moe_sharded_mlp(rank: int, world: int, cases: list[dict]) -> list[dict]:
    """``moe_mlp_sharded`` on ``cases`` over an ep mesh of the group."""
    torch.set_num_threads(1)
    return _sharded_mlp(cases, mesh_mod.ep_mesh(world, devices=["cpu"]))


def moe_mesh_one(rank: int, world: int, params_np: dict, script: dict) -> dict:
    """tp 1 and ep 1 over a one-rank group against the engines without a
    mesh: each one's prefill logits (tensors, for ``torch.equal``) and
    streams, and each mesh's collectives."""
    from tpuslo_torch.models import bridge

    cfg = f32_tiny()
    params = bridge.params_from_numpy(params_np, cfg, "cpu")
    out: dict = {}
    for name, mesh in (("tp", mesh_mod.tp_mesh(1, devices=["cpu"])),
                       ("ep", mesh_mod.ep_mesh(1, devices=["cpu"])), ("plain", None)):
        got = _engines(cfg, params, mesh, script)
        del got["engine"], got["paged_engine"]
        got["calls"] = {} if mesh is None else dict(mesh.calls)
        out[name] = got
    return out
