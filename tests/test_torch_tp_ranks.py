"""Rank programs for the port's multi-device tests, and the rank launcher
they run on (``tpuslo_torch.parallel.mesh.run_ranks``).

The functions below run inside spawned ranks of one gloo group on the
CPU, so this module imports neither JAX nor the JAX package: a spawned
rank imports the module that defines its function.  The JAX side of each
comparison runs in the test process (``test_torch_tp_serve.py``,
``test_torch_collectives.py``, ``test_torch_mesh.py``) and hands the
ranks its weights as numpy.

The tests here hold the launcher itself: results come back in rank
order, a rank that fails kills the others under one deadline (they would
wait in a collective forever), and a group that outlives its deadline is
killed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuslo_torch.parallel import mesh as mesh_mod  # noqa: E402

RANK_TIMEOUT_S = 240.0


# --- rank programs ---------------------------------------------------------


def mesh_axes(rank: int, world: int, slices: int = 1) -> dict:
    """``make_mesh(plan_for_devices(world, slices))``'s axes seen by this
    rank, and a sum over each axis of the rank's id."""
    mesh = mesh_mod.make_mesh(mesh_mod.plan_for_devices(world, slices), devices=["cpu"])
    sums = {axis: int(mesh_mod.all_reduce(torch.tensor([float(rank)]), mesh, axis)[0])
            for axis in mesh.axis_names}
    return {"axis_names": list(mesh.axis_names), "shape": dict(mesh.shape),
            "ranks": {a: mesh.rank(a) for a in mesh.axis_names}, "sums": sums}


def collective_ops(rank: int, world: int, x_all: np.ndarray) -> dict:
    """Every wrapper over the tp axis on this rank's slice of ``x_all``
    (``(world, rows, cols)``), and the mesh's call counts."""
    mesh = mesh_mod.tp_mesh(world, devices=["cpu"])
    x = torch.from_numpy(x_all[rank])
    out = {
        "all_reduce": mesh_mod.all_reduce(x, mesh).numpy(),
        "all_gather": mesh_mod.all_gather(x, mesh, dim=0).numpy(),
        "reduce_scatter": mesh_mod.reduce_scatter(x, mesh, dim=0).numpy(),
        "shift": mesh_mod.shift(x, mesh).numpy(),
        "all_to_all": mesh_mod.all_to_all(x, mesh, split_dim=0, concat_dim=0).numpy(),
        "all_reduce_bf16": mesh_mod.all_reduce(x.bfloat16(), mesh).float().numpy(),
    }
    out["calls"] = dict(mesh.calls)
    return out


def probe_suite(rank: int, world: int) -> list[dict]:
    """``bench_collectives`` over every rank of the group, this rank's
    probes as dicts."""
    from tpuslo_torch.parallel.collectives import bench_collectives

    mesh = mesh_mod.tp_mesh(world, devices=["cpu"])
    return [p.to_dict() for p in bench_collectives(mesh=mesh, payload_bytes=16 << 10, reps=2)]


def failing_rank(rank: int, world: int) -> int:
    """Rank 1 raises; the others wait in a collective it never joins."""
    mesh = mesh_mod.tp_mesh(world, devices=["cpu"])
    if rank == 1:
        raise ValueError("rank 1 gave up")
    mesh_mod.all_reduce(torch.ones(4), mesh)
    return rank


def sleeping_rank(rank: int, world: int) -> int:
    time.sleep(60.0)
    return rank


def echo_rank(rank: int, world: int, tag: str) -> tuple:
    return (rank, world, tag)


def _f32_tiny(max_seq_len: int = 128):
    from tpuslo_torch.models import llama

    return dataclasses.replace(llama.llama_tiny(max_seq_len=max_seq_len), dtype=torch.float32)


def _streams(engine, prompts, n):
    return [[e.token_id for e in engine.generate(p, n, stop_at_eos=False)] for p in prompts]


def _drive(engine, prompts, n, prefix=None):
    ids = [engine.submit(p, max_new_tokens=n, stop_at_eos=False, prefix=prefix)
           for p in prompts]
    results = engine.run()
    return [results[i] for i in ids]


def tp_serving(rank: int, world: int, target_np: dict, target_q_np: dict, draft_np: dict,
               script: dict) -> dict:
    """One tp rank of every serving engine over the same JAX weights (f32
    ``llama_tiny``): what each engine emits, the prefill logits and the
    mesh's collective counts.  ``script`` holds the prompts and counts
    the test side runs on JAX's tp engines."""
    from tpuslo_torch.models import batching, bridge, frontdoor, paged_kv, serve, speculative

    torch.set_num_threads(1)
    cfg = _f32_tiny()
    mesh = mesh_mod.tp_mesh(world, devices=["cpu"])
    params = bridge.params_from_numpy(target_np, cfg, "cpu")
    qparams = bridge.params_from_numpy(target_q_np, cfg, "cpu")
    draft = serve.ServeEngine(cfg, bridge.params_from_numpy(draft_np, cfg, "cpu"), device="cpu")
    out: dict = {}

    eng = serve.ServeEngine(cfg, params, mesh=mesh, device="cpu")
    out["shard_shapes"] = {name: tuple(t.shape) for name, t in eng.params["layers"].items()}
    out["cache_shape"] = tuple(eng._new_cache(1)["k"].shape)
    logits, _ = eng.prefill_ids(script["prefill_ids"])
    out["prefill_logits"] = logits.numpy()
    out["streams"] = _streams(eng, script["prompts"], script["n"])
    out["batch"] = eng.generate_batch(script["batch_prompts"], max_new_tokens=4,
                                      stop_at_eos=False)
    mesh.reset_counts()
    _streams(eng, script["prompts"][:1], script["n"])
    out["calls_one_stream"] = dict(mesh.calls)

    plain = serve.ServeEngine(cfg, params, device="cpu")
    out["plain_streams"] = _streams(plain, script["prompts"], script["n"])

    # JAX's int8-KV stream-parity rule, sharded against unsharded.
    sharded8 = serve.ServeEngine(cfg, params, mesh=mesh, kv_dtype="int8", device="cpu")
    plain8 = serve.ServeEngine(cfg, params, kv_dtype="int8", device="cpu")
    out["int8_parity"] = serve.stream_parity(sharded8, plain8, "tp parity", max_new_tokens=8)

    quant = serve.ServeEngine(cfg, qparams, mesh=mesh, device="cpu")
    out["quantized"] = (quant.quantized, _streams(quant, ["int8 tp"], 6)[0])
    fresh = serve.ServeEngine(cfg, mesh=mesh, quantize=True, device="cpu")
    out["sharded_init"] = (fresh.quantized, tuple(fresh.params["layers"]["w1"]["q"].shape),
                           len(_streams(fresh, ["sharded init"], 4)[0]))

    cbe = batching.ContinuousBatchingEngine(cfg, params, max_slots=2, mesh=mesh, device="cpu")
    out["batching"] = _drive(cbe, script["paged_prompts"], 8)

    kw = dict(max_slots=2, block_size=16, device="cpu")
    pe = paged_kv.PagedBatchingEngine(cfg, params, mesh=mesh, **kw)
    out["pool_shape"] = tuple(pe._cache["k"].shape)
    out["paged"] = _drive(pe, script["paged_prompts"], 8)
    pk2 = paged_kv.PagedBatchingEngine(cfg, params, mesh=mesh, pallas_attention=True, **kw)
    out["paged_k2"] = _drive(pk2, script["paged_prompts"], 8)
    pi8 = paged_kv.PagedBatchingEngine(cfg, params, mesh=mesh, kv_dtype="int8", **kw)
    out["paged_int8"] = _drive(pi8, script["paged_prompts"][:2], 6)
    pp = paged_kv.PagedBatchingEngine(cfg, params, mesh=mesh, **kw)
    out["paged_prefix"] = _drive(pp, script["suffixes"], 8, prefix=script["prefix"])
    out["paged_prefix_stats"] = (pp.prefix_reuse_hits, pp.stats()["shared_prefixes"])
    single = serve.ServeEngine(cfg, params, device="cpu")
    out["prefix_single"] = [
        [e.token_id for e in single.generate(s, 8, stop_at_eos=False, prefix=script["prefix"])]
        for s in script["suffixes"]]

    spec = speculative.SpeculativeEngine(eng, draft, k=3)
    out["spec"] = spec.generate(script["prompts"][0], script["n"], stop_at_eos=False)
    out["spec_counts"] = (spec.rounds, spec.accepted_draft_tokens)

    fd = frontdoor.FrontDoorEngine(eng, draft, k=3, max_slots=2, max_queue=2)
    ids = [fd.submit(p, tenant=t, max_new_tokens=6, stop_at_eos=False)
           for p, t in script["frontdoor"]]
    results = fd.run()
    out["frontdoor"] = {
        "ids": ids, "results": {i: results[i] for i in ids if i is not None},
        "shed": dict(fd.shed_requests), "preemptions": fd.preemptions,
        "rounds": fd.rounds, "accepted": fd.accepted_draft_tokens,
    }
    return out


def tp1_bitwise(rank: int, world: int, target_np: dict, script: dict) -> dict:
    """tp 1 over a one-rank group against the same engines without a mesh:
    prefill logits and streams (each compared with ``torch.equal``)."""
    from tpuslo_torch.models import bridge, paged_kv, serve

    cfg = _f32_tiny()
    mesh = mesh_mod.tp_mesh(1, devices=["cpu"])
    params = bridge.params_from_numpy(target_np, cfg, "cpu")
    out = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        eng = serve.ServeEngine(cfg, params, mesh=m, device="cpu")
        logits, _ = eng.prefill_ids(script["prefill_ids"])
        pe = paged_kv.PagedBatchingEngine(cfg, params, mesh=m, max_slots=2, block_size=16,
                                          device="cpu")
        out[name] = {"logits": logits, "streams": _streams(eng, script["prompts"], script["n"]),
                     "paged": _drive(pe, script["paged_prompts"], 8)}
    out["calls"] = dict(mesh.calls)
    return out


# --- the launcher ------------------------------------------------------------


def test_results_come_back_in_rank_order():
    assert mesh_mod.run_ranks(echo_rank, 3, args=("x",), timeout_s=RANK_TIMEOUT_S) == [
        (0, 3, "x"), (1, 3, "x"), (2, 3, "x")]


def test_a_failed_rank_kills_the_others_under_one_deadline():
    """Rank 0 waits in an all_reduce that rank 1 never joins: the launcher
    sees rank 1's failure and kills rank 0 at once, well inside the
    deadline, and names the failure."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 gave up"):
        mesh_mod.run_ranks(failing_rank, 2, timeout_s=RANK_TIMEOUT_S)
    assert time.monotonic() - t0 < 60.0


def test_a_group_past_its_deadline_is_killed():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        mesh_mod.run_ranks(sleeping_rank, 2, timeout_s=5.0)
    assert time.monotonic() - t0 < 40.0
