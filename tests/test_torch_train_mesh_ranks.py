"""Rank programs for the sharded training and pipeline tests
(``test_torch_pipeline.py``, ``test_torch_train_mesh.py``,
``test_torch_moe_train_mesh.py``).

The functions below run inside spawned ranks of one gloo group on the
CPU (``tpuslo_torch.parallel.mesh.run_ranks``), so this module imports
neither JAX nor the JAX package: a spawned rank imports the module that
defines its function.  The JAX side of each comparison runs in the test
process and hands the ranks its weights and inputs as numpy; the ranks
hand back whole trees (gathered over their mesh) as numpy.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuslo_torch.parallel import mesh as mesh_mod  # noqa: E402

RANK_TIMEOUT_S = 300.0
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _threads(world: int) -> None:
    """Each rank takes its share of the host's cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def llama_cfg(dtype: str, n_layers: int = 2, max_seq_len: int = 64):
    from tpuslo_torch.models import llama

    return dataclasses.replace(llama.llama_tiny(max_seq_len=max_seq_len),
                               n_layers=n_layers, dtype=DTYPES[dtype])


def mixtral_cfg(dtype: str = "f32"):
    from tpuslo_torch.models import mixtral

    return dataclasses.replace(mixtral.mixtral_tiny(max_seq_len=64), dtype=DTYPES[dtype])


def _np_tree(tree: dict) -> dict:
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().float().numpy()
            for k, v in tree.items()}


def cotangent(rank: int, cols: int = 4) -> torch.Tensor:
    """Rank ``rank``'s cotangent for a (2, ``cols``) collective output."""
    return torch.arange(2 * cols, dtype=torch.float32).reshape(2, cols) * (rank + 1) + 0.5 * rank


def autograd_collectives_rank(rank: int, world: int) -> dict:
    """Each collective under autograd on this rank's x (2, 4): the gradient
    of ``sum(y * cotangent)`` for its output ``y``, and the calls made."""
    mesh = mesh_mod.tp_mesh(world, devices=["cpu"])
    ops = {
        "all_reduce": lambda x: mesh_mod.all_reduce(x, mesh, "tp"),
        "copy_to": lambda x: mesh_mod.copy_to(x, mesh, "tp"),
        "reduce_from": lambda x: mesh_mod.reduce_from(x, mesh, "tp"),
        "all_gather": lambda x: mesh_mod.all_gather(x, mesh, "tp", dim=1),
        "reduce_scatter": lambda x: mesh_mod.reduce_scatter(x, mesh, "tp", dim=1),
        "shift": lambda x: mesh_mod.shift(x, mesh, "tp", 1),
        "all_to_all": lambda x: mesh_mod.all_to_all(x, mesh, "tp", 1, 1),
    }
    out = {}
    for name, op in ops.items():
        x = (torch.arange(8, dtype=torch.float32).reshape(2, 4) + 10 * rank).requires_grad_()
        mesh.reset_counts()
        y = op(x)
        (y * cotangent(rank, y.shape[1])).sum().backward()
        out[name] = {"grad": x.grad.numpy(), "calls": dict(mesh.calls)}
    return out


def pipeline_rank(rank: int, world: int, params_np: dict, tokens: np.ndarray,
                  targets: np.ndarray, forwards: list[tuple[str, int]],
                  grad_microbatches: int | None) -> dict:
    """One stage of a ``pp = world`` pipeline over llama_tiny at 8 layers:
    ``pipelined_forward``'s logits for each ``(dtype, n_microbatches)``
    in ``forwards``, and with ``grad_microbatches`` ``pipelined_loss`` in
    f32 and its gradients gathered whole over the stages."""
    from tpuslo_torch.models import bridge, llama, train
    from tpuslo_torch.parallel import pipeline

    _threads(world)
    mesh = mesh_mod.pp_mesh(world, devices=["cpu"])
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    out: dict = {"logits": {}, "stage_layers": None}
    for dtype, n_mb in forwards:
        cfg = llama_cfg(dtype, n_layers=8)
        params = bridge.params_from_numpy(params_np, cfg, "cpu")
        placed = pipeline.place_pipeline_params(params, mesh)
        out["stage_layers"] = placed["layers"]["wq"].shape[0]
        mesh.reset_counts()
        with torch.no_grad():
            logits = pipeline.pipelined_forward(placed, tok, cfg, mesh, n_microbatches=n_mb)
        out["logits"][(dtype, n_mb)] = logits.numpy()
        out.setdefault("forward_calls", {})[(dtype, n_mb)] = dict(mesh.calls)
    if grad_microbatches is not None:
        cfg = llama_cfg("f32", n_layers=8)
        placed = train.trainable(pipeline.place_pipeline_params(
            bridge.params_from_numpy(params_np, cfg, "cpu"), mesh))
        loss = pipeline.pipelined_loss(placed, tok, tgt, cfg, mesh,
                                       n_microbatches=grad_microbatches)
        loss.backward()
        specs = pipeline.pipeline_param_specs()
        grads: dict = {}
        for path, t in train.param_leaves(placed):
            llama._set_leaf(grads, path, mesh_mod.gather_leaf(t.grad, specs[path], mesh))
        out["loss"] = float(loss.detach())
        out["grads"] = _np_tree(grads)
        out["own_layer_grads"] = [float(g.abs().sum()) for g in placed["layers"]["wq"].grad]
    return out


def train_step_rank(rank: int, world: int, params_np: dict, tokens: np.ndarray,
                    targets: np.ndarray, runs: list[tuple[dict, str]]) -> dict:
    """One rank of each ``(MeshPlan fields, dtype)`` run: one AdamW step of
    ``build_sharded_train_step`` from the given weights on this rank's
    rows; the loss, and (rank 0) the gradients and the parameters after
    the step gathered whole, the rank's shard shapes and its collectives."""
    from tpuslo_torch.models import bridge, llama, train

    _threads(world)
    out = {}
    for plan, dtype in runs:
        mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(**plan), devices=["cpu"])
        cfg = llama_cfg(dtype)
        step, _ = train.build_sharded_train_step(mesh, cfg)
        whole = bridge.params_from_numpy(params_np, cfg, "cpu")
        params = train.trainable(bridge.place_params(whole, step.layout, mesh))
        opt = train.make_optimizer().init(params)
        index, count = mesh_mod.axis_index(mesh, step.data_axes)
        rows = tokens.shape[0] // count
        sel = slice(index * rows, (index + 1) * rows)
        mesh.reset_counts()
        params, opt, loss = step(params, opt, torch.from_numpy(tokens[sel]),
                                 torch.from_numpy(targets[sel]))
        calls = dict(mesh.calls)
        grads: dict = {}
        with torch.no_grad():
            for path, t in train.param_leaves(params):
                llama._set_leaf(grads, path, mesh_mod.gather_leaf(t.grad, step.layout[path],
                                                                  mesh))
        after = bridge.gather_params(params, step.layout, mesh)
        key = (tuple(sorted(plan.items())), dtype)
        out[key] = {"loss": float(loss), "calls": calls,
                    "shapes": {p: tuple(t.shape) for p, t in train.param_leaves(params)}}
        if rank == 0:
            out[key].update(grads=_np_tree(grads), params=_np_tree(after))
    return out


def moe_trainer_rank(rank: int, world: int, dp: int, params_np: dict, corpus: list[str],
                     tcfg: dict, ckpt_dir: str, steps: int) -> dict:
    """One rank of a ``(dp, ep)`` mesh of ``world`` ranks training f32
    mixtral_tiny through ``trainer.train`` from the given weights:
    ``steps`` uninterrupted, then half of them with a checkpoint and the
    rest resumed in fresh objects."""
    from tpuslo_torch.models import bridge, mixtral, train
    from tpuslo_torch.models.trainer import TrainerConfig
    from tpuslo_torch.models.trainer import train as run

    _threads(world)
    cfg = mixtral_cfg()
    mesh = mesh_mod.dp_ep_mesh(dp, world // dp, devices=["cpu"])

    def builder(mesh, cfg):
        step_fn, init_fn = mixtral.build_moe_train_step(mesh, cfg)

        def init(seed, restored=None):
            if restored is None:
                restored = {"params": bridge.params_from_numpy(params_np, cfg, "cpu"),
                            "opt_state": {"count": 0}}
            return init_fn(seed, restored=restored)

        return step_fn, init

    half = steps // 2
    full = run(cfg, mesh, corpus, TrainerConfig(steps=steps, **tcfg), step_builder=builder)
    first = run(cfg, mesh, corpus, TrainerConfig(steps=half, ckpt_every=half, **tcfg),
                checkpoint_dir=ckpt_dir, step_builder=builder)
    second = run(cfg, mesh, corpus, TrainerConfig(steps=steps, ckpt_every=half, **tcfg),
                 checkpoint_dir=ckpt_dir, step_builder=builder)
    step_fn, init_fn = builder(mesh, cfg)
    params, _ = init_fn(tcfg["seed"])
    return {"full": full, "first": first, "second": second,
            "experts": tuple(params["layers"]["w1"].shape),
            "router": tuple(params["layers"]["router"].shape),
            "data_axes": step_fn.data_axes}
