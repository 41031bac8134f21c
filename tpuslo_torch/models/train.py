"""The training step for the Llama family (PyTorch port of
``tpuslo/models/train.py``), on one device or over a dp/fsdp/tp mesh.

``step_fn(params, opt_state, tokens, targets) -> (params, opt_state,
loss)`` keeps the JAX contract: a full AdamW step of the mean next-token
cross-entropy, each layer checkpointed (remat) so that activations stay
bounded.  What differs is PyTorch's idiom: the parameters are leaf
tensors that the step updates in place and returns, and the optimizer
state is the ``torch.optim.AdamW`` that holds them (:func:`make_optimizer`
gives its settings, ``optimizer.init(params)`` builds it, as optax's
``init`` does).

Over a mesh of more than one rank (:func:`build_mesh_step`) each rank
holds its shards of the parameters under a layout table
(:func:`tpuslo_torch.parallel.mesh.param_shardings`) and takes its rows
of every global batch (``batch_sharding``).  Its loss is its share of the
global mean (``llama.loss_fn(..., mesh=...)``), so the global loss is the
sum of the shares and its gradient the sum of the ranks' gradients:

* a leaf split over fsdp gets that sum over fsdp from the
  ``reduce_scatter`` that transposes its gather;
* every leaf is then summed over each data axis it is not split over
  (``dcn``, ``dp``, and ``fsdp`` for a leaf it leaves whole), one
  ``all_reduce`` per axis over the leaves of one dtype laid end to end;
* model axes (``tp``, a MoE mesh's ``ep``) need no reduction: every rank
  of one already holds the whole gradient of its shards.

The AdamW then steps each rank's shards, its moments shaped like them:
the update is elementwise, so the shards step as the whole tree would.
``init_fn(seed)`` draws :func:`~tpuslo_torch.models.llama.init_leaves` in
order and keeps the rank's part of each leaf, so a sharded run starts
from the one-device run's weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from tpuslo_torch.models import bridge, llama
from tpuslo_torch.models.llama import LlamaConfig, _set_leaf, loss_fn
from tpuslo_torch.parallel import mesh as mesh_mod

Params = dict[str, Any]


#: optax's ``adamw(lr, b1=0.9, b2=0.95)`` defaults (eps 1e-8).
BETAS = (0.9, 0.95)
EPS = 1e-8


@dataclass(frozen=True)
class AdamW:
    """optax's ``adamw(lr, b1=0.9, b2=0.95, weight_decay=...)`` as
    ``torch.optim.AdamW`` settings.  Like ``optax.adamw`` with
    ``mask=None`` it decays every leaf, the norms included."""

    lr: float = 3e-4
    weight_decay: float = 0.1

    def init(self, params: Params) -> torch.optim.AdamW:
        """The optimizer over ``params``' leaves in :func:`param_leaves`
        order (JAX's tree order), with zero moments."""
        return torch.optim.AdamW(
            [t for _, t in param_leaves(params)], lr=self.lr, betas=BETAS, eps=EPS,
            weight_decay=self.weight_decay,
        )


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def param_leaves(params: Params) -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in the order ``jax.tree`` flattens
    the same dict (keys sorted at every level), paths joined by ``/``."""
    out: list[tuple[str, torch.Tensor]] = []

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}/{key}" if prefix else key, node[key])
        else:
            out.append((prefix, node))

    walk("", params)
    return out


def trainable(params: Params) -> Params:
    """``params`` with every leaf a leaf tensor that requires grad (in
    place where it already is one)."""
    for _, t in param_leaves(params):
        if not t.is_floating_point():
            raise ValueError("training needs dense floating-point leaves, not int8 ones")
        t.requires_grad_(True)
    return params


def frozen(params: Params) -> Params:
    """``params`` outside autograd (detached leaves sharing the storage),
    for serving trained weights."""
    if isinstance(params, dict):
        return {k: frozen(v) for k, v in params.items()}
    return params.detach()


def train_step(params: Params, opt_state: torch.optim.Optimizer, tokens: torch.Tensor,
               targets: torch.Tensor, cfg, loss: Callable = loss_fn):
    """One AdamW step: the loss and its gradients, then the update in
    place.  Returns ``(params, opt_state, loss)``, the loss a 0-d tensor
    on the device (no host read)."""
    opt_state.zero_grad(set_to_none=True)
    value = loss(params, tokens, targets, cfg)
    value.backward()
    opt_state.step()
    return params, opt_state, value.detach()


def build_step(mesh, cfg, init_params: Callable, loss: Callable, optimizer: AdamW | None):
    """``(step_fn, init_fn)`` for a model family (its ``init_params`` and
    ``loss_fn``) on the mesh's one device.

    ``init_fn(seed)`` draws the parameters on the device and returns them
    with a fresh optimizer.  ``init_fn(seed, restored=...)`` takes a
    checkpoint's ``{"params", "opt_state"}`` (the optimizer's state dict)
    instead and runs no initializer, as the JAX trainer restores into
    abstract shapes.
    """
    optimizer = optimizer or make_optimizer()
    device = mesh.device

    def init_fn(seed: int, restored: dict | None = None):
        if restored is None:
            params = trainable(init_params(seed, cfg, device))
            return params, optimizer.init(params)
        params = trainable(restored["params"])
        opt_state = optimizer.init(params)
        if "mu" in restored["opt_state"]:  # a sharded run's layout-free checkpoint
            load_adamw_tree(opt_state, params, restored["opt_state"])
        else:
            opt_state.load_state_dict(restored["opt_state"])
        return params, opt_state

    def step_fn(params, opt_state, tokens, targets):
        if tokens.device != device:
            raise ValueError(f"tokens on {tokens.device}, the step trains on {device}")
        return train_step(params, opt_state, tokens, targets, cfg, loss)

    return step_fn, init_fn


def build_sharded_train_step(mesh, cfg: LlamaConfig, optimizer: AdamW | None = None):
    """The JAX builder's ``(step_fn, init_fn)`` for the Llama family: on
    the mesh's one device (:func:`build_step`), or over a mesh of more
    than one rank with JAX's dp/fsdp/tp layout (:func:`build_mesh_step`)."""
    if mesh.size == 1:
        return build_step(mesh, cfg, llama.init_params, loss_fn, optimizer)
    return build_mesh_step(mesh, cfg, mesh_mod.param_shardings(mesh),
                           mesh_mod.batch_sharding(mesh)[0], llama.init_leaves, loss_fn,
                           optimizer)


def _get_path(tree: dict, keys):
    for key in keys:
        tree = tree[key]
    return tree


def _moment_tree(states: list[dict], params: Params) -> dict:
    """``{"count", "mu", "nu"}`` from each leaf's AdamW state, in
    :func:`param_leaves` order (zeros for a leaf with none)."""
    mu: dict = {}
    nu: dict = {}
    count = 0.0
    for st, (path, p) in zip(states, param_leaves(params)):
        _set_leaf(mu, path, st.get("exp_avg", torch.zeros_like(p)))
        _set_leaf(nu, path, st.get("exp_avg_sq", torch.zeros_like(p)))
        count = float(st.get("step", count))
    return {"count": torch.tensor(count, dtype=torch.float32), "mu": mu, "nu": nu}


def adamw_tree(opt_state: torch.optim.Optimizer, params: Params) -> dict:
    """The optimizer's state as optax's adam state reads it: ``{"count",
    "mu", "nu"}``, the moment trees shaped like ``params`` (the tensors
    themselves; zeros before the first step)."""
    return _moment_tree([opt_state.state.get(p, {}) for _, p in param_leaves(params)], params)


def state_dict_tree(state: dict, params: Params) -> dict:
    """:func:`adamw_tree` from an AdamW's ``state_dict()`` (its states keyed
    by position in :func:`param_leaves` order), so that a one-device
    checkpoint restores onto a mesh."""
    return _moment_tree([state["state"].get(i, {}) for i in range(len(param_leaves(params)))],
                        params)


def load_adamw_tree(opt_state: torch.optim.Optimizer, params: Params, tree: dict,
                    layout: dict | None = None, mesh=None) -> torch.optim.Optimizer:
    """Load an :func:`adamw_tree` (whole leaves, with ``layout`` and
    ``mesh``: this rank's parts of them) into ``opt_state``, built over
    ``params``."""
    count = float(tree["count"])
    if count == 0:
        return opt_state
    for path, p in param_leaves(params):
        moments = [_get_path(tree[k], path.split("/")) for k in ("mu", "nu")]
        if layout is not None:
            moments = [mesh_mod.place_leaf(m, layout[path], mesh) for m in moments]
        opt_state.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": moments[0].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": moments[1].to(device=p.device, dtype=p.dtype),
        }
    return opt_state


def gather_state(params: Params, opt_state: torch.optim.Optimizer, layout: dict, mesh) -> dict:
    """A layout-free checkpoint of a sharded run: ``{"params", "opt_state"}``,
    the whole parameter tree and :func:`adamw_tree` of whole moments,
    gathered over the mesh (every rank calls it)."""
    moments = adamw_tree(opt_state, params)
    shard = mesh_mod.optimizer_state_shardings(moments, layout, mesh)
    with torch.no_grad():
        whole = mesh_mod._tree_map_paths(
            lambda path, leaf: mesh_mod.gather_leaf(leaf, _get_path(shard, path), mesh),
            moments)
    return {"params": bridge.gather_params(params, layout, mesh), "opt_state": whole}


def reduce_gradients(params: Params, layout: dict, mesh, data_axes: tuple[str, ...]) -> None:
    """Sum each leaf's gradient over every data axis of size > 1 that the
    leaf is not split over, in place: per (axis, dtype) one ``all_reduce``
    of the gradients laid end to end."""
    buckets: dict = {}
    for path, p in param_leaves(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        split = set(layout[path].values())
        for axis in data_axes:
            if mesh.shape[axis] > 1 and axis not in split:
                buckets.setdefault((axis, p.grad.dtype), []).append(p.grad)
    for (axis, _), grads in buckets.items():
        flat = mesh_mod.all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def build_mesh_step(mesh, cfg, layout: dict, data_axes: tuple[str, ...], init_leaves: Callable,
                    loss: Callable, optimizer: AdamW | None):
    """``(step_fn, init_fn)`` over a mesh of more than one rank: ``layout``
    the parameters' table, ``data_axes`` the axes the batch's rows split
    over, ``loss(params, tokens, targets, cfg, mesh=...)`` the rank's share
    of the global loss.  ``step_fn`` returns the global loss (the shares
    summed over the data axes), the same on every rank; it and
    ``init_fn`` carry ``mesh``, ``layout`` and ``data_axes``, which the
    trainer reads.  ``init_fn(seed, restored=...)`` takes a layout-free
    checkpoint (:func:`gather_state`, or a one-device one) and keeps the
    rank's parts."""
    optimizer = optimizer or make_optimizer()
    device = mesh.device

    def init_fn(seed: int, restored: dict | None = None):
        if restored is None:
            tree: Params = {}
            for path, leaf in init_leaves(seed, cfg, device):
                _set_leaf(tree, path, mesh_mod.place_leaf(leaf, layout[path], mesh))
                del leaf
            params = trainable(tree)
            return params, optimizer.init(params)
        params = trainable(bridge.place_params(restored["params"], layout, mesh))
        opt_state = optimizer.init(params)
        moments = restored["opt_state"]
        if "state" in moments:  # a one-device checkpoint's state_dict
            moments = state_dict_tree(moments, restored["params"])
        load_adamw_tree(opt_state, params, moments, layout, mesh)
        return params, opt_state

    def step_fn(params, opt_state, tokens, targets):
        if tokens.device != device:
            raise ValueError(f"tokens on {tokens.device}, the step trains on {device}")
        opt_state.zero_grad(set_to_none=True)
        share = loss(params, tokens, targets, cfg, mesh=mesh)
        share.backward()
        reduce_gradients(params, layout, mesh, data_axes)
        opt_state.step()
        value = share.detach()
        for axis in data_axes:
            if mesh.shape[axis] > 1:
                value = mesh_mod.all_reduce(value, mesh, axis)
        return params, opt_state, value

    for fn in (step_fn, init_fn):
        fn.mesh, fn.layout, fn.data_axes = mesh, layout, data_axes
    return step_fn, init_fn
