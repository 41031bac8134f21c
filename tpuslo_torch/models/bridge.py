"""Carry weights and KV caches between the JAX package and the port.

Both sides meet as numpy arrays, so this module imports neither JAX nor
the JAX package.  The parameter trees share leaf names, the
``(L, D, F)`` layer stacking and the ``x @ w`` convention, so a leaf
carries over as a copy:

* a dense leaf arrives as f32 (``np.asarray(leaf, np.float32)``, which
  is exact for bf16) and is cast to ``cfg.dtype``, except the Mixtral
  family's ``router``, which JAX keeps in f32 and so does the port (the
  ``(L, E, D, F)`` expert leaves are dense leaves like any other);
* an int8 ``{"q", "s"}`` leaf is copied as it is and never quantized
  again: re-quantizing could round exact .5 boundaries differently.

KV state goes both ways: a dense or int8 cache
(:func:`cache_to_numpy`, :func:`cache_from_numpy`) and a paged pool with
its page table and lengths (:func:`paged_state_to_numpy`,
:func:`paged_state_from_numpy`), so that tests can start the port from
JAX's state and hold the port's to it.  A front door's dense parked
snapshot ``(row_t, row_d, current, frontier)`` goes both ways too
(:func:`parked_to_numpy`, :func:`parked_from_numpy`): a request parked
by one framework's front door can be adopted by the other's.

:func:`shard_serve_params` cuts one tp rank's shards out of a serving
tree, as JAX's ``serve_param_shardings`` places them on its mesh: rank
``r``'s leaves equal the JAX mesh's ``addressable_shards[r].data``.

AdamW's moments go both ways (:func:`adamw_state_from_numpy`,
:func:`adamw_state_to_numpy`): optax's ``ScaleByAdamState(count, mu,
nu)`` as numpy (``{"count", "mu", "nu"}``, the moment trees shaped like
the parameters) into a ``torch.optim.AdamW`` built over the same
parameters and back, so that both frameworks can continue one run.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpuslo_torch.device import resolve_device


def _leaf_to_torch(leaf, dtype: torch.dtype, device: torch.device):
    if isinstance(leaf, dict):
        return {
            "q": torch.from_numpy(np.asarray(leaf["q"], np.int8).copy()).to(device),
            "s": torch.from_numpy(np.asarray(leaf["s"], np.float32).copy()).to(device),
        }
    return torch.from_numpy(np.asarray(leaf, np.float32).copy()).to(
        device=device, dtype=dtype
    )


#: Layer leaves that stay f32 whatever the model dtype.
F32_LEAVES = ("router",)


def params_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """The port's parameters (Llama or Mixtral) from a JAX parameter tree
    given as numpy arrays (or anything ``np.asarray`` accepts)."""
    dev = resolve_device(device)
    return {
        "embed": _leaf_to_torch(tree["embed"], cfg.dtype, dev),
        "layers": {
            name: _leaf_to_torch(
                leaf, torch.float32 if name in F32_LEAVES else cfg.dtype, dev)
            for name, leaf in tree["layers"].items()
        },
        "final_norm": _leaf_to_torch(tree["final_norm"], cfg.dtype, dev),
        "output": _leaf_to_torch(tree["output"], cfg.dtype, dev),
    }


def params_to_numpy(params: dict) -> dict:
    """The port's parameters as numpy, the inverse of
    :func:`params_from_numpy`: dense leaves in f32 (exact for bf16), int8
    leaves as ``{"q": int8, "s": f32}``."""
    return {
        "embed": _side_to_numpy(params["embed"]),
        "layers": {name: _side_to_numpy(leaf) for name, leaf in params["layers"].items()},
        "final_norm": _side_to_numpy(params["final_norm"]),
        "output": _side_to_numpy(params["output"]),
    }


def _side_to_numpy(side) -> Any:
    if isinstance(side, dict):
        return {"q": side["q"].cpu().numpy(), "s": side["s"].cpu().numpy()}
    return side.detach().float().cpu().numpy()


def cache_to_numpy(cache: dict) -> dict:
    """A port KV cache as numpy: dense sides in f32, int8 sides as
    ``{"q": int8, "s": f32}``, ``length`` as an int64 array."""
    length = cache["length"]
    if isinstance(length, torch.Tensor):
        length = length.cpu().numpy()
    return {
        "k": _side_to_numpy(cache["k"]),
        "v": _side_to_numpy(cache["v"]),
        "length": np.asarray(length, np.int64),
    }


def _length_from_numpy(length, device: torch.device):
    """A cache length as the port keeps it: a Python int for a scalar, a
    ``(B,)`` int64 tensor for per-row lengths."""
    length = np.asarray(length)
    if length.ndim == 0:
        return int(length)
    return torch.from_numpy(length.astype(np.int64)).to(device)


def cache_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """A port KV cache from a JAX cache given as numpy: dense sides are
    cast to ``cfg.dtype``, int8 ``{"q", "s"}`` sides are copied as they
    are, ``length`` becomes an int or a ``(B,)`` int64 tensor."""
    dev = resolve_device(device)
    return {
        "k": _leaf_to_torch(tree["k"], cfg.dtype, dev),
        "v": _leaf_to_torch(tree["v"], cfg.dtype, dev),
        "length": _length_from_numpy(tree["length"], dev),
    }


def paged_state_to_numpy(state: dict) -> dict:
    """A port paged state as numpy: the pool sides as in
    :func:`cache_to_numpy`, the page table as int32, lengths as int64."""
    return {
        "k": _side_to_numpy(state["k"]),
        "v": _side_to_numpy(state["v"]),
        "page_table": state["page_table"].cpu().numpy().astype(np.int32),
        "length": state["length"].cpu().numpy().astype(np.int64),
    }


def paged_state_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """A port paged state from a JAX one given as numpy: pool sides as in
    :func:`cache_from_numpy`, an int32 page table and int64 lengths."""
    dev = resolve_device(device)
    return {
        "k": _leaf_to_torch(tree["k"], cfg.dtype, dev),
        "v": _leaf_to_torch(tree["v"], cfg.dtype, dev),
        "page_table": torch.from_numpy(
            np.asarray(tree["page_table"], np.int32).copy()
        ).to(dev),
        "length": torch.from_numpy(np.asarray(tree["length"], np.int64).copy()).to(dev),
    }


def parked_to_numpy(parked: tuple) -> dict:
    """A front door's dense parked snapshot ``(row_t, row_d, current,
    frontier)`` as numpy: both single-row caches as in
    :func:`cache_to_numpy`, the carried token and the frontier as ints."""
    row_t, row_d, current, frontier = parked
    return {
        "row_t": cache_to_numpy(row_t),
        "row_d": cache_to_numpy(row_d),
        "current": int(current),
        "frontier": int(frontier),
    }


def parked_from_numpy(
    tree: dict, cfg_t, cfg_d, device: str | torch.device = "cuda"
) -> tuple:
    """The port's parked snapshot from one given as numpy (the layout of
    :func:`parked_to_numpy`; the rows may come from a JAX front door's
    ``req.parked``), ready for ``FrontDoorRequest.parked``."""
    return (
        cache_from_numpy(tree["row_t"], cfg_t, device),
        cache_from_numpy(tree["row_d"], cfg_d, device),
        int(tree["current"]),
        int(tree["frontier"]),
    )


#: The axis each serving leaf splits over tp ranks (JAX's
#: ``serve_param_shardings``): column-parallel weights their output axis,
#: row-parallel ones (wo, w2) their input axis, the embedding its vocab
#: rows and the head its vocab columns; None: replicated.
SERVE_SPLIT_AXIS = {
    "embed": 0,
    "layers/wq": 2, "layers/wk": 2, "layers/wv": 2, "layers/w1": 2, "layers/w3": 2,
    "layers/wo": 1, "layers/w2": 1, "layers/attn_norm": None, "layers/mlp_norm": None,
    "final_norm": None, "output": 1,
}


def _split(t: torch.Tensor, axis: int | None, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous part of ``t`` along ``axis`` (a fresh
    tensor, so that the whole leaf can be freed); ``None``: a copy."""
    if axis is None:
        return t.clone()
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over tp={tp}")
    return t.narrow(axis, rank * (n // tp), n // tp).contiguous()


def shard_leaf(path: str, leaf, tp: int, rank: int):
    """Rank ``rank``'s shard of the serving leaf at ``path`` (dense, or an
    int8 ``{"q", "s"}`` leaf: ``q`` split like the dense weight, ``s``
    like ``q``'s output axis, which is ``q``'s split with the contracting
    axis -2 dropped)."""
    axis = SERVE_SPLIT_AXIS[path]
    if not isinstance(leaf, dict):
        return _split(leaf, axis, tp, rank)
    q_nd = leaf["q"].ndim
    s_axis = None
    if axis is not None and axis != q_nd - 2:
        s_axis = axis if axis < q_nd - 2 else axis - 1
    return {"q": _split(leaf["q"], axis, tp, rank), "s": _split(leaf["s"], s_axis, tp, rank)}


def shard_serve_params(params: dict, tp: int, rank: int) -> dict:
    """Rank ``rank`` of ``tp``'s shards of a Llama serving tree (dense or
    int8): a new tree of fresh tensors on the leaves' device."""
    out: dict = {}
    for path in SERVE_SPLIT_AXIS:
        *parents, name = path.split("/")
        src, dst = params, out
        for key in parents:
            src, dst = src[key], dst.setdefault(key, {})
        dst[name] = shard_leaf(path, src[name], tp, rank)
    return out


def _tree_leaf(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def adamw_state_from_numpy(state: dict, optimizer: torch.optim.Optimizer,
                           params: dict) -> torch.optim.Optimizer:
    """Load optax's adam moments into ``optimizer`` (an AdamW built by
    ``tpuslo_torch.models.train.AdamW.init(params)``): each leaf's
    ``exp_avg`` is ``mu``'s leaf and ``exp_avg_sq`` ``nu``'s, in the
    parameter's dtype and device, and ``step`` is ``count``.  Returns the
    optimizer."""
    from tpuslo_torch.models.train import param_leaves

    count = float(np.asarray(state["count"]))
    for path, p in param_leaves(params):
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": _leaf_to_torch(_tree_leaf(state["mu"], path), p.dtype, p.device),
            "exp_avg_sq": _leaf_to_torch(_tree_leaf(state["nu"], path), p.dtype, p.device),
        }
    return optimizer


def adamw_state_to_numpy(optimizer: torch.optim.Optimizer, params: dict) -> dict:
    """The inverse of :func:`adamw_state_from_numpy` for an optimizer that
    has stepped: ``{"count", "mu", "nu"}``, the moment trees shaped like
    ``params`` (f32 numpy)."""
    from tpuslo_torch.models.train import param_leaves

    mu: dict = {}
    nu: dict = {}
    for path, p in param_leaves(params):
        st = optimizer.state[p]
        *parents, leaf = path.split("/")
        m, n = mu, nu
        for key in parents:
            m, n = m.setdefault(key, {}), n.setdefault(key, {})
        m[leaf] = _side_to_numpy(st["exp_avg"])
        n[leaf] = _side_to_numpy(st["exp_avg_sq"])
    return {"count": np.asarray(int(st["step"]), np.int32), "mu": mu, "nu": nu}
