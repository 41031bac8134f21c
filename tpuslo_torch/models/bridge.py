"""Carry weights and KV caches between the JAX package and the port.

Both sides meet as numpy arrays, so this module imports neither JAX nor
the JAX package.  The parameter trees share leaf names, the
``(L, D, F)`` layer stacking and the ``x @ w`` convention, so a leaf
carries over as a copy:

* a dense leaf arrives as f32 (``np.asarray(leaf, np.float32)``, which
  is exact for bf16) and is cast to ``cfg.dtype``;
* an int8 ``{"q", "s"}`` leaf is copied as it is and never quantized
  again: re-quantizing could round exact .5 boundaries differently.

KV caches go the other way, port to numpy, so that tests can hold them
to the JAX module's.
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


def params_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (or anything ``np.asarray`` accepts)."""
    dev = resolve_device(device)
    return {
        "embed": _leaf_to_torch(tree["embed"], cfg.dtype, dev),
        "layers": {
            name: _leaf_to_torch(leaf, cfg.dtype, dev)
            for name, leaf in tree["layers"].items()
        },
        "final_norm": _leaf_to_torch(tree["final_norm"], cfg.dtype, dev),
        "output": _leaf_to_torch(tree["output"], cfg.dtype, dev),
    }


def _side_to_numpy(side) -> Any:
    if isinstance(side, dict):
        return {"q": side["q"].cpu().numpy(), "s": side["s"].cpu().numpy()}
    return side.float().cpu().numpy()


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
