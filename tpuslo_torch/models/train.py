"""The training step for the Llama family (PyTorch port of
``tpuslo/models/train.py``) on one device.

``step_fn(params, opt_state, tokens, targets) -> (params, opt_state,
loss)`` keeps the JAX contract: a full AdamW step of the mean next-token
cross-entropy, each layer checkpointed (remat) so that activations stay
bounded.  What differs is PyTorch's idiom: the parameters are leaf
tensors that the step updates in place and returns, and the optimizer
state is the ``torch.optim.AdamW`` that holds them (:func:`make_optimizer`
gives its settings, ``optimizer.init(params)`` builds it, as optax's
``init`` does).  The dp / fsdp / tp shardings of the JAX builder belong
to the multi-device slice's last part (ROADMAP item 13b-iii): the mesh
here is one device
(:mod:`tpuslo_torch.parallel.mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from tpuslo_torch.models import llama
from tpuslo_torch.models.llama import LlamaConfig, loss_fn

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
        opt_state.load_state_dict(restored["opt_state"])
        return params, opt_state

    def step_fn(params, opt_state, tokens, targets):
        if tokens.device != device:
            raise ValueError(f"tokens on {tokens.device}, the step trains on {device}")
        return train_step(params, opt_state, tokens, targets, cfg, loss)

    return step_fn, init_fn


def build_sharded_train_step(mesh, cfg: LlamaConfig, optimizer: AdamW | None = None):
    """The JAX builder's ``(step_fn, init_fn)`` for the Llama family on
    the mesh's one device (see :func:`build_step`)."""
    return build_step(mesh, cfg, llama.init_params, loss_fn, optimizer)
