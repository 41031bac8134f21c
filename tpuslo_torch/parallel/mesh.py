"""Device-mesh plans for the training step (PyTorch port of the
one-device part of ``tpuslo/parallel/mesh.py``).

:class:`MeshPlan` and :func:`plan_for_devices` are the JAX module's pure
factorization (tp innermost, then fsdp, then dp; a dcn axis factored out
first for multi-slice plans), so a plan means the same thing in both
packages.  :func:`make_mesh` builds a :class:`Mesh` of ONE device: the
card unless the caller passes ``devices=["cpu"]``.  A plan of more than
one device raises: the dp / fsdp / tp shardings
(``param_shardings``, ``batch_sharding``, ``optimizer_state_shardings``)
and the collectives they imply belong to the multi-device slice
(ROADMAP item 13) and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpuslo_torch.device import resolve_device

MULTI_DEVICE_NOT_PORTED = (
    "a mesh of more than one device (dp / fsdp / tp / dcn sharding) belongs to the "
    "multi-device slice (ROADMAP item 13) and is not ported yet; the port trains on "
    "one device"
)


@dataclass(frozen=True)
class MeshPlan:
    """Device factorization: ``dcn`` slices of ``dp x fsdp x tp``
    devices (the JAX module's plan)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    dcn: int = 1

    @property
    def n_devices(self) -> int:
        return self.dcn * self.dp * self.fsdp * self.tp


def plan_for_devices(n: int, slices: int = 1) -> MeshPlan:
    """The JAX module's default factorization: tp innermost (8, 4 or 2),
    then fsdp (4 or 2), then dp; ``slices > 1`` factors a dcn axis out
    first and gives each slice the single-slice plan of its devices."""
    if slices > 1:
        if n % slices:
            raise ValueError(f"{n} devices not divisible by {slices} slices")
        inner = plan_for_devices(n // slices)
        return MeshPlan(dp=inner.dp, fsdp=inner.fsdp, tp=inner.tp, dcn=slices)
    tp = 1
    for candidate in (8, 4, 2):
        if n % candidate == 0:
            tp = candidate
            break
    rest = n // tp
    fsdp = 1
    for candidate in (4, 2):
        if rest % candidate == 0:
            fsdp = candidate
            break
    return MeshPlan(dp=rest // fsdp, fsdp=fsdp, tp=tp)


@dataclass(frozen=True)
class Mesh:
    """A one-device mesh: the plan it was built from and its device."""

    plan: MeshPlan
    device: torch.device


def make_mesh(plan: MeshPlan, devices: list | None = None) -> Mesh:
    """A :class:`Mesh` over the first of ``devices`` (default: the card,
    which must exist).  Raises for a plan of more than one device."""
    if plan.n_devices > 1:
        raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)
    devices = list(devices) if devices is not None else ["cuda"]
    if not devices:
        raise ValueError(f"plan needs {plan.n_devices} devices, have 0")
    return Mesh(plan, resolve_device(devices[0]))
