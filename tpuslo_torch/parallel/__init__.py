"""The port's multi-device plane (the counterpart of ``tpuslo/parallel``):
meshes over ``torch.distributed`` process groups, their collectives and
the training layouts (:mod:`.mesh`), the GPipe schedule (:mod:`.pipeline`),
the active collective prober (:mod:`.collectives`) and the multi-process
straggler prober (:mod:`.distributed`)."""

from tpuslo_torch.parallel.mesh import (
    MeshPlan,
    batch_sharding,
    make_mesh,
    optimizer_state_shardings,
    param_shardings,
    plan_for_devices,
)

__all__ = [
    "MeshPlan",
    "batch_sharding",
    "make_mesh",
    "optimizer_state_shardings",
    "param_shardings",
    "plan_for_devices",
]
