"""The port's multi-device plane (the counterpart of ``tpuslo/parallel``):
meshes over ``torch.distributed`` process groups and their collectives
(:mod:`.mesh`), the active collective prober (:mod:`.collectives`) and the
multi-process straggler prober (:mod:`.distributed`).  Pipeline schedules
and the training shardings belong to the slice's last part (ROADMAP
item 13b-iii)."""
