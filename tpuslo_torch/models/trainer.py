"""Training loop: data pipeline, step and checkpoint/resume (PyTorch port
of ``tpuslo/models/trainer.py``).

* :mod:`tpuslo_torch.models.data`: deterministic device-prefetched
  batches;
* :mod:`tpuslo_torch.models.train`: the AdamW step, on one device or
  over a mesh of ranks (every rank runs :func:`train` with its mesh);
* :mod:`tpuslo_torch.models.checkpoint`: rotating checkpoints.

Resume is bit-exact, as the JAX trainer promises: the data stream is a
seeded permutation and the checkpoint carries (params, optimizer state,
step), so a run continued from its last checkpoint gives the same loss
curve as an uninterrupted one on the same mesh.  Over a mesh of more
than one rank each rank takes its rows of every global batch, a
checkpoint holds the whole tree (gathered over the mesh, written by rank
0), and each rank restores its parts, so a checkpoint does not depend on
the layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from tpuslo_torch.models.checkpoint import TrainCheckpointer
from tpuslo_torch.models.data import corpus_stream
from tpuslo_torch.models.train import build_sharded_train_step, gather_state
from tpuslo_torch.parallel import mesh as mesh_mod


def mesh_rank(mesh) -> int:
    """The rank's position in its mesh, row-major over every axis."""
    return mesh_mod.axis_index(mesh, mesh.axis_names)[0]


@dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    ckpt_every: int = 0  # 0 = no checkpointing
    ckpt_keep: int = 3


def train(
    cfg,  # LlamaConfig | MixtralConfig: any config its step_builder accepts
    mesh,
    texts: list[str],
    tcfg: TrainerConfig,
    checkpoint_dir: str | None = None,
    step_builder=None,
) -> dict:
    """Run (or resume) a training session on ``mesh.device`` (over a mesh
    of ranks: this rank's part of it); returns ``{"losses", "first_step",
    "last_step"}``, the global losses on every rank.

    With ``checkpoint_dir`` set and a checkpoint present, training resumes
    from the latest step: params and optimizer state are restored onto
    the device without running the initializer, and the data stream
    skips the consumed batches on the host.

    ``step_builder(mesh, cfg) -> (step_fn, init_fn)`` selects the model
    family: the Llama builder by default,
    :func:`tpuslo_torch.models.mixtral.build_moe_train_step` for the MoE
    family.
    """
    builder = step_builder or build_sharded_train_step
    step_fn, init_fn = builder(mesh, cfg)
    sharded = mesh.size > 1
    writer = not sharded or mesh_rank(mesh) == 0
    start_step = 0
    ckpt = None
    if checkpoint_dir and tcfg.ckpt_every:
        ckpt = TrainCheckpointer(checkpoint_dir, max_to_keep=tcfg.ckpt_keep)
    try:
        if ckpt is not None and ckpt.latest_step() is not None:
            start_step = int(ckpt.latest_step())
            restored = ckpt.restore(start_step, device="cpu" if sharded else mesh.device)
            params, opt_state = init_fn(tcfg.seed, restored=restored)
            del restored
        else:
            params, opt_state = init_fn(tcfg.seed)

        rows = mesh_mod.axis_index(mesh, mesh_mod.batch_sharding(mesh)[0]) if sharded else None
        stream = corpus_stream(
            texts,
            batch=tcfg.batch,
            seq_len=tcfg.seq_len,
            device=mesh.device,
            seed=tcfg.seed,
            epochs=10_000,  # effectively unbounded; the loop bounds steps
            skip=start_step,
            rows=rows,
        )
        losses: list[float] = []
        step = start_step
        try:
            for tokens, targets in stream:
                if step >= tcfg.steps:
                    break
                params, opt_state, loss = step_fn(params, opt_state, tokens, targets)
                step += 1
                losses.append(float(loss))
                if ckpt is not None and step % tcfg.ckpt_every == 0:
                    if sharded:
                        state = gather_state(params, opt_state, step_fn.layout, mesh)
                        if writer:
                            ckpt.save(step, state["params"], opt_state=state["opt_state"])
                        del state
                    else:
                        ckpt.save(step, params, opt_state=opt_state)
        finally:
            stream.close()  # unblock and end the prefetch worker
        if ckpt is not None and sharded:
            # Rank 0's last write is on disk before any rank leaves, so
            # that a session that follows finds it on every rank.
            ckpt.close()
            dist.barrier()
    finally:
        if ckpt is not None:
            ckpt.close()
    return {"losses": losses, "first_step": start_step, "last_step": step}
