"""Pipeline parallelism (the ``pp`` axis): the GPipe microbatch schedule
(PyTorch port of ``tpuslo/parallel/pipeline.py``).

Layers are stacked along a leading axis, so a stage's layers are that
axis split over the ``pp`` mesh (:func:`pipeline_param_specs`): stage
*i* holds layers ``[i*L/pp, (i+1)*L/pp)``.  The schedule runs
``n_microbatches + pp - 1`` ticks; at each tick every stage runs its
layers on its current microbatch and hands the activations to the next
stage with :func:`tpuslo_torch.parallel.mesh.shift` (one neighbour
hop).  Stage 0 injects microbatch ``min(t, M - 1)`` (late ticks inject
the last again, and its output is never collected), the last stage
collects microbatch ``t - (pp - 1)`` in f32, a sum over ``pp`` of the
last stage's outputs (the other stages add zeros) replicates them to
every stage, and the embedding, the final norm and the head are computed
replicated, as JAX's are.

The schedule is differentiable, as JAX's ``scan``/``ppermute``/``psum``
schedule is: every stage builds the same graph (the stage decides
through tensors, ``torch.where`` on a 0-d flag, what JAX decides through
``jnp.where``), so the backward runs the same collectives in the same
order on every rank.  The shift's gradient goes back by one stage
(:func:`~tpuslo_torch.parallel.mesh.shift` under autograd), the
replicating sum is Megatron's ``g`` (every stage then holds the whole
loss) and the embedding's output passes ``f``, so its gradient, which
only stage 0's injections carry, reaches every stage.  The last tick's
hop carries nothing any stage reads, so it is not made.

One stage boundary falls between a layer's residual add and the next
layer's norm, which the port fuses into one ``add_rms_norm``: a stage
hands on the residual stream ``h`` alone, its last add is the plain add
(the fused kernel's add has the eager add's bits) and the next stage
normalizes ``h`` again with the RMSNorm kernel.  On the CPU the two
orders are the same arithmetic; on the card the fused norm and the plain
one may differ by one bf16 ulp at a rounding tie (PERF.md gives the
logits' error).  The final norm after the replicating sum is the plain
norm for the same reason.
"""

from __future__ import annotations

from typing import Any

import torch

from tpuslo_torch.models import bridge, llama
from tpuslo_torch.parallel import mesh as mesh_mod

Params = dict[str, Any]

def pipeline_param_specs(axis_name: str = "pp") -> dict[str, dict]:
    """The layout table of an ``init_params`` tree: each layer-stacked
    leaf's layer axis over ``axis_name``, the rest replicated (JAX's
    PartitionSpec tree)."""
    return {path: {0: axis_name} if path.startswith("layers/") else {}
            for path in mesh_mod.PARAM_SHARDINGS}


def place_pipeline_params(params: Params, mesh, axis_name: str = "pp") -> Params:
    """This stage's parameters: its run of each layer-stacked leaf, the
    rest copied (fresh tensors)."""
    return bridge.place_params(params, pipeline_param_specs(axis_name), mesh)


def _check(cfg, tokens: torch.Tensor, pp: int, n_microbatches: int) -> None:
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    if tokens.shape[0] % n_microbatches:
        raise ValueError(
            f"batch={tokens.shape[0]} not divisible by "
            f"n_microbatches={n_microbatches}"
        )


def pipelined_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    mesh,
    n_microbatches: int = 4,
    axis_name: str = "pp",
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence forward through the pipeline -> f32 logits (B, S, V),
    the same on every stage.  Every stage passes the whole ``tokens`` and
    ``params`` whole or as its :func:`place_pipeline_params` part.

    Requires ``cfg.n_layers % mesh.shape[axis_name] == 0`` and
    ``tokens.shape[0] % n_microbatches == 0``.  A pass that autograd
    records runs each layer under remat when ``remat`` (as
    ``llama.forward`` does) and its products over the whole microbatch;
    any other pass keeps the serving forward's products."""
    pp = mesh.shape[axis_name]
    _check(cfg, tokens, pp, n_microbatches)
    stage = mesh.rank(axis_name) if pp > 1 else 0
    if pp > 1 and params["layers"]["wq"].shape[0] == cfg.n_layers:
        params = place_pipeline_params(params, mesh, axis_name)
    train = llama._differentiated(params)
    M = n_microbatches
    B, S = tokens.shape
    mb = B // M
    dev = tokens.device

    h = llama._embed_lookup(params, tokens, cfg.dtype)  # replicated compute
    if pp > 1:
        h = mesh_mod.copy_to(h, mesh, axis_name)
    h_mb = h.reshape(M, mb, S, h.shape[-1])
    positions = torch.arange(S, device=dev).expand(mb, S)
    cos, sin = llama.rope_frequencies(cfg, positions)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    layers = params["layers"]
    if train:  # one unbind a leaf for every tick's pass over the stage
        layers = {name: leaf.unbind(0) for name, leaf in layers.items()}

    def stage_layers(x: torch.Tensor) -> torch.Tensor:
        return llama._stack(layers, cfg, x, cos, sin, mask, None, remat=remat and train,
                            invariant=not train)[0]

    def hop(x: torch.Tensor) -> torch.Tensor:
        return mesh_mod.shift(x, mesh, axis_name, 1) if pp > 1 else x

    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == pp - 1, device=dev)
    buf = torch.zeros((mb, S, h.shape[-1]), dtype=cfg.dtype, device=dev)
    outputs: list[torch.Tensor] = []
    ticks = M + pp - 1
    for t in range(ticks):
        buf = torch.where(first, h_mb[min(t, M - 1)], buf)
        processed = stage_layers(buf)
        if t >= pp - 1:  # the last stage finishes microbatch t - (pp - 1)
            done = processed.float()
            outputs.append(torch.where(last, done, torch.zeros_like(done)))
        if t + 1 < ticks:
            buf = hop(processed)
    out = torch.stack(outputs)
    if pp > 1:
        out = mesh_mod.reduce_from(out, mesh, axis_name)
    h = out.reshape(B, S, -1).to(cfg.dtype)
    x = llama.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return llama._logits(params, x, llama._product if train else llama._seq_matmul)


def pipelined_loss(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg,
    mesh,
    n_microbatches: int = 4,
    axis_name: str = "pp",
    remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross-entropy through the pipeline, the same on
    every stage; its gradients reach every stage's layers (each stage its
    own), and the embedding, the final norm and the head (whole on every
    stage)."""
    logits = pipelined_forward(params, tokens, cfg, mesh, n_microbatches, axis_name, remat)
    return llama.nll_loss(logits, targets)
