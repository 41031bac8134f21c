"""Mixtral-class sparse-MoE transformer (PyTorch port of
``tpuslo/models/mixtral.py``): the second model family the toolkit
serves and observes.

The Llama family's attention stack (GQA, RoPE, RMSNorm, layer-stacked
parameters) with the dense SwiGLU swapped for a top-k mixture of experts
(:mod:`tpuslo_torch.ops.moe`) through the Llama paths' ``mlp_fn`` hook,
so the cache layout, the masks and the kernels have one source: on the
card a prefill at a flash-eligible shape runs K1, a cached pass reads
its cache as K2's lanes, and every residual add feeding a norm is one
fused add + RMSNorm launch.  JAX's ``_layer_body`` is the Llama layer
loop with the hook (``llama._seq_layers``).

Serving: :class:`MoEServeEngine` (bucketed prefill, decode chunks), and
the batched :class:`MoEContinuousBatchingEngine` and
:class:`MoEPagedBatchingEngine`, the Llama schedulers with the MoE step
and :class:`MoEServeEngine` as their prompt ingester.  The paged engine
reads its pool through K2 on the card, as the port's Llama paged engine
can; JAX's MoE paged engine keeps the plain pool attention because its
step factory does not thread the kernel flag.  On the CPU it keeps the
plain version.

Incremental decode equals the full-sequence forward only while routing
is drop-free (``capacity_factor >= n_experts / top_k``); the batched
engines refuse any other config, as JAX's do.

Over a mesh (``mesh=`` in the three engines, one rank's engine each):
a ``tp`` mesh shards attention, the embedding and the head as the Llama
family's tp serving does (:class:`~tpuslo_torch.models.llama.ShardedParams`)
and every expert's hidden axis (JAX's :func:`tp_serve_param_shardings`),
each rank's cache holding ``n_kv_heads / tp`` heads; an ``ep`` mesh
shards whole experts and replicates everything else, the cache included
(:func:`ep_serve_param_shardings`).  Tokens never move: the MoE block
(:func:`tpuslo_torch.ops.moe.moe_mlp_serve`) reads the mesh from the
sharded tree and makes one f32 ``all_reduce`` per block.  ``mesh=None``
makes no collective call.

Long context: :func:`sp_generate` (the ring prefill and distributed
decode of :mod:`tpuslo_torch.models.longserve` with the MoE block).

Training: :func:`loss_fn` (NLL plus the router's load-balancing term)
and :func:`build_moe_train_step`, on one device or over a ``(dp, ep)``
mesh (:func:`tpuslo_torch.parallel.mesh.dp_ep_mesh`, JAX's layout: whole
experts over ep, everything else replicated, the batch over dp).  The
block differentiates over ep with Megatron's ``f``/``g`` around each
rank's own experts (:func:`tpuslo_torch.ops.moe.moe_mlp_train`), the
ep-serving arithmetic, rather than ``moe_mlp_sharded``'s two
``all_to_all``s: every rank of an ep group already holds the group's
tokens, so no token has to move, and at top 2 the forward is the
one-device block bit for bit.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import Any, Iterator

import torch

from tpuslo_torch.device import resolve_device, synchronize
from tpuslo_torch.models import llama
from tpuslo_torch.models.batching import ContinuousBatchingEngine
from tpuslo_torch.models.bridge import (
    MOE_EP_SPLIT_AXIS,
    MOE_TP_SPLIT_AXIS,
    shard_leaf,
    shard_moe_serve_params,
)
from tpuslo_torch.models.kv_cache import validate_kv_dtype
from tpuslo_torch.models.llama import LlamaConfig, ShardedParams, _dense_init, _set_leaf
from tpuslo_torch.models.paged_kv import PagedBatchingEngine, paged_decode_step
from tpuslo_torch.models.serve import (
    EOS,
    TokenEvent,
    _bucket,
    _HostRead,
    _to_device,
    encode_bytes,
)
from tpuslo_torch.ops.moe import MoEConfig, moe_mlp, moe_mlp_serve, moe_mlp_train
from tpuslo_torch.otel.xla_spans import dispatch_range
from tpuslo_torch.parallel.mesh import batch_sharding

Params = dict[str, Any]


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    router_aux_coef: float = 0.01
    max_seq_len: int = 8192
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def moe(self) -> MoEConfig:
        return MoEConfig(
            dim=self.dim,
            ffn_dim=self.ffn_dim,
            n_experts=self.n_experts,
            top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            dtype=self.dtype,
        )

    def attn_cfg(self) -> LlamaConfig:
        """Attention-relevant view for the shared Llama helpers."""
        return LlamaConfig(
            vocab_size=self.vocab_size,
            dim=self.dim,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            ffn_dim=self.ffn_dim,
            max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
        )


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig()


def mixtral_2b6(max_seq_len: int = 1024) -> MixtralConfig:
    """~2.5B-parameter MoE: E=4 / top_k=2 / cf=2.0 keeps routing
    drop-free (cf >= E/k), so serving equals the full forward."""
    return MixtralConfig(
        vocab_size=32000,
        dim=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=4,
        ffn_dim=5632,
        n_experts=4,
        top_k=2,
        capacity_factor=2.0,
        max_seq_len=max_seq_len,
    )


def mixtral_tiny(max_seq_len: int = 128) -> MixtralConfig:
    return MixtralConfig(
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_dim=128,
        n_experts=4,
        top_k=2,
        capacity_factor=2.0,
        max_seq_len=max_seq_len,
        rope_theta=10000.0,
    )


def param_count(cfg: MixtralConfig) -> int:
    D, F_, L, E = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.n_experts
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = (
        2 * D  # norms
        + D * H * HD
        + 2 * D * KV * HD
        + H * HD * D
        + D * E  # router
        + E * 3 * D * F_  # experts (w1, w3, w2)
    )
    return 2 * cfg.vocab_size * D + D + L * per_layer


def active_param_count(cfg: MixtralConfig) -> int:
    """Parameters a decoded token routes through: all but the
    ``n_experts - top_k`` unrouted experts of each layer (the numerator
    of MoE decode MFU)."""
    expert = cfg.n_layers * cfg.n_experts * 3 * cfg.dim * cfg.ffn_dim
    routed = cfg.n_layers * cfg.top_k * 3 * cfg.dim * cfg.ffn_dim
    return param_count(cfg) - expert + routed


def init_leaves(rng: torch.Generator | int, cfg: MixtralConfig,
                device: str | torch.device = "cuda"):
    """:func:`init_params` one leaf at a time: ``(path, tensor)`` pairs in
    its draw order, so that a caller can keep a part of each leaf and free
    the rest before the next is drawn (a tp or ep rank's shard)."""
    dev = resolve_device(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(rng))
    L, D, F_, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape, fan_in, dtype=cfg.dtype):
        return _dense_init(gen, shape, fan_in, dtype, dev)

    yield "embed", dense((cfg.vocab_size, D), D)
    yield "layers/attn_norm", torch.ones((L, D), dtype=cfg.dtype, device=dev)
    yield "layers/wq", dense((L, D, H * HD), D)
    yield "layers/wk", dense((L, D, KV * HD), D)
    yield "layers/wv", dense((L, D, KV * HD), D)
    yield "layers/wo", dense((L, H * HD, D), H * HD)
    yield "layers/mlp_norm", torch.ones((L, D), dtype=cfg.dtype, device=dev)
    yield "layers/router", dense((L, D, E), D, torch.float32)
    yield "layers/w1", dense((L, E, D, F_), D)
    yield "layers/w3", dense((L, E, D, F_), D)
    yield "layers/w2", dense((L, E, F_, D), F_)
    yield "final_norm", torch.ones((D,), dtype=cfg.dtype, device=dev)
    yield "output", dense((D, cfg.vocab_size), D)


def init_params(
    rng: torch.Generator | int, cfg: MixtralConfig, device: str | torch.device = "cuda"
) -> Params:
    """Layer-stacked tree on ``device`` from a seeded generator (``rng``:
    a ``torch.Generator`` there or an integer seed); expert weights carry
    ``(L, E, ...)`` leaves and the router stays f32.  The draws differ
    from ``jax.random``'s; parity tests carry JAX's weights over
    (``bridge``)."""
    tree: Params = {}
    for path, leaf in init_leaves(rng, cfg, device):
        _set_leaf(tree, path, leaf)
    return tree


def _moe_block(layer: Params, x: torch.Tensor, cfg: MixtralConfig, mesh=None):
    """MoE block over (B, S, D) hidden states -> (output, aux loss),
    through :func:`tpuslo_torch.ops.moe.moe_mlp`; a serving rank's layer
    (``mesh``) through :func:`tpuslo_torch.ops.moe.moe_mlp_serve`, with
    no aux loss."""
    B, S, D = x.shape
    moe_params = {name: layer[name] for name in ("router", "w1", "w3", "w2")}
    if mesh is not None:
        axis = "tp" if "tp" in mesh.axis_names else "ep"
        y = moe_mlp_serve(moe_params, x.reshape(B * S, D), cfg.moe(), mesh, axis)
        return y.reshape(B, S, D), None
    y, aux = moe_mlp(moe_params, x.reshape(B * S, D), cfg.moe(), return_aux=True)
    return y.reshape(B, S, D), aux


def forward(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
            remat: bool = True, return_aux: bool = False):
    """Full-sequence forward -> f32 logits (B, S, vocab); with
    ``return_aux`` also the mean router load-balancing loss over the
    layers (a training loop adds it to the objective).  ``remat`` as in
    :func:`tpuslo_torch.models.llama.forward`: each layer checkpointed in
    a pass that autograd records."""
    aux: list[torch.Tensor] = []
    logits = llama.forward(params, tokens, cfg, mlp_fn=_aux_mlp_fn(cfg), remat=remat, aux=aux)
    if return_aux:
        return logits, torch.stack(aux).mean()
    return logits


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: MixtralConfig, mesh=None) -> torch.Tensor:
    """Cross-entropy plus ``router_aux_coef`` times the router
    load-balancing loss (without it top-k routing collapses onto the
    early-winning experts).

    Over a ``(dp, ep)`` ``mesh`` of more than one rank (``params`` the
    rank's shards under :data:`TRAIN_LAYOUT`, ``tokens`` its dp rows): the
    rank's share of the global loss, the whole loss over dp's size, as in
    ``llama.loss_fn``; the load-balancing term is the whole batch's
    (:func:`tpuslo_torch.ops.moe.moe_mlp_train`)."""
    if mesh is None or mesh.size == 1:
        logits, aux = forward(params, tokens, cfg, return_aux=True)
        return llama.nll_loss(logits, targets) + cfg.router_aux_coef * aux
    aux: list[torch.Tensor] = []
    logits = llama.mesh_logits(params, tokens, cfg, mesh, mlp_fn=_train_mlp_fn(cfg, mesh),
                               aux=aux)
    loss = llama.nll_loss(logits, targets) + cfg.router_aux_coef * torch.stack(aux).mean()
    return loss / mesh.shape.get("dp", 1)


#: JAX's dp x ep training layout (:func:`param_shardings`) as a training
#: table, leaf path -> ``{dim: axis}``: the expert axis of ``w1``, ``w3``
#: and ``w2`` over ep, everything else replicated.
TRAIN_LAYOUT = {path: ({} if dim is None else {dim: "ep"})
                for path, dim in MOE_EP_SPLIT_AXIS.items()}


def _train_mlp_fn(cfg: MixtralConfig, mesh):
    """The ``mlp_fn`` hook of a ``(dp, ep)`` training rank: its experts'
    block, returning ``(output, aux loss)``."""
    def block(layer, x):
        B, S, D = x.shape
        y, aux = moe_mlp_train({name: layer[name] for name in ("router", "w1", "w3", "w2")},
                               x.reshape(B * S, D), cfg.moe(), mesh)
        return y.reshape(B, S, D), aux
    return block


def build_moe_train_step(mesh, cfg: MixtralConfig, optimizer=None):
    """``(step_fn, init_fn)`` of an AdamW step, the contract of
    :func:`tpuslo_torch.models.train.build_sharded_train_step`: on the
    mesh's one device (dp 1, ep 1), or over a ``(dp, ep)`` mesh of more
    than one rank (:data:`TRAIN_LAYOUT`; the gradients summed over dp)."""
    from tpuslo_torch.models import train

    if mesh.size == 1:
        return train.build_step(mesh, cfg, init_params, loss_fn, optimizer)
    if "ep" not in mesh.axis_names:
        raise ValueError(f"the MoE train step needs an 'ep' mesh axis, got {mesh.axis_names}")
    if cfg.n_experts % mesh.shape["ep"]:
        raise ValueError(f"ep={mesh.shape['ep']} must divide n_experts={cfg.n_experts}")
    return train.build_mesh_step(mesh, cfg, dict(TRAIN_LAYOUT), batch_sharding(mesh)[0],
                                 init_leaves, loss_fn, optimizer)


# --- KV-cache serving path ---------------------------------------------


@functools.lru_cache(maxsize=16)
def _aux_mlp_fn(cfg: MixtralConfig):
    """The ``mlp_fn`` hook of the full-sequence forward: MoE, returning
    ``(output, aux loss)``."""
    return lambda layer, x: _moe_block(layer, x, cfg)


@functools.lru_cache(maxsize=16)
def _serving_mlp_fn(cfg: MixtralConfig, mesh=None):
    """The ``mlp_fn`` hook of the Llama serving paths: MoE, aux
    discarded; ``mesh``: a serving rank's block over its tp or ep axis.
    One function object per config and mesh."""
    return lambda layer, x: _moe_block(layer, x, cfg, mesh)[0]


def moe_mesh_of(params: Params):
    """The mesh a serving rank's :class:`ShardedParams` tree is sharded
    over (its ``tp`` or ``ep`` axis), else None."""
    return getattr(params, "mesh", None)


def serving_mlp_fn(params: Params, cfg: MixtralConfig):
    """The MoE ``mlp_fn`` hook for ``params``: over the mesh a sharded
    tree carries, or on one device."""
    return _serving_mlp_fn(cfg, moe_mesh_of(params))


def prefill(params: Params, tokens: torch.Tensor, cache: dict, cfg: MixtralConfig,
            true_length=None):
    """Bucketed prompt ingestion (``llama.prefill`` with the MoE MLP)."""
    return llama.prefill(params, tokens, cache, cfg, true_length=true_length,
                         mlp_fn=serving_mlp_fn(params, cfg))


def verify_chunk(params: Params, tokens: torch.Tensor, cache: dict, cfg: MixtralConfig):
    """Score K tokens against the cache (``llama.verify_chunk`` + MoE)."""
    return llama.verify_chunk(params, tokens, cache, cfg,
                              mlp_fn=serving_mlp_fn(params, cfg))


def decode_step(params: Params, token: torch.Tensor, cache: dict, cfg: MixtralConfig):
    """One greedy token over the cache: :func:`verify_chunk` at K=1."""
    logits, cache = verify_chunk(params, token[:, None], cache, cfg)
    return logits[:, 0], {**cache, "length": cache["length"] + 1}


def decode_chunk(params: Params, token: torch.Tensor, cache: dict, cfg: MixtralConfig,
                 num_tokens: int):
    """Greedy-decode ``num_tokens`` tokens with no host read in between:
    token (B,) -> (tokens (B, num_tokens), last token (B,), cache)."""
    toks = []
    for _ in range(num_tokens):
        logits, cache = decode_step(params, token, cache, cfg)
        token = logits.argmax(dim=-1)
        toks.append(token)
    return torch.stack(toks, dim=1), token, cache


def tp_serve_param_shardings(mesh) -> dict:
    """The tensor-parallel serving layout over ``mesh``'s ``tp`` axis
    (JAX's): :data:`~tpuslo_torch.models.bridge.MOE_TP_SPLIT_AXIS`, the
    dim each leaf path splits over (``None``: replicated).  Megatron's
    layout inside every expert: ``w1``/``w3`` split their hidden axis,
    ``w2`` its contracting axis (one f32 all_reduce a MoE block), and
    attention as the Llama family's; routing stays on every rank."""
    if "tp" not in mesh.axis_names:
        raise ValueError(f"the tp serving layout needs a 'tp' axis, got {mesh.axis_names}")
    return dict(MOE_TP_SPLIT_AXIS)


def param_shardings(mesh) -> dict:
    """The dp x ep layout over ``mesh``'s ``ep`` axis (JAX's):
    :data:`~tpuslo_torch.models.bridge.MOE_EP_SPLIT_AXIS`, the expert axis
    of ``w1``, ``w3`` and ``w2`` split and every other leaf replicated."""
    if "ep" not in mesh.axis_names:
        raise ValueError(f"the ep layout needs an 'ep' axis, got {mesh.axis_names}")
    return dict(MOE_EP_SPLIT_AXIS)


def ep_serve_param_shardings(mesh) -> dict:
    """The expert-parallel serving layout: whole experts over ``ep``,
    attention, the embeddings, the router and the cache replicated.
    Tokens never move (one psum at the combine per MoE block), and each
    rank reads only its own experts' weights per token.  The layout is the
    training placement's, so this returns :func:`param_shardings`, as
    JAX's does."""
    return param_shardings(mesh)


def serve_layout(mesh) -> dict:
    """The serving layout of a MoE mesh's axis: tp's or ep's."""
    if "tp" in mesh.axis_names:
        return tp_serve_param_shardings(mesh)
    return ep_serve_param_shardings(mesh)


def check_moe_mesh(mesh, cfg: MixtralConfig) -> tuple[str, int]:
    """(axis, size) of a MoE serving mesh, with the JAX engine's
    ``ValueError``s: a mesh with both a ``tp`` and an ``ep`` axis, a mesh
    with neither, a tp that does not divide ``n_heads``, ``n_kv_heads``
    and ``ffn_dim``, an ep that does not divide ``n_experts``.  The port
    also needs tp to divide the vocabulary (its shards are contiguous) and
    the axis to span the mesh."""
    if "tp" in mesh.axis_names and "ep" in mesh.axis_names:
        # A combined layout would need expert leaves sharded on both
        # axes; picking one would replicate the experts over the other.
        raise ValueError(
            "MoE serving supports a 'tp' OR an 'ep' mesh axis, "
            "not both; build a 1-axis mesh for the layout you "
            "want"
        )
    if "tp" in mesh.axis_names:
        axis, n = "tp", mesh.shape["tp"]
        if cfg.n_kv_heads % n or cfg.n_heads % n or cfg.ffn_dim % n:
            raise ValueError(
                f"tp={n} must divide n_kv_heads="
                f"{cfg.n_kv_heads}, n_heads={cfg.n_heads} "
                f"and ffn_dim={cfg.ffn_dim}"
            )
        if cfg.vocab_size % n:
            raise ValueError(f"tp={n} must divide vocab_size={cfg.vocab_size}")
    elif "ep" in mesh.axis_names:
        axis, n = "ep", mesh.shape["ep"]
        if cfg.n_experts % n:
            raise ValueError(
                f"ep={n} must divide n_experts="
                f"{cfg.n_experts}"
            )
    else:
        raise ValueError(
            f"MoE serving mesh must have a 'tp' or 'ep' axis, "
            f"got {mesh.axis_names}"
        )
    if math.prod(mesh.shape.values()) != n:
        raise ValueError(f"a MoE serving mesh shards over {axis} alone, got {mesh.shape}")
    return axis, n


def sharded_init_params(rng_seed: int, cfg: MixtralConfig, mesh) -> ShardedParams:
    """This rank's shards of ``init_params(rng_seed, cfg)`` under the
    mesh's tp or ep layout, drawn one leaf at a time on the mesh's device:
    no rank holds the whole expert tree."""
    axis, n = check_moe_mesh(mesh, cfg)
    layout = serve_layout(mesh)
    tree: Params = {}
    for path, leaf in init_leaves(rng_seed, cfg, mesh.device):
        _set_leaf(tree, path, shard_leaf(path, leaf, n, mesh.rank(axis), layout))
        del leaf
    return ShardedParams(tree, mesh)


class MoEServeEngine:
    """Greedy streaming serving for the Mixtral family: bucketed prefill,
    chunked decode, a TokenEvent stream with TTFT (the compact
    counterpart of :class:`~tpuslo_torch.models.serve.ServeEngine`;
    sampling, prefix caching and batching stay Llama-engine features).
    ``device`` defaults to ``"cuda"`` and raises without a card.  With
    ``mesh`` (a ``tp`` or an ``ep`` axis) the engine is one rank's and
    serves on the mesh's device: ``params`` given whole are cut to the
    rank's shards, a tree already sharded over ``mesh`` (another engine's
    ``params``) is kept as it is, and ``params=None`` draws only the
    rank's shards."""

    def __init__(
        self,
        cfg: MixtralConfig | None = None,
        params: Params | None = None,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128),
        decode_chunk_size: int = 16,
        mesh=None,
        kv_dtype: str = "bf16",
        device: str | torch.device = "cuda",
    ):
        self.kv_dtype = validate_kv_dtype(kv_dtype)
        self.cfg = cfg or mixtral_tiny(max_seq_len=256)
        self.mesh, self.tp, self.ep = mesh, 1, 1
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None:
            axis, n = check_moe_mesh(mesh, self.cfg)
            setattr(self, axis, n)
            if params is None:
                params = sharded_init_params(rng_seed, self.cfg, mesh)
            elif moe_mesh_of(params) is not mesh:
                shards = shard_moe_serve_params(params, serve_layout(mesh), n, mesh.rank(axis))
                params = ShardedParams(_to_device(shards, self.device), mesh)
        elif params is None:
            params = init_params(rng_seed, self.cfg, self.device)
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine serves on "
                f"{self.device}"
            )
        self.params = params
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= self.cfg.max_seq_len
        ) or (self.cfg.max_seq_len,)
        self.decode_chunk_size = max(
            1, min(decode_chunk_size, (self.cfg.max_seq_len - 2) // 2)
        )

    def _new_cache(self, batch: int) -> dict:
        return llama.init_kv_cache(self.cfg, batch, kv_dtype=self.kv_dtype,
                                   device=self.device, tp=self.tp)

    def _decode(self, token: torch.Tensor, cache: dict):
        with dispatch_range("decode_chunk", token, self.decode_chunk_size):
            return decode_chunk(self.params, token, cache, self.cfg, self.decode_chunk_size)

    def warmup(self) -> float:
        """One prefill at the smallest bucket and one decode chunk
        (building the kernels at first use); returns ms."""
        start = time.perf_counter()
        bucket = self.prefill_buckets[0]
        logits, cache = self.prefill_ids([0] * bucket)
        self._decode(logits.argmax(dim=-1), cache)
        synchronize(self.device)
        return (time.perf_counter() - start) * 1000.0

    def ingest_prompt(self, prompt: str, prefix: str | None = None):
        """(last-position logits, single-row cache, prompt length): the
        continuous-batching admission contract.  The MoE engine has no
        prefix cache, so a prefix is refused rather than dropped."""
        if prefix:
            raise ValueError(
                "the MoE engine has no prefix cache; submit without "
                "prefix= or serve the llama family"
            )
        ids = encode_bytes(prompt, self.generation_prompt_cap())
        logits, cache = self.prefill_ids(ids)
        return logits, cache, len(ids)

    def generation_prompt_cap(self) -> int:
        """Max prompt ids :meth:`generate` decodes from: a whole decode
        chunk is budgeted after the prompt (no single-token tail path)."""
        chunk = self.decode_chunk_size
        return max(1, min(self.prefill_buckets[-1], self.cfg.max_seq_len - chunk - 1))

    def prefill_ids(self, ids: list[int]):
        """Bucketed single-row prefill of encoded ids: (logits (1, vocab),
        cache with ``length=len(ids)``).  Parity checks teacher-force a
        divergent stream through it to tell a near-tie from a fault."""
        bucket = _bucket(len(ids), self.prefill_buckets)
        tokens = torch.tensor([ids + [0] * (bucket - len(ids))], dtype=torch.long,
                              device=self.device)
        with dispatch_range("prefill", tokens):
            return prefill(self.params, tokens, self._new_cache(1), self.cfg,
                           true_length=len(ids))

    def decode_cap_tokens(self, longest_prompt_len: int) -> int:
        """Whole decode chunks only; :meth:`generation_prompt_cap` leaves
        room for at least one."""
        chunk = self.decode_chunk_size
        avail = self.cfg.max_seq_len - longest_prompt_len - 1
        return max(1, (avail // chunk) * chunk)

    def generate(self, prompt: str, max_new_tokens: int = 32,
                 stop_at_eos: bool = True) -> Iterator[TokenEvent]:
        """Greedy TokenEvents.  The first token comes from the prefill and
        is read and yielded (with its TTFT) before the first decode chunk
        is queued; chunk N+1 is queued before chunk N is read."""
        request_start = time.perf_counter()
        chunk = self.decode_chunk_size
        logits, cache, total_len = self.ingest_prompt(prompt)
        max_new_tokens = max(1, min(max_new_tokens, self.decode_cap_tokens(total_len)))
        token = logits.argmax(dim=-1)
        first = int(token[0])
        yield TokenEvent(first, 0, ttft_ms=(time.perf_counter() - request_start) * 1000.0)
        if (stop_at_eos and first == EOS) or max_new_tokens <= 1:
            return
        toks, last, cache = self._decode(token, cache)
        pending = _HostRead(toks[0])
        idx = 1
        while idx < max_new_tokens:
            next_read = next_last = None
            if idx + chunk < max_new_tokens:
                next_toks, next_last, cache = self._decode(last, cache)
                next_read = _HostRead(next_toks[0])
            for value in pending.values():
                yield TokenEvent(int(value), idx)
                idx += 1
                if (stop_at_eos and value == EOS) or idx >= max_new_tokens:
                    return
            pending, last = next_read, next_last


class _MoEBatchedContract:
    """What the batched MoE engines (dense and paged) add to the Llama
    schedulers.

    Batched decode feeds every slot row through one capacity pool, so
    with routing that can drop tokens a request's drops would depend on
    the requests beside it: such configs are refused up front.  A
    ``prefix`` is refused at submit (an admission-time raise would strand
    the requests in flight): the MoE family has no prefix cache.
    """

    @staticmethod
    def _require_drop_free(cfg: MixtralConfig) -> MixtralConfig:
        if cfg.capacity_factor < cfg.n_experts / cfg.top_k:
            raise ValueError(
                f"batched MoE serving requires drop-free routing: "
                f"capacity_factor={cfg.capacity_factor} < n_experts/top_k="
                f"{cfg.n_experts / cfg.top_k}; raise capacity_factor or "
                "serve single-request via MoEServeEngine"
            )
        return cfg

    @staticmethod
    def _make_ingest(cfg, params, rng_seed, prefill_buckets, decode_chunk_size,
                     kv_dtype, mesh, device) -> MoEServeEngine:
        return MoEServeEngine(
            cfg=cfg, params=params, rng_seed=rng_seed, prefill_buckets=prefill_buckets,
            decode_chunk_size=decode_chunk_size, kv_dtype=kv_dtype, mesh=mesh,
            device=device,
        )

    def submit(self, prompt, max_new_tokens=32, stop_at_eos=True, prefix=None):
        if prefix:
            raise ValueError(
                "the MoE engine has no prefix cache; submit without "
                "prefix= or serve the llama family"
            )
        return super().submit(prompt, max_new_tokens=max_new_tokens,
                              stop_at_eos=stop_at_eos)


class MoEContinuousBatchingEngine(_MoEBatchedContract, ContinuousBatchingEngine):
    """Continuous batching for the MoE family: the Llama scheduler with
    the MoE block in the batched decode step (``llama.decode_step``'s
    hook) and :class:`MoEServeEngine` as the prompt ingester.  Each
    request's stream equals its single-request MoE stream."""

    def __init__(
        self,
        cfg: MixtralConfig | None = None,
        params: Params | None = None,
        max_slots: int = 4,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128),
        decode_chunk_size: int = 16,
        kv_dtype: str = "bf16",
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        cfg = self._require_drop_free(cfg or mixtral_tiny(max_seq_len=256))
        ingest = self._make_ingest(cfg, params, rng_seed, prefill_buckets,
                                   decode_chunk_size, kv_dtype, mesh, device)
        super().__init__(
            cfg=cfg, max_slots=max_slots, rng_seed=rng_seed,
            prefill_buckets=prefill_buckets, kv_dtype=kv_dtype, ingest=ingest,
            step_fn=functools.partial(llama.decode_step, cfg=cfg,
                                      mlp_fn=serving_mlp_fn(ingest.params, cfg)),
        )


class MoEPagedBatchingEngine(_MoEBatchedContract, PagedBatchingEngine):
    """Paged-pool continuous batching for the MoE family: the Llama paged
    engine's allocator, page tables and backpressure with the MoE block
    in ``paged_decode_step``'s hook and :class:`MoEServeEngine` as the
    prompt ingester (no prefix, so no shared blocks).  The pool attention
    is K2 on a card and the plain pool attention on the CPU."""

    def __init__(
        self,
        cfg: MixtralConfig | None = None,
        params: Params | None = None,
        max_slots: int = 4,
        n_blocks: int | None = None,
        block_size: int = 64,
        rng_seed: int = 0,
        prefill_buckets: tuple[int, ...] = (32, 64, 128),
        decode_chunk_size: int = 16,
        kv_dtype: str = "bf16",
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        cfg = self._require_drop_free(cfg or mixtral_tiny(max_seq_len=256))
        # Bad block geometry fails before the MoE ingest is built.
        PagedBatchingEngine.validate_block_geometry(cfg, block_size)
        ingest = self._make_ingest(cfg, params, rng_seed, prefill_buckets,
                                   decode_chunk_size, kv_dtype, mesh, device)
        pallas_attention = ingest.device.type == "cuda"
        super().__init__(
            cfg=cfg, max_slots=max_slots, n_blocks=n_blocks, block_size=block_size,
            rng_seed=rng_seed, prefill_buckets=prefill_buckets, kv_dtype=kv_dtype,
            pallas_attention=pallas_attention, share_prefixes=False, ingest=ingest,
            paged_step_fn=functools.partial(
                paged_decode_step, cfg=cfg, block_size=block_size,
                pallas=pallas_attention, mlp_fn=serving_mlp_fn(ingest.params, cfg),
            ),
        )


def sp_generate(
    params: Params,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    mesh,
    max_new_tokens: int,
    **kwargs,
) -> torch.Tensor:
    """Long-context MoE generation over an ``sp`` mesh.

    :func:`tpuslo_torch.models.longserve.sp_generate` with the MoE block
    through the same ``mlp_fn`` hook as every other Llama-family path.
    Routing is positionwise, so it runs on each rank's piece of the
    sequence; the config must be drop-free (``capacity_factor >=
    n_experts / top_k``) so that a rank's capacity buffers never drop a
    token the single-device path keeps, the contract the batched MoE
    engines hold.
    """
    from tpuslo_torch.models import longserve

    cfg = _MoEBatchedContract._require_drop_free(cfg)
    return longserve.sp_generate(
        params, tokens, cfg, mesh, max_new_tokens,
        mlp_fn=_serving_mlp_fn(cfg), **kwargs,
    )


__all__ = [
    "MixtralConfig",
    "MoEContinuousBatchingEngine",
    "MoEPagedBatchingEngine",
    "MoEServeEngine",
    "active_param_count",
    "check_moe_mesh",
    "decode_chunk",
    "decode_step",
    "ep_serve_param_shardings",
    "forward",
    "init_leaves",
    "init_params",
    "mixtral_2b6",
    "mixtral_8x7b",
    "mixtral_tiny",
    "param_count",
    "param_shardings",
    "prefill",
    "sp_generate",
    "tp_serve_param_shardings",
    "verify_chunk",
]
