"""Llama-family model in PyTorch (port of ``tpuslo/models/llama.py``).

The same model and the same arithmetic as the JAX module, written in
PyTorch's idiom:

* parameters are a plain dict of tensors under the JAX leaf names
  (``embed``, ``layers.{wq,wk,wv,wo,w1,w3,w2,attn_norm,mlp_norm}``,
  ``final_norm``, ``output``), stacked along a leading layer axis with
  the ``x @ w`` convention, so carrying JAX weights over is a copy
  (:mod:`tpuslo_torch.models.bridge`);
* the forward pass is eager: a Python loop over the layer axis where
  JAX scans, and KV writes update the cache tensors in place where JAX
  returns new arrays;
* every matmul accumulates in f32 and rounds once to the model dtype
  (``_matmul``), as ``dot_general(..., preferred_element_type=f32)``
  does; :func:`tpuslo_torch.device.resolve_device` turns off cuBLAS's
  reduced-precision bf16 reduction so that this holds on the card too;
* causal full-sequence attention at a flash-eligible shape goes through
  :func:`tpuslo_torch.ops.flash_attention.flash_attention`, which runs
  the Hopper kernel for CUDA tensors and its plain version for CPU
  tensors.  The routing depends on the tensors' device and the shape
  only.  On the CPU, decode and verify attend over the whole
  preallocated cache with the plain :func:`attention`, as the JAX module
  leaves them to XLA.

On the card every pass is batch-invariant: a row's output bits do not
depend on how many rows share its batch or on what they hold, so a
front door's slots decode exactly as a single stream does (the JAX
package's guarantee, held in bf16).  Each op whose bits would
otherwise depend on the batch takes a path whose arithmetic is fixed
per row:

* the cached passes' attention reads the dense cache as K2's lanes, one
  query per lane (:func:`tpuslo_torch.ops.dense_lanes.dense_lane_attention`),
  in the cache's own dtype: no pass copies a whole cache to f32;
* :func:`rms_norm` launches the batch-invariant RMSNorm kernel
  (:mod:`tpuslo_torch.ops.rms_norm`), and every residual add that feeds
  a norm goes with it into one launch of the fused add + RMSNorm kernel
  (:func:`add_rms_norm`): the add's bits are the eager add's, and only
  the first layer's ``attn_norm`` runs alone;
* :func:`_matmul` runs every weight product of a cached pass as pieces
  of :data:`GEMM_ROWS` rows, the last one zero-padded, so that cuBLAS
  runs one kernel, chosen for one shape, whatever the number of rows;
* a full-sequence pass (prefill, forward) runs each batch row's weight
  products (:func:`_seq_matmul`) and, where it is not flash-eligible,
  its attention at a lone prefill's shape, so that a batched admission
  gives every request a lone prefill's bits and a lone prefill runs as
  one product per weight (K1 computes each row in CTAs of its own
  already).

Tensor parallelism (Megatron's layout, the JAX package's
``serve_param_shardings``): a :class:`ShardedParams` tree holds one tp
rank's shards and the mesh they are sharded over
(:func:`tpuslo_torch.models.bridge.shard_serve_params`).  The layers read
their local heads (``H / tp`` over ``KV / tp``) from the shards' widths,
and where GSPMD inserts collectives in JAX the port calls them
(:mod:`tpuslo_torch.parallel.mesh`):

* the embedding's vocab rows are sharded: a masked local lookup, then an
  all_reduce, which is exact (one rank's row plus zeros);
* ``wo`` and ``w2`` take the sharded input axis: each rank's partial
  product is rounded once to the model dtype, as the unsharded product
  is, and the all_reduce sums the partials in that dtype.  The products
  are then the same calls as without a mesh and a one-rank reduction
  returns them unchanged, so tp 1 is bit for bit the unsharded model;
  at tp 2 the sum of two rounded partials adds one rounding (bf16 at
  2**-8 of the value; PERF.md gives the logits' error);
* the output head's vocab columns are sharded: the logits are gathered
  (all_gather, exact) before sampling, so every rank samples the same
  tokens.

A plain dict (no mesh) runs none of this, bit for bit as before.  The
batch-invariant 128-row product pieces stay per rank.

Training (:func:`loss_fn`, ``forward(..., remat=True)``) differentiates
the same layers: K1 and both norm kernels run their forwards on the card
inside ``torch.autograd.Function``s whose backwards are the plain
PyTorch of the JAX package's gradients, each layer runs under
``torch.utils.checkpoint``, and the products take the whole batch at
once, as the JAX module's do.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpuslo_torch.device import resolve_device
from tpuslo_torch.models import kv_cache as kvc
from tpuslo_torch.ops import launch_counts
from tpuslo_torch.ops.dense_lanes import dense_lane_attention
from tpuslo_torch.ops.flash_attention import flash_attention, flash_eligible
from tpuslo_torch.ops.rms_norm import add_rms_norm as ops_add_rms_norm
from tpuslo_torch.ops.rms_norm import rms_norm as ops_rms_norm
from tpuslo_torch.parallel import mesh as mesh_mod

Params = dict[str, Any]


class ShardedParams(dict):
    """One tp rank's shards of a parameter tree, carrying ``mesh``, the
    mesh they are sharded over on its ``tp`` axis (see the module
    docstring)."""

    def __init__(self, tree: Params, mesh):
        super().__init__(tree)
        self.mesh = mesh


def tp_mesh_of(params: Params):
    """The mesh a :class:`ShardedParams` tree is sharded over, else None."""
    return getattr(params, "mesh", None)


def _width(w) -> int:
    return (w["q"] if isinstance(w, dict) else w).shape[-1]


def local_heads(cfg, layer: Params) -> tuple[int, int]:
    """(query heads, kv heads) a layer's weights hold: all of them, or one
    tp rank's share."""
    return _width(layer["wq"]) // cfg.head_dim, _width(layer["wk"]) // cfg.head_dim


def _reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the tp ranks' partial products (no mesh: ``t``)."""
    return t if mesh is None else mesh_mod.all_reduce(t, mesh, "tp")


def _logits(params: Params, h: torch.Tensor, matmul) -> torch.Tensor:
    """The output head's f32 logits over the whole vocabulary: a sharded
    head's vocab columns gathered from every tp rank."""
    out = matmul(h, params["output"])
    mesh = tp_mesh_of(params)
    if mesh is not None:
        out = mesh_mod.all_gather(out, mesh, "tp", dim=-1)
    return out.float()


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama3_70b() -> LlamaConfig:
    return LlamaConfig(
        dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672
    )


def llama32_3b(max_seq_len: int = 2048) -> LlamaConfig:
    """Llama-3.2-3B-class config with untied embeddings (~3.6 B params,
    ~7.2 GB in bf16)."""
    return LlamaConfig(
        dim=3072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=max_seq_len,
    )


def llama32_1b(max_seq_len: int = 2048) -> LlamaConfig:
    """Llama-3.2-1B-class config (~1.5 B params untied, ~3 GB bf16)."""
    return LlamaConfig(
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=8192,
        max_seq_len=max_seq_len,
    )


def llama_tiny(max_seq_len: int = 256) -> LlamaConfig:
    """Tiny config for tests and dry runs."""
    return LlamaConfig(
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_dim=128,
        max_seq_len=max_seq_len,
        rope_theta=10000.0,
    )


def param_count(cfg: LlamaConfig) -> int:
    """Exact parameter count of :func:`init_params` for this config."""
    D, F_, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = (
        2 * D  # attn_norm + mlp_norm
        + D * H * HD  # wq
        + 2 * D * KV * HD  # wk, wv
        + H * HD * D  # wo
        + 2 * D * F_  # w1, w3
        + F_ * D  # w2
    )
    return 2 * cfg.vocab_size * D + D + L * per_layer


_DENSE_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def _param_layout(cfg: LlamaConfig):
    """(embed, layer-leaves, output) shapes and fan-ins."""
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer_dense = {
        "wq": ((L, D, H * HD), D),
        "wk": ((L, D, KV * HD), D),
        "wv": ((L, D, KV * HD), D),
        "wo": ((L, H * HD, D), H * HD),
        "w1": ((L, D, F_), D),
        "w3": ((L, D, F_), D),
        "w2": ((L, F_, D), F_),
    }
    return ((cfg.vocab_size, D), D), layer_dense, ((D, cfg.vocab_size), D)


def _dense_init(gen, shape, fan_in, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * fan_in**-0.5).to(dtype)


def init_params(
    rng: torch.Generator | int, cfg: LlamaConfig, device: str | torch.device = "cuda"
) -> Params:
    """Layer-stacked parameters drawn on ``device`` from a seeded
    generator: normal weights scaled by ``fan_in ** -0.5``, unit norms.

    ``rng`` is a ``torch.Generator`` on ``device`` or an integer seed.
    The draws differ from ``jax.random``'s; tests that compare the two
    frameworks carry the JAX weights over instead (``bridge``).
    """
    tree: Params = {}
    for path, leaf in init_leaves(rng, cfg, device):
        _set_leaf(tree, path, leaf)
    return tree


def _set_leaf(tree: dict, path: str, leaf) -> None:
    *parents, name = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[name] = leaf


def init_leaves(rng: torch.Generator | int, cfg: LlamaConfig,
                device: str | torch.device = "cuda"):
    """:func:`init_params` one leaf at a time: ``(path, tensor)`` pairs
    (``"embed"``, ``"layers/wq"``, ...), drawn in :func:`init_params`'s
    order, so that a caller can keep a part of each leaf and free the
    rest before the next is drawn (a tp rank's shard)."""
    dev = resolve_device(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(rng))
    (e_shape, e_fan), layer_dense, (o_shape, o_fan) = _param_layout(cfg)
    yield "embed", _dense_init(gen, e_shape, e_fan, cfg.dtype, dev)
    for name in _DENSE_LEAVES:
        yield f"layers/{name}", _dense_init(gen, *layer_dense[name], cfg.dtype, dev)
    L, D = cfg.n_layers, cfg.dim
    yield "layers/attn_norm", torch.ones((L, D), dtype=cfg.dtype, device=dev)
    yield "layers/mlp_norm", torch.ones((L, D), dtype=cfg.dtype, device=dev)
    yield "final_norm", torch.ones((D,), dtype=cfg.dtype, device=dev)
    yield "output", _dense_init(gen, o_shape, o_fan, cfg.dtype, dev)


# --- int8 weight-only quantization -------------------------------------


def _quantize_leaf(w: torch.Tensor) -> dict:
    """{"q": int8, "s": f32} with scales over the contracting axis (-2):
    one scale per output channel of a (.., D, F) weight, one per feature
    of the (V, D) embedding.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    w32 = w.float()
    s = w32.abs().amax(dim=-2) / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(w32 / s[..., None, :]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params(params: Params) -> Params:
    """Quantize all matmul weights of an :func:`init_params` tree to
    int8.  Norm scales stay in the model dtype."""
    layers = dict(params["layers"])
    for name in _DENSE_LEAVES:
        layers[name] = _quantize_leaf(layers[name])
    return {
        "embed": _quantize_leaf(params["embed"]),
        "layers": layers,
        "final_norm": params["final_norm"],
        "output": _quantize_leaf(params["output"]),
    }


def quantized_bytes(cfg: LlamaConfig) -> int:
    """Device bytes for a quantized tree: int8 weight bodies, f32
    per-output-channel scales, norm vectors in the model dtype."""
    D, F_, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = param_count(cfg)
    norm_params = L * 2 * D + D
    scale_params = (
        L * (H * HD + 2 * KV * HD + D + 2 * F_ + D)  # wq wk wv wo w1 w3 w2
        + D  # embed (scales over vocab axis -> one per dim)
        + cfg.vocab_size  # output head
    )
    return (n - norm_params) + 4 * scale_params + 2 * norm_params


# --- layer math ---------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype, then scaled by the weight
    (in that order, as the JAX module does): the plain version on the
    CPU, the batch-invariant kernel on the card."""
    return ops_rms_norm(x, weight, eps)


def add_rms_norm(h: torch.Tensor, d: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``h + d`` and :func:`rms_norm` of its rounded
    result: the eager add and norm on the CPU, one fused launch on the
    card."""
    return ops_add_rms_norm(h, d, weight, eps)


def _next_norm(params: Params, i: int) -> torch.Tensor:
    """The norm weight after layer ``i``'s MLP: the next layer's
    ``attn_norm``, or ``final_norm`` after the last layer."""
    layers = params["layers"]["attn_norm"]
    return layers[i + 1] if i + 1 < layers.shape[0] else params["final_norm"]


def rope_frequencies(
    cfg: LlamaConfig, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables in f32 for given positions; shape (..., head_dim/2)."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (cfg.rope_theta**exponent)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation in f32; x: (B, S, heads, head_dim),
    cos/sin: (B, S, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(x.dtype)


#: Rows of every weight product on the card: 128 covers the widest
#: dispatch (16 slots x (k + 1) = 80 query rows at k 4).
GEMM_ROWS = 128


def _product(x: torch.Tensor, w, wq=None) -> torch.Tensor:
    if isinstance(w, dict):
        out = torch.matmul(x.float(), w["q"].float() if wq is None else wq)
        return (out * w["s"]).to(x.dtype)
    return torch.matmul(x, w)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` accumulated in f32 and rounded once to x's dtype.

    ``w`` is a dense tensor or an int8 dict {"q", "s"}.  Dense: PyTorch's
    GEMM accumulates in f32 and rounds its output once.  int8: the
    product is taken in f32 (int8 codes and bf16 activations are exact
    in f32), scaled per output channel, and rounded once, which is the
    JAX module's dequantize-in-the-accumulator arithmetic.

    On the card the rows run as pieces of :data:`GEMM_ROWS` rows, the
    last one zero-padded: cuBLAS picks its kernel by the shape and the
    alignment of a product, and with one shape for every call a row's
    bits do not depend on how many rows the call has.  A full piece is a
    view of the rows (at a multiple of ``GEMM_ROWS`` rows from a fresh
    tensor, aligned as a padded piece is: 256 bytes or more, the most
    cuBLASLt tells apart), a short one a fresh padded tensor.
    """
    if x.device.type != "cuda":
        return _product(x, w)
    return _matmul_fixed(x, w)


def _seq_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """:func:`_matmul` of a full-sequence pass: on the card one product
    per batch row, each at a lone prefill's shape."""
    if x.device.type != "cuda" or x.shape[0] == 1:
        return _product(x, w)
    return _matmul_rows(x, w)


def _matmul_rows(x: torch.Tensor, w) -> torch.Tensor:
    """:func:`_seq_matmul` on the card: ``x[b:b + 1] @ w`` for each
    batch row ``b`` (any device runs it)."""
    wq = w["q"].float() if isinstance(w, dict) else None
    return torch.cat([_product(x[b:b + 1], w, wq) for b in range(x.shape[0])])


def _matmul_fixed(x: torch.Tensor, w) -> torch.Tensor:
    """:func:`_matmul` as pieces of :data:`GEMM_ROWS` rows (the card's
    path; any device runs it)."""
    lead, d_in = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, d_in)
    if rows.data_ptr() % 256:  # full pieces are views: keep them 256-byte aligned
        rows = rows.clone()
    wq = w["q"].float() if isinstance(w, dict) else None
    pieces = []
    for r0 in range(0, rows.shape[0], GEMM_ROWS):
        piece = rows[r0:r0 + GEMM_ROWS]
        n = piece.shape[0]
        if n < GEMM_ROWS:
            piece = F.pad(piece, (0, 0, 0, GEMM_ROWS - n))
        pieces.append(_product(piece, w, wq)[:n])
    if not pieces:
        return _product(rows, w, wq).reshape(*lead, -1)
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return out.reshape(*lead, out.shape[-1])


def _embed_lookup(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather for dense or quantized embedding tables; a tp
    rank's vocab rows: a masked local lookup summed over the ranks."""
    e = params["embed"]
    mesh = tp_mesh_of(params)
    inside = None
    if mesh is not None:
        rows = (e["q"] if isinstance(e, dict) else e).shape[0]
        tokens = tokens - mesh.rank("tp") * rows
        inside = (tokens >= 0) & (tokens < rows)
        tokens = torch.where(inside, tokens, torch.zeros_like(tokens))
    if isinstance(e, dict):
        h = (e["q"][tokens].float() * e["s"]).to(dtype)
    else:
        h = e[tokens].to(dtype)
    if mesh is None:
        return h
    return _reduce(torch.where(inside[..., None], h, torch.zeros_like(h)), mesh)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    n_rep: int,
) -> torch.Tensor:
    """GQA attention.  q: (B,S,H,hd); k/v: (B,T,KV,hd); mask: (S,T)
    shared or (B,S,T) per row.

    Logits are f32 products of the inputs, masked with ``-1e30``; the
    softmax weights are cast to v's dtype before the second product,
    which again accumulates in f32 (the JAX module's arithmetic).  Head
    h reads kv head ``h // n_rep`` through a grouped einsum, without
    repeating k/v.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, KV, n_rep, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()).reshape(B, H, S, T)
    logits = logits * hd**-0.5
    if mask.ndim == 2:
        mask = mask[None]
    logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
    weights = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum(
        "bgrst,btgd->bsgrd", weights.reshape(B, KV, n_rep, S, T), v.float()
    )
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_block(
    cfg,
    h: torch.Tensor,
    layer: Params,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    causal: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Pre-norm GQA attention + residual; returns (hidden, (k, v)).

    ``causal=True`` asserts that ``mask`` is the full causal tril (the
    caller owns that invariant) and sends flash-eligible shapes through
    :func:`flash_attention`.
    """
    x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    out, kv = _attention_out(cfg, x, layer, cos, sin, mask, causal)
    return h + out, kv


def _attention_out(cfg, x: torch.Tensor, layer: Params, cos: torch.Tensor,
                   sin: torch.Tensor, mask: torch.Tensor, causal: bool,
                   invariant: bool = True, mesh=None):
    """:func:`attention_block` from the normalized ``x``, before the
    residual: (the ``wo`` product, (k, v)).  ``invariant=False`` (a pass
    that autograd records) runs each product and the plain attention over
    the whole batch at once instead of row by row.  ``mesh``: a tp
    rank's layer, whose ``wo`` partials are summed over the ranks."""
    B, S, _ = x.shape
    (H, KV), HD = local_heads(cfg, layer), cfg.head_dim
    matmul = _seq_matmul if invariant else _product
    q = matmul(x, layer["wq"]).reshape(B, S, H, HD)
    k = matmul(x, layer["wk"]).reshape(B, S, KV, HD)
    v = matmul(x, layer["wv"]).reshape(B, S, KV, HD)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if causal and flash_eligible(tuple(q.shape), KV):
        attn = flash_attention(q, k, v, causal=True)
    elif invariant and x.device.type == "cuda" and B > 1:
        # One row at a time: the batched products would pick their
        # kernels by the batch.
        attn = torch.cat([attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    mask if mask.ndim == 2 else mask[b:b + 1], H // KV)
                          for b in range(B)])
    else:
        attn = attention(q, k, v, mask, H // KV)
    return _reduce(matmul(attn.reshape(B, S, H * HD), layer["wo"]), mesh), (k, v)


def _dense_mlp(cfg, layer: Params, x: torch.Tensor, i: int | None = None,
               matmul=_matmul, mesh=None) -> torch.Tensor:
    """SwiGLU MLP on normalized hidden states (``i``: the layer index
    that :func:`trace_ops` records the products under; ``matmul``:
    :func:`_seq_matmul` in a full-sequence pass; ``mesh``: a tp rank's
    FFN columns, whose ``w2`` partials are summed over the ranks)."""
    gate = F.silu(_traced("w1", i, matmul(x, layer["w1"])).float())
    up = _traced("w3", i, matmul(x, layer["w3"])).float()
    act = _traced("silu_mul", i, (gate * up).to(cfg.dtype))
    return _traced("w2", i, _reduce(matmul(act, layer["w2"]), mesh))


def _seq_layers(params: Params, cfg: LlamaConfig, h: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, mask: torch.Tensor, write=None, mlp_fn=None,
                remat: bool = False, invariant: bool = True, aux: list | None = None
                ) -> torch.Tensor:
    """The layer loop of a full-sequence pass (causal ``mask``), with the
    final norm: each residual add reaches the norm after it in one
    :func:`add_rms_norm`.  ``write(i, k, v)`` takes layer ``i``'s rotated
    K and V.  ``mlp_fn(layer, x)`` swaps the dense MLP for another block
    body (the Mixtral family's MoE); the adds and norms around it stay.
    With ``aux`` (a list) ``mlp_fn`` returns ``(y, a)`` and each layer's
    ``a`` is appended to it.

    ``remat=True`` runs each layer under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` over the
    ``(h, x)`` carry (the residual stream and its norm), as the JAX
    module's ``jax.checkpoint`` layer body: the backward pass runs each
    layer's forward again instead of keeping its activations.
    ``invariant`` as in :func:`_attention_out`.

    A pass that autograd records (``invariant=False``) takes its layers
    from one ``unbind`` of each layer-stacked leaf: the backward then
    writes each leaf's gradient once, where indexing layer by layer would
    add a zero-filled leaf-sized gradient per layer (the 3B step's
    largest cost on the card before)."""
    if invariant:
        def layer_at(i):
            return _layer(params, i)
        attn_norms = params["layers"]["attn_norm"]
    else:
        split = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}

        def layer_at(i):
            return {name: leaves[i] for name, leaves in split.items()}
        attn_norms = split["attn_norm"]

    def next_norm(i):
        return attn_norms[i + 1] if i + 1 < cfg.n_layers else params["final_norm"]

    mesh = tp_mesh_of(params)

    def layer_step(h, x, i):
        layer = layer_at(i)
        out, (k, v) = _attention_out(cfg, x, layer, cos, sin, mask, causal=True,
                                     invariant=invariant, mesh=mesh)
        if write is not None:
            write(i, k, v)
        h, x = add_rms_norm(h, out, layer["mlp_norm"], cfg.norm_eps)
        if mlp_fn is None:
            mlp = _dense_mlp(cfg, layer, x, matmul=_seq_matmul if invariant else _product,
                             mesh=mesh)
        else:
            mlp = mlp_fn(layer, x)
        if aux is None:
            return add_rms_norm(h, mlp, next_norm(i), cfg.norm_eps)
        mlp, a = mlp
        return (*add_rms_norm(h, mlp, next_norm(i), cfg.norm_eps), a)

    x = rms_norm(h, attn_norms[0], cfg.norm_eps)
    for i in range(cfg.n_layers):
        if remat:
            out = checkpoint(layer_step, h, x, i, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = layer_step(h, x, i)
        h, x = out[0], out[1]
        if aux is not None:
            aux.append(out[2])
    return x


def _at(leaf, i: int):
    """Layer ``i`` of a layer-stacked leaf (a tensor or an int8 dict), as
    views: writes into a cache side's views reach the cache."""
    return kvc.kv_map(lambda a: a[i], leaf)


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameter leaves."""
    return {name: _at(leaf, i) for name, leaf in params["layers"].items()}


def _differentiated(params: Params) -> bool:
    """Does autograd record a pass over ``params``?  (Grad mode is on and
    a leaf requires grad: a training step, never a serving pass.)"""
    if not torch.is_grad_enabled():
        return False
    leaves = [params["embed"], params["final_norm"], params["output"],
              *params["layers"].values()]
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            mlp_fn=None, remat: bool = True, aux: list | None = None) -> torch.Tensor:
    """Full-sequence forward -> f32 logits (B, S, vocab); ``mlp_fn`` and
    ``aux`` as in :func:`_seq_layers`.

    A pass that autograd records (a training step) checkpoints each layer
    when ``remat`` (the JAX module's default) and runs each weight product
    over the whole batch at once, as the JAX module does; batch
    invariance is a serving property.  Any other pass is the serving
    forward, with its bits unchanged: ``remat`` has nothing to save there
    and is ignored."""
    B, S = tokens.shape
    dev = tokens.device
    train = _differentiated(params)
    positions = torch.arange(S, device=dev).expand(B, S)
    h = _embed_lookup(params, tokens, cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    h = _seq_layers(params, cfg, h, cos, sin, mask, mlp_fn=mlp_fn, remat=remat and train,
                    invariant=not train, aux=aux)
    return _logits(params, h, _product if train else _seq_matmul)


def nll_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood from f32 logits (B, S, V)
    and integer targets (B, S): ``log_softmax``, then the target's entry,
    as the JAX module's ``loss_fn`` computes it."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of :func:`forward`'s logits."""
    return nll_loss(forward(params, tokens, cfg), targets)


# --- KV-cache decode path ----------------------------------------------


def init_kv_cache(
    cfg: LlamaConfig,
    batch: int,
    kv_dtype: str = "bf16",
    device: str | torch.device = "cuda",
    tp: int = 1,
) -> dict:
    """Preallocated cache ``{"k", "v", "length"}``; ``kv_dtype="int8"``
    stores K/V quantized (see :mod:`tpuslo_torch.models.kv_cache`).
    ``tp``: one tp rank's cache, holding its ``n_kv_heads / tp`` heads.

    ``length`` is a Python int while every row sits at the same position
    and the host knows it (so no device read is needed to slice), a
    ``(B,)`` int64 tensor once rows have their own lengths, and a 0-d
    int64 tensor where one shared frontier advances by a count that only
    the device knows (a speculative stream's accepted tokens): decode and
    verify then take the per-row path with the frontier broadcast, and
    hand the length back 0-d, with no host read.
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads // tp, cfg.head_dim)
    return {
        "k": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "v": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "length": 0,
    }


def kv_cache_bytes(cfg: LlamaConfig, batch: int, kv_dtype: str = "bf16", tp: int = 1) -> int:
    """Device bytes both cache sides occupy (on one of ``tp`` ranks)."""
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads // tp, cfg.head_dim)
    return 2 * kvc.kv_bytes(shape, cfg.dtype, kv_dtype)


def _as_length(length, batch: int, device: torch.device):
    """A cache length as the port keeps it: a Python int for one shared
    position the host knows, a ``(B,)`` int64 tensor on ``device`` for
    per-row ones, a 0-d int64 tensor for a shared device-side frontier
    (never read to the host here)."""
    if isinstance(length, torch.Tensor):
        length = length.to(device=device, dtype=torch.long)
        return length if length.ndim == 0 else length.expand(batch)
    if isinstance(length, (list, tuple)):
        return torch.tensor(length, dtype=torch.long, device=device)
    return int(length)


def _row_lengths(length, batch: int, device: torch.device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length.expand(batch)
    return torch.full((batch,), length, dtype=torch.long, device=device)


def prefill(
    params: Params,
    tokens: torch.Tensor,
    cache: dict,
    cfg: LlamaConfig,
    true_length=None,
    mlp_fn=None,
) -> tuple[torch.Tensor, dict]:
    """Process the (possibly pad-bucketed) prompt and fill the cache in
    place (``mlp_fn`` as in :func:`_seq_layers`).

    ``true_length`` is the real prompt length when ``tokens`` is padded:
    logits are gathered at position ``true_length - 1`` and the cache
    length is set to ``true_length``, so decode never conditions on pad
    positions.  A scalar applies one length to every row; a ``(B,)``
    tensor or list gives each row its own.  Returns (f32 logits
    (B, vocab), cache).
    """
    B, S = tokens.shape
    dev = tokens.device
    length = _as_length(S if true_length is None else true_length, B, dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    h = _embed_lookup(params, tokens, cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()

    def write(i, k, v):
        kvc.kv_write_seq(_at(cache["k"], i), k, 0)
        kvc.kv_write_seq(_at(cache["v"], i), v, 0)

    h = _seq_layers(params, cfg, h, cos, sin, mask, write, mlp_fn)
    cache = {"k": cache["k"], "v": cache["v"], "length": length}
    last = _row_lengths(length, B, dev) - 1
    h_last = h[torch.arange(B, device=dev), last]
    return _logits(params, h_last, _seq_matmul), cache


_TRACE = None  # the recorder trace_ops installs: fn(op, layer, tensor)


@contextmanager
def trace_ops(record):
    """Call ``record(op, layer, tensor)`` with the output of every op of
    the cached passes (decode, verify, draft) while the block runs: per
    layer ``attn_norm``, ``q``, ``k``, ``v``, ``rope_q``, ``rope_k``,
    ``attention``, ``wo``, ``wo_residual`` (the hidden state plus
    ``wo``), ``mlp_norm``, ``w1``, ``w3``, ``silu_mul``, ``w2``,
    ``w2_residual``, then ``final_norm`` and ``logits`` (layer ``None``).
    A fused add + norm records both of its outputs: the residual, then
    the norm (the next layer's ``attn_norm`` after ``w2_residual``).  A
    probe's tool for finding which op's bits depend on the batch."""
    global _TRACE
    before, _TRACE = _TRACE, record
    try:
        yield
    finally:
        _TRACE = before


def _traced(op: str, layer: int | None, t: torch.Tensor) -> torch.Tensor:
    if _TRACE is not None and (layer is not None or op in ("final_norm", "logits")):
        _TRACE(op, layer, t)
    return t


def _cached_layers(
    params: Params,
    cfg: LlamaConfig,
    h: torch.Tensor,
    cache: dict,
    positions: torch.Tensor,
    write,
    matmul=_matmul,
    mlp_fn=None,
) -> torch.Tensor:
    """The layer loop shared by decode and verify: each layer writes its
    new K/V with ``write(layer_cache_side, new)``, then query ``(b, j)``
    at position ``positions[b, j]`` attends over the cache positions
    ``<= positions[b, j]`` of its row: on the card through K2's lanes,
    on the CPU through the plain :func:`attention` under the causal mask.
    ``launch_counts.cached_layers`` counts the layers the card ran, so
    that a run can show K2 launched once per layer per pass.  ``matmul``
    takes every weight product (:func:`_seq_matmul` in a prompt chunk's
    pass); ``mlp_fn`` as in :func:`_seq_layers`."""
    B, K, _ = h.shape
    (H, KV), HD = local_heads(cfg, params["layers"]), cfg.head_dim
    mesh = tp_mesh_of(params)
    cos, sin = rope_frequencies(cfg, positions)
    lanes = h.device.type == "cuda"
    if lanes:
        launch_counts.cached_layers += cfg.n_layers
    else:
        key_pos = torch.arange(cfg.max_seq_len, device=h.device)
        mask = key_pos[None, None, :] <= positions[:, :, None]  # (B, K, T)
    x = _traced("attn_norm", 0, rms_norm(h, params["layers"]["attn_norm"][0], cfg.norm_eps))
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        k_cache = _at(cache["k"], i)
        v_cache = _at(cache["v"], i)
        q = _traced("q", i, matmul(x, layer["wq"])).reshape(B, K, H, HD)
        k = _traced("k", i, matmul(x, layer["wk"])).reshape(B, K, KV, HD)
        v = _traced("v", i, matmul(x, layer["wv"])).reshape(B, K, KV, HD)
        q = _traced("rope_q", i, apply_rope(q, cos, sin))
        k = _traced("rope_k", i, apply_rope(k, cos, sin))
        write(k_cache, k)
        write(v_cache, v)
        if lanes:
            attn = dense_lane_attention(q, k_cache, v_cache, positions)
        else:
            attn = attention(
                q, kvc.kv_load(k_cache, cfg.dtype), kvc.kv_load(v_cache, cfg.dtype),
                mask, H // KV,
            )
        attn = _traced("attention", i, attn)
        wo = _traced("wo", i, _reduce(matmul(attn.reshape(B, K, H * HD), layer["wo"]), mesh))
        h, x = add_rms_norm(h, wo, layer["mlp_norm"], cfg.norm_eps)
        h = _traced("wo_residual", i, h)
        x = _traced("mlp_norm", i, x)
        mlp = (_dense_mlp(cfg, layer, x, i, matmul=matmul, mesh=mesh) if mlp_fn is None
               else mlp_fn(layer, x))
        h, x = add_rms_norm(h, mlp, _next_norm(params, i), cfg.norm_eps)
        h = _traced("w2_residual", i, h)
        x = _traced("attn_norm", i + 1, x) if i + 1 < cfg.n_layers else x
    return _traced("final_norm", None, x)



def decode_step(
    params: Params, token: torch.Tensor, cache: dict, cfg: LlamaConfig, mlp_fn=None
) -> tuple[torch.Tensor, dict]:
    """One-token decode.  token: (B,) -> f32 logits (B, vocab).

    ``cache["length"]`` is an int (every row at one position: this is
    :func:`verify_chunk` at K=1) or a tensor, ``(B,)`` per-row positions
    or one 0-d device-side position for every row (one slot per row is
    scattered in place, and each row sees the cache positions
    ``<= length``).  ``mlp_fn`` as in :func:`_seq_layers`.
    """
    B = token.shape[0]
    dev = token.device
    pos = _as_length(cache["length"], B, dev)
    if isinstance(pos, int):
        logits, cache = verify_chunk(params, token[:, None], {**cache, "length": pos}, cfg,
                                     mlp_fn=mlp_fn)
        return logits[:, 0], {**cache, "length": pos + 1}
    row_pos = pos.expand(B)  # a 0-d shared frontier, broadcast
    h = _embed_lookup(params, token[:, None], cfg.dtype)
    rows = torch.arange(B, device=dev)

    def write(side, new):
        kvc.kv_write_rows(side, new[:, 0], rows, row_pos)

    h = _cached_layers(params, cfg, h, cache, row_pos[:, None], write, mlp_fn=mlp_fn)
    cache = {"k": cache["k"], "v": cache["v"], "length": pos + 1}
    return _traced("logits", None, _logits(params, h[:, 0, :], _matmul)), cache


@dataclass(frozen=True)
class SamplingConfig:
    """Decode-time sampling.  ``temperature == 0`` is greedy argmax (the
    default everywhere); ``top_k``/``top_p`` restrict the candidate set
    before the draw, k first, then nucleus."""

    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k restriction
    top_p: float = 1.0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingConfig()


def sample_from_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    sampling: SamplingConfig,
) -> torch.Tensor:
    """Draw token ids (B,) from logits (B, V) under ``sampling``.

    Greedy never touches the generator.  Otherwise the kept set is the
    JAX module's (top-k by the k-th largest logit, then the smallest
    prefix of the sorted distribution whose exclusive cumulative mass is
    under ``top_p``, at least one token), and the draw is a Gumbel-max
    over the kept logits with noise from ``generator``: no host read,
    and a token outside the kept set can never be drawn.  The draws are
    not ``jax.random``'s.
    """
    if sampling.greedy:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("non-greedy sampling needs a torch.Generator")
    logits = logits / max(sampling.temperature, 1e-6)
    if sampling.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -sampling.top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if sampling.top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < sampling.top_p
        keep[..., 0] = True
        min_kept = sorted_desc.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < min_kept, float("-inf"))
    u = torch.rand(
        logits.shape, generator=generator, dtype=torch.float32, device=logits.device
    )
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def verify_chunk(
    params: Params, tokens: torch.Tensor, cache: dict, cfg: LlamaConfig,
    prompt_chunk: bool = False,
    mlp_fn=None,
) -> tuple[torch.Tensor, dict]:
    """Score K tokens in one pass: f32 logits at every position.

    tokens: (B, K), the next K tokens from the cache's current
    ``length``.  Their KV is written in place at ``length .. length+K-1``
    and ``length`` is left unchanged: the caller decides how many
    positions were accepted.  ``length`` is an int (one frontier, a
    contiguous write that raises past the cache end), a ``(B,)`` tensor
    (each row verifies K positions from its own frontier; a position
    past the cache end is dropped) or a 0-d tensor (one device-side
    frontier, broadcast over the rows).

    ``prompt_chunk`` marks a prompt's chunk appended to its cache (a
    suffix prefill), which no dispatch batches: its weight products run
    as a prefill's do (:func:`_seq_matmul`), each row at a lone chunk's
    shape, instead of as :data:`GEMM_ROWS`-row pieces.  ``mlp_fn`` as in
    :func:`_seq_layers`.
    """
    B, K = tokens.shape
    dev = tokens.device
    start = _as_length(cache["length"], B, dev)
    offs = torch.arange(K, device=dev)
    if isinstance(start, int):
        positions = (start + offs).expand(B, K)

        def write(side, new):
            kvc.kv_write_seq(side, new, start)
    else:
        row_start = start.expand(B)
        positions = row_start[:, None] + offs[None, :]  # (B, K)
        rows = torch.arange(B, device=dev)
        index = kvc.rows_seq_index(row_start, K, cfg.max_seq_len)

        def write(side, new):
            kvc.kv_write_rows_seq(side, new, rows, row_start, index)

    h = _embed_lookup(params, tokens, cfg.dtype)
    matmul = _seq_matmul if prompt_chunk else _matmul
    h = _cached_layers(params, cfg, h, cache, positions, write, matmul, mlp_fn)
    cache = {"k": cache["k"], "v": cache["v"], "length": start}
    return _traced("logits", None, _logits(params, h, matmul)), cache


def decode_chunk(
    params: Params,
    token: torch.Tensor,
    cache: dict,
    cfg: LlamaConfig,
    num_tokens: int,
    sampling: SamplingConfig = GREEDY,
    rng: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Decode ``num_tokens`` tokens with no host read in between.

    token: (B,) -> (tokens (B, num_tokens), last token (B,), cache).
    Every step's work is queued on the device; the caller reads the
    chunk once.  ``rng`` advances with every sampled step.
    """
    if not sampling.greedy and rng is None:
        raise ValueError("non-greedy sampling needs an rng generator")
    toks = []
    for _ in range(num_tokens):
        logits, cache = decode_step(params, token, cache, cfg)
        token = sample_from_logits(logits, rng, sampling)
        toks.append(token)
    return torch.stack(toks, dim=1), token, cache
