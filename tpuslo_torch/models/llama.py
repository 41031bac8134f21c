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
  only.  Decode and verify attend over the whole preallocated cache
  with the plain :func:`attention`, as the JAX module leaves them to
  XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from tpuslo_torch.device import resolve_device
from tpuslo_torch.models import kv_cache as kvc
from tpuslo_torch.ops.flash_attention import flash_attention, flash_eligible

Params = dict[str, Any]


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
    dev = resolve_device(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(rng))
    (e_shape, e_fan), layer_dense, (o_shape, o_fan) = _param_layout(cfg)
    embed = _dense_init(gen, e_shape, e_fan, cfg.dtype, dev)
    layers = {
        name: _dense_init(gen, *layer_dense[name], cfg.dtype, dev)
        for name in _DENSE_LEAVES
    }
    L, D = cfg.n_layers, cfg.dim
    layers["attn_norm"] = torch.ones((L, D), dtype=cfg.dtype, device=dev)
    layers["mlp_norm"] = torch.ones((L, D), dtype=cfg.dtype, device=dev)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
        "output": _dense_init(gen, o_shape, o_fan, cfg.dtype, dev),
    }


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
    (in that order, as the JAX module does)."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


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


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` accumulated in f32 and rounded once to x's dtype.

    ``w`` is a dense tensor or an int8 dict {"q", "s"}.  Dense: PyTorch's
    GEMM accumulates in f32 and rounds its output once.  int8: the
    product is taken in f32 (int8 codes and bf16 activations are exact
    in f32), scaled per output channel, and rounded once, which is the
    JAX module's dequantize-in-the-accumulator arithmetic.
    """
    if isinstance(w, dict):
        out = torch.matmul(x.float(), w["q"].float())
        return (out * w["s"]).to(x.dtype)
    return torch.matmul(x, w)


def _embed_lookup(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather for dense or quantized embedding tables."""
    e = params["embed"]
    if isinstance(e, dict):
        return (e["q"][tokens].float() * e["s"]).to(dtype)
    return e[tokens].to(dtype)


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
    B, S, _ = h.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    q = _matmul(x, layer["wq"]).reshape(B, S, H, HD)
    k = _matmul(x, layer["wk"]).reshape(B, S, KV, HD)
    v = _matmul(x, layer["wv"]).reshape(B, S, KV, HD)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if causal and flash_eligible(tuple(q.shape), KV):
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = attention(q, k, v, mask, H // KV)
    return h + _matmul(attn.reshape(B, S, H * HD), layer["wo"]), (k, v)


def _dense_mlp(cfg, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP on normalized hidden states."""
    gate = F.silu(_matmul(x, layer["w1"]).float())
    up = _matmul(x, layer["w3"]).float()
    return _matmul((gate * up).to(cfg.dtype), layer["w2"])


def _layer_body(
    cfg: LlamaConfig,
    h: torch.Tensor,
    layer: Params,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    causal: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One transformer layer; returns (hidden, (rotated_k, v))."""
    h, kv = attention_block(cfg, h, layer, cos, sin, mask, causal=causal)
    x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
    return h + _dense_mlp(cfg, layer, x), kv


def _at(leaf, i: int):
    """Layer ``i`` of a layer-stacked leaf (a tensor or an int8 dict), as
    views: writes into a cache side's views reach the cache."""
    return kvc.kv_map(lambda a: a[i], leaf)


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameter leaves."""
    return {name: _at(leaf, i) for name, leaf in params["layers"].items()}


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Full-sequence forward -> f32 logits (B, S, vocab)."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    h = _embed_lookup(params, tokens, cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for i in range(cfg.n_layers):
        h, _kv = _layer_body(cfg, h, _layer(params, i), cos, sin, mask, causal=True)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _matmul(h, params["output"]).float()


# --- KV-cache decode path ----------------------------------------------


def init_kv_cache(
    cfg: LlamaConfig,
    batch: int,
    kv_dtype: str = "bf16",
    device: str | torch.device = "cuda",
) -> dict:
    """Preallocated cache ``{"k", "v", "length"}``; ``kv_dtype="int8"``
    stores K/V quantized (see :mod:`tpuslo_torch.models.kv_cache`).

    ``length`` is a Python int while every row sits at the same position
    (the host always knows it, so no device read is needed to slice),
    and a ``(B,)`` int64 tensor once rows have their own lengths.
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "v": kvc.init_kv(shape, cfg.dtype, kv_dtype, dev),
        "length": 0,
    }


def kv_cache_bytes(cfg: LlamaConfig, batch: int, kv_dtype: str = "bf16") -> int:
    """Device bytes both cache sides occupy."""
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return 2 * kvc.kv_bytes(shape, cfg.dtype, kv_dtype)


def _as_length(length, batch: int, device: torch.device):
    """A cache length as the port keeps it: a Python int for one shared
    position, a ``(B,)`` int64 tensor on ``device`` for per-row ones."""
    if isinstance(length, torch.Tensor):
        if length.ndim == 0:
            return int(length)
        return length.to(device=device, dtype=torch.long).expand(batch)
    if isinstance(length, (list, tuple)):
        return torch.tensor(length, dtype=torch.long, device=device)
    return int(length)


def _row_lengths(length, batch: int, device: torch.device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        return length
    return torch.full((batch,), length, dtype=torch.long, device=device)


def prefill(
    params: Params,
    tokens: torch.Tensor,
    cache: dict,
    cfg: LlamaConfig,
    true_length=None,
) -> tuple[torch.Tensor, dict]:
    """Process the (possibly pad-bucketed) prompt and fill the cache in
    place.

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
    for i in range(cfg.n_layers):
        h, (k, v) = _layer_body(cfg, h, _layer(params, i), cos, sin, mask, causal=True)
        kvc.kv_write_seq(_at(cache["k"], i), k, 0)
        kvc.kv_write_seq(_at(cache["v"], i), v, 0)
    cache = {"k": cache["k"], "v": cache["v"], "length": length}
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    last = _row_lengths(length, B, dev) - 1
    h_last = h[torch.arange(B, device=dev), last]
    return _matmul(h_last, params["output"]).float(), cache


def _cached_layers(
    params: Params,
    cfg: LlamaConfig,
    h: torch.Tensor,
    cache: dict,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    write,
) -> torch.Tensor:
    """The layer loop shared by decode and verify: each layer writes its
    new K/V with ``write(layer_cache_side, new)`` and attends over the
    whole preallocated cache under ``mask``."""
    B, K, _ = h.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        k_cache = _at(cache["k"], i)
        v_cache = _at(cache["v"], i)
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = _matmul(x, layer["wq"]).reshape(B, K, H, HD)
        k = _matmul(x, layer["wk"]).reshape(B, K, KV, HD)
        v = _matmul(x, layer["wv"]).reshape(B, K, KV, HD)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        write(k_cache, k)
        write(v_cache, v)
        attn = attention(
            q, kvc.kv_load(k_cache, cfg.dtype), kvc.kv_load(v_cache, cfg.dtype),
            mask, H // KV,
        )
        h = h + _matmul(attn.reshape(B, K, H * HD), layer["wo"])
        x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
        h = h + _dense_mlp(cfg, layer, x)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def decode_step(
    params: Params, token: torch.Tensor, cache: dict, cfg: LlamaConfig
) -> tuple[torch.Tensor, dict]:
    """One-token decode.  token: (B,) -> f32 logits (B, vocab).

    ``cache["length"]`` is an int (every row at one position: this is
    :func:`verify_chunk` at K=1) or a ``(B,)`` tensor (per-row
    positions: one slot per row is scattered in place, and each row
    sees the cache positions ``<= length``).
    """
    B = token.shape[0]
    dev = token.device
    pos = _as_length(cache["length"], B, dev)
    if isinstance(pos, int):
        logits, cache = verify_chunk(params, token[:, None], {**cache, "length": pos}, cfg)
        return logits[:, 0], {**cache, "length": pos + 1}
    h = _embed_lookup(params, token[:, None], cfg.dtype)
    cos, sin = rope_frequencies(cfg, pos[:, None])
    visible = torch.arange(cfg.max_seq_len, device=dev)[None, :] <= pos[:, None]
    rows = torch.arange(B, device=dev)

    def write(side, new):
        kvc.kv_write_rows(side, new[:, 0], rows, pos)

    h = _cached_layers(params, cfg, h, cache, cos, sin, visible[:, None, :], write)
    cache = {"k": cache["k"], "v": cache["v"], "length": pos + 1}
    return _matmul(h[:, 0, :], params["output"]).float(), cache


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
    params: Params, tokens: torch.Tensor, cache: dict, cfg: LlamaConfig
) -> tuple[torch.Tensor, dict]:
    """Score K tokens in one pass: f32 logits at every position.

    tokens: (B, K), the next K tokens from the cache's current
    ``length``.  Their KV is written in place at ``length .. length+K-1``
    and ``length`` is left unchanged: the caller decides how many
    positions were accepted.  ``length`` is an int (one frontier, a
    contiguous write that raises past the cache end) or a ``(B,)``
    tensor (each row verifies K positions from its own frontier).
    """
    B, K = tokens.shape
    dev = tokens.device
    start = _as_length(cache["length"], B, dev)
    key_pos = torch.arange(cfg.max_seq_len, device=dev)
    offs = torch.arange(K, device=dev)
    if isinstance(start, int):
        positions = (start + offs).expand(B, K)
        mask = key_pos[None, :] <= (start + offs)[:, None]  # (K, T)

        def write(side, new):
            kvc.kv_write_seq(side, new, start)
    else:
        positions = start[:, None] + offs[None, :]  # (B, K)
        mask = key_pos[None, None, :] <= positions[:, :, None]  # (B, K, T)
        rows = torch.arange(B, device=dev)

        def write(side, new):
            kvc.kv_write_rows_seq(side, new, rows, start)

    h = _embed_lookup(params, tokens, cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)
    h = _cached_layers(params, cfg, h, cache, cos, sin, mask, write)
    cache = {"k": cache["k"], "v": cache["v"], "length": start}
    return _matmul(h, params["output"]).float(), cache


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
