"""Long-context serving: sequence-parallel prefill and distributed decode
(PyTorch port of ``tpuslo/models/longserve.py``).

A context too long for one device's KV, or whose O(S^2) prefill is too
slow on one device, is split over the ``sp`` axis of a mesh
(:func:`tpuslo_torch.parallel.mesh.sp_mesh`):

* **Prefill** (context ingestion): rank ``i`` takes the prompt's
  positions ``[i * S / p, (i + 1) * S / p)``; every layer runs
  :func:`tpuslo_torch.ops.ring_attention.ring_attention` (KV blocks
  travel the ring at kv-head width), so no rank holds more than S / p of
  the context or an (S x S) score tile.  The context KV stays on its
  rank.
* **Decode**: the new token's query attends to (a) the local context
  piece, as a partial online-softmax accumulator ``(m, l, o)`` merged
  over the ranks with one max and two sums (:func:`all_reduce`, JAX's
  ``pmax`` / ``psum``), and (b) a small tail buffer holding the
  generated tokens, the same on every rank (bounded by ``tail_max``).
  New KV goes to the tail on every rank; the long context is never
  gathered.

Every rank of the axis makes the same calls in the same order; each
returns the same logits.  Where JAX compiles ``shard_map`` bodies, the
port runs them eagerly on each rank (a decode over gloo with CUDA
tensors goes through host memory, which a CUDA graph cannot capture:
``Mesh.graph_capturable``).  The products of the prefill run as a
prefill's do (``llama._seq_matmul``, one product per batch row on the
card), those of the decode as a decode's (``llama._matmul``, 128-row
pieces on the card).  With ``mesh=None`` the functions run on one device
and make no collective.
"""

from __future__ import annotations

from typing import Any

import torch

from tpuslo_torch.models import kv_cache as kvc
from tpuslo_torch.models.llama import (
    _at,
    _dense_mlp,
    _embed_lookup,
    _layer,
    _matmul,
    _next_norm,
    _seq_matmul,
    add_rms_norm,
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from tpuslo_torch.ops.ring_attention import ring_attention
from tpuslo_torch.parallel import mesh as mesh_mod

Params = dict[str, Any]
NEG_INF = -1e30


def _axis(mesh, axis_name: str) -> tuple[int, int]:
    """(axis size, this rank's index on it); (1, 0) without a mesh."""
    if mesh is None:
        return 1, 0
    return mesh.shape[axis_name], mesh.rank(axis_name)


def _psum(x: torch.Tensor, mesh, axis_name: str, op: str = "sum") -> torch.Tensor:
    """JAX's ``psum`` (``op="max"``: ``pmax``) over the axis; ``x`` itself
    on one device."""
    if mesh is None or not mesh.distributed:
        return x
    return mesh_mod.all_reduce(x, mesh, axis_name, op=op)


def _tail_buffers(cfg, batch: int, tail_max: int, device: torch.device) -> dict:
    L, KV, HD = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, batch, tail_max, KV, HD)
    return {
        "k_tail": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v_tail": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "tail_len": 0,
    }


def sp_cache_specs(int8: bool = False) -> dict:
    """The layout of an sp cache: each leaf's dimension split over the
    ``sp`` axis (the context KV's sequence dimension), or None for a leaf
    every rank holds whole (the tail).  An int8 context leaf is a
    ``{"q", "s"}`` dict split on the same dimension."""
    ctx = {"q": 2, "s": 2} if int8 else 2
    return {"k_ctx": ctx, "v_ctx": ctx, "k_tail": None, "v_tail": None, "tail_len": None}


def sp_prefill_raw(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    mesh,
    axis_name: str = "sp",
    true_length=None,
    kv_dtype: str = "bf16",
    mlp_fn=None,
):
    """Ring-attention prefill, returning this rank's piece of the KV.

    ``tokens`` is the whole (B, S) prompt on every rank, S % sp == 0.
    Returns ``(f32 logits (B, vocab) at true_length - 1, the same on
    every rank; ks, vs (L, B, S / sp, KV, HD), this rank's positions)``.
    The long-context path (:func:`sp_prefill`) keeps the KV split and
    decodes distributed; the serving handoff
    (:func:`tpuslo_torch.models.sp_serve.sp_prefill_into_cache`) gathers
    it into a dense cache for the ordinary decode engine.
    ``true_length`` (an int, or a (B,) tensor) covers pad-bucketed
    prompts: the selected position may live on any rank.
    ``kv_dtype="int8"`` quantizes the context KV on each rank (the
    context is frozen after prefill): ``{"q", "s"}`` leaves at about half
    the bytes.
    """
    kv_dtype = kvc.validate_kv_dtype(kv_dtype)
    sp, idx = _axis(mesh, axis_name)
    B, S = tokens.shape
    if S % sp:
        raise ValueError(f"context length {S} not divisible by sp={sp}")
    dev = tokens.device
    tl = torch.as_tensor(S if true_length is None else true_length, dtype=torch.long)
    # An out-of-range length would make every rank's row mask false and
    # the sum return the output projection of zero: plausible-looking
    # garbage logits.  Refuse it loudly instead.
    if not bool(((tl >= 1) & (tl <= S)).all()):
        raise ValueError(
            f"true_length {true_length} outside [1, {S}]; logits "
            "would silently come from a zero hidden state"
        )
    tl = tl.to(dev).expand(B)

    S_loc = S // sp
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    local = tokens[:, idx * S_loc:(idx + 1) * S_loc]
    positions = (idx * S_loc + torch.arange(S_loc, device=dev)).expand(B, S_loc)
    h = _embed_lookup(params, local, cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)

    ks, vs = [], []
    x = rms_norm(h, params["layers"]["attn_norm"][0], cfg.norm_eps)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        q = _seq_matmul(x, layer["wq"]).reshape(B, S_loc, H, HD)
        k = _seq_matmul(x, layer["wk"]).reshape(B, S_loc, KV, HD)
        v = _seq_matmul(x, layer["wv"]).reshape(B, S_loc, KV, HD)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # GQA-aware ring: KV travels at kv-head width and expands
        # locally per block.
        attn = ring_attention(q, k, v, mesh, axis_name, n_rep=H // KV)
        out = _seq_matmul(attn.reshape(B, S_loc, H * HD), layer["wo"])
        h, x = add_rms_norm(h, out, layer["mlp_norm"], cfg.norm_eps)
        mlp = (_dense_mlp(cfg, layer, x, matmul=_seq_matmul) if mlp_fn is None
               else mlp_fn(layer, x))
        h, x = add_rms_norm(h, mlp, _next_norm(params, i), cfg.norm_eps)
        ks.append(k)
        vs.append(v)

    # Position ``true_length - 1`` lives on exactly one rank: every rank
    # takes its clipped candidate row, zeroes it unless it is local, and
    # one sum over the ranks gives every rank the real row (exact: one
    # row plus zeros).
    local_pos = tl - 1 - idx * S_loc  # (B,)
    in_range = (local_pos >= 0) & (local_pos < S_loc)
    clipped = local_pos.clamp(0, S_loc - 1)
    h_last = x[torch.arange(B, device=dev), clipped]
    h_last = _psum(torch.where(in_range[:, None], h_last, torch.zeros_like(h_last)),
                   mesh, axis_name)
    logits = _seq_matmul(h_last, params["output"]).float()
    ks, vs = torch.stack(ks), torch.stack(vs)
    if kv_dtype == "int8":
        ks, vs = kvc.quantize_kv(ks), kvc.quantize_kv(vs)
    return logits, ks, vs


def sp_prefill(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    mesh,
    tail_max: int = 512,
    axis_name: str = "sp",
    kv_dtype: str = "bf16",
    mlp_fn=None,
):
    """Ingest a long context.  tokens: (B, S) with S % sp == 0.

    Returns (last-token logits, sp cache): this rank's piece of the
    context KV (int8 when ``kv_dtype="int8"``), an empty tail
    (:func:`sp_cache_specs`).
    """
    logits, ks, vs = sp_prefill_raw(
        params, tokens, cfg, mesh, axis_name, kv_dtype=kv_dtype, mlp_fn=mlp_fn,
    )
    tail = _tail_buffers(cfg, tokens.shape[0], tail_max, tokens.device)
    return logits, {"k_ctx": ks, "v_ctx": vs, **tail}


def _partial_attention(q, k, v, valid):
    """Online-softmax partials for q (B, 1, H, HD) over k/v (B, T, KV, HD).

    valid: (T,) bool, which KV rows take part.  Returns m, l, o with
    shapes (B, H), (B, H), (B, H, HD) in f32.
    """
    B, _, H, HD = q.shape
    n_rep = H // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scale = HD**-0.5
    scores = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())[:, :, 0, :] * scale
    scores = scores.masked_fill(~valid, NEG_INF)  # (B, H, T)
    m = scores.amax(dim=-1)  # (B, H)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    o = torch.einsum("bht,bthd->bhd", e, v.float())
    return m, l, o


def _merge_partials(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, o1 * c1[..., None] + o2 * c2[..., None]


def sp_decode_step(
    params: Params,
    token: torch.Tensor,
    cache: dict,
    cfg,
    mesh,
    axis_name: str = "sp",
    mlp_fn=None,
):
    """One distributed decode step: token (B,), the same on every rank ->
    (f32 logits (B, vocab), cache).

    The tail's next slot is written in place and the returned cache has
    ``tail_len + 1``; a full tail raises.
    """
    tail_len = cache["tail_len"]
    tail_max = cache["k_tail"].shape[2]
    if tail_len >= tail_max:
        raise ValueError(
            f"tail buffer full ({tail_len}/{tail_max}): re-prefill or "
            "raise tail_max; writes past the end would silently "
            "corrupt the last slot"
        )
    sp, _ = _axis(mesh, axis_name)
    B = token.shape[0]
    dev = token.device
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_ctx_leaf = cache["k_ctx"]["q"] if isinstance(cache["k_ctx"], dict) else cache["k_ctx"]
    S_loc = k_ctx_leaf.shape[2]
    # The global position of the new token (every rank holds S_loc of the
    # context: JAX's psum of S_loc, which is no collective).
    pos = sp * S_loc + tail_len
    positions = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    h = _embed_lookup(params, token[:, None], cfg.dtype)
    cos, sin = rope_frequencies(cfg, positions)

    ctx_valid = torch.ones((S_loc,), dtype=torch.bool, device=dev)  # context fully visible
    # The tail includes the current token: causal self-attention always
    # sees itself.  Write first, then attend.
    now_valid = torch.arange(tail_max, device=dev) < tail_len + 1

    x = rms_norm(h, params["layers"]["attn_norm"][0], cfg.norm_eps)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        q = _matmul(x, layer["wq"]).reshape(B, 1, H, HD)
        k = _matmul(x, layer["wk"]).reshape(B, 1, KV, HD)
        v = _matmul(x, layer["wv"]).reshape(B, 1, KV, HD)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        # The partial over the local context piece, merged over the ranks
        # (a max, then the sums rescaled to it), then merged with the
        # tail's partial, which every rank computes alike.  An int8
        # context dequantizes here.
        m_c, l_c, o_c = _partial_attention(
            q, kvc.kv_load(_at(cache["k_ctx"], i), cfg.dtype),
            kvc.kv_load(_at(cache["v_ctx"], i), cfg.dtype), ctx_valid,
        )
        m_g = _psum(m_c, mesh, axis_name, op="max")
        corr = torch.exp(m_c - m_g)
        l_g = _psum(l_c * corr, mesh, axis_name)
        o_g = _psum(o_c * corr[..., None], mesh, axis_name)

        k_tail, v_tail = cache["k_tail"][i], cache["v_tail"][i]
        k_tail[:, tail_len] = k[:, 0]
        v_tail[:, tail_len] = v[:, 0]
        m_t, l_t, o_t = _partial_attention(q, k_tail, v_tail, now_valid)

        m, l, o = _merge_partials(m_g, l_g, o_g, m_t, l_t, o_t)
        out = (o / l.clamp_min(1e-30)[..., None]).to(cfg.dtype)
        wo = _matmul(out.reshape(B, 1, H * HD), layer["wo"])
        h, x = add_rms_norm(h, wo, layer["mlp_norm"], cfg.norm_eps)
        mlp = _dense_mlp(cfg, layer, x) if mlp_fn is None else mlp_fn(layer, x)
        h, x = add_rms_norm(h, mlp, _next_norm(params, i), cfg.norm_eps)
    logits = _matmul(x[:, 0, :], params["output"]).float()
    return logits, {**cache, "tail_len": tail_len + 1}


def sp_generate(
    params: Params,
    tokens: torch.Tensor,
    cfg,
    mesh,
    max_new_tokens: int,
    tail_max: int | None = None,
    axis_name: str = "sp",
    kv_dtype: str = "bf16",
    mlp_fn=None,
) -> torch.Tensor:
    """Greedy long-context generation -> (B, max_new_tokens) token ids
    (int64), the same on every rank; no host read in between."""
    tail_max = tail_max or max(64, max_new_tokens + 1)
    if max_new_tokens >= tail_max:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} needs tail_max > itself"
        )
    logits, cache = sp_prefill(
        params, tokens, cfg, mesh, tail_max=tail_max, axis_name=axis_name,
        kv_dtype=kv_dtype, mlp_fn=mlp_fn,
    )
    token = logits.argmax(dim=-1)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = sp_decode_step(params, token, cache, cfg, mesh, axis_name, mlp_fn)
        token = logits.argmax(dim=-1)
        out.append(token)
    return torch.stack(out, dim=1)
