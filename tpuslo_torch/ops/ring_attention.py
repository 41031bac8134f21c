"""Ring attention: causal attention over a sequence-parallel mesh axis
(PyTorch port of ``tpuslo/ops/ring_attention.py``).

The sequence is split over the ``sp`` axis of a mesh
(:func:`tpuslo_torch.parallel.mesh.sp_mesh`): rank ``i`` holds positions
``[i * S_loc, (i + 1) * S_loc)``.  No rank materialises the whole
(S x S) score matrix or the whole KV.  KV blocks travel around the ring
(:func:`tpuslo_torch.parallel.mesh.shift`, JAX's ``ppermute`` by one
step) while each rank folds every block it receives into an
online-softmax accumulator (running max ``m``, normaliser ``l``,
weighted sum ``o``), so memory per rank is O(S / p).

The arithmetic is the JAX module's, in plain PyTorch: both products and
the softmax in f32 (``torch.einsum`` over f32 operands, as
``einsum(..., preferred_element_type=f32)``), the mask of each block
decided by where it came from.  It runs outside any kernel of the port,
as JAX's runs outside any Pallas kernel.  Where the port differs:

* JAX rotates k and v ``p`` times and never reads the last rotation; the
  port skips it, so a layer makes ``2 (p - 1)`` shifts;
* JAX folds the blocks no query of this rank may see (all scores
  masked) and so adds exactly zero (``p = exp(-1e30 - m) = 0`` and the
  correction is 1 once the rank's own block has set ``m``); the port
  skips their fold, which leaves the accumulators as they were;
* with no mesh (or an axis of one rank) the call is one fold over the
  local block and makes no collective.
"""

from __future__ import annotations

import torch

from tpuslo_torch.parallel import mesh as mesh_mod

NEG_INF = -1e30


def _block_attention(q, k, v, mask, m, l, o):
    """Fold one KV block into the online-softmax accumulator.

    q: (B, Sq, H, D) f32; k/v: (B, Sk, H, D); mask: (Sq, Sk) bool.
    m: (B, H, Sq) running max; l: (B, H, Sq) normaliser;
    o: (B, Sq, H, D) running weighted sum.  The (B, H, Sq, Sk) scores
    are masked and exponentiated in place.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.float()).mul_(scale)
    scores.masked_fill_(~mask, NEG_INF)

    block_max = scores.amax(dim=-1)
    new_m = torch.maximum(m, block_max)
    # Rescale the previous accumulator to the new max.
    correction = torch.exp(m - new_m)
    p = scores.sub_(new_m[..., None]).exp_()
    new_l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    new_o = o * correction.transpose(1, 2)[..., None] + pv
    return new_m, new_l, new_o


def ring_attention(q, k, v, mesh=None, axis: str = "sp", n_rep: int = 1):
    """Causal ring attention over this rank's piece of the sequence.

    q: (B, S_local, H, D); k/v: (B, S_local, H / n_rep, D), already
    RoPE-rotated at their *global* positions.  Returns (B, S_local, H, D)
    in q's dtype.  Every rank of ``mesh``'s ``axis`` calls it at once (the
    shifts pair up across the ranks).

    ``n_rep > 1`` is GQA: KV blocks travel at kv-head width (1 / n_rep of
    the bytes) and are repeated to the full head count locally, right
    before each block's scores.
    """
    p_size = 1 if mesh is None else mesh.shape[axis]
    my_idx = 0 if mesh is None else mesh.rank(axis)
    B, S, H, D = q.shape
    dev = q.device

    qf = q.float()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros_like(qf)

    local_causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    full_mask = torch.ones((S, S), dtype=torch.bool, device=dev)

    k_blk, v_blk = k, v
    for step in range(p_size):
        src_idx = (my_idx - step) % p_size
        # Causal block order: earlier blocks wholly visible, the own block
        # lower-triangular, later blocks invisible (their fold adds zero).
        if src_idx <= my_idx:
            mask = full_mask if src_idx < my_idx else local_causal
            k_full = k_blk.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k_blk
            v_full = v_blk.repeat_interleave(n_rep, dim=2) if n_rep > 1 else v_blk
            m, l, o = _block_attention(qf, k_full, v_full, mask, m, l, o)
        if step + 1 < p_size:
            # Rotate KV one step around the ring.
            k_blk = mesh_mod.shift(k_blk, mesh, axis, 1)
            v_blk = mesh_mod.shift(v_blk, mesh, axis, 1)

    # Guard fully masked rows (a causal row always sees itself, but keep
    # the division safe).
    l = l.clamp_min(1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh=None, axis: str = "sp"):
    """:func:`ring_attention` over tensors whose S axis is split over
    ``axis``: q/k/v are the whole (B, S, H, D) on every rank; each rank
    runs the ring on its piece and the pieces are gathered back in rank
    order (JAX's ``shard_map`` with the sequence sharded in and out)."""
    if mesh is None or mesh.shape[axis] == 1:
        return ring_attention(q, k, v, mesh, axis)
    n, r = mesh.shape[axis], mesh.rank(axis)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by {axis}={n}")
    piece = q.shape[1] // n

    def local(t):
        return t[:, r * piece:(r + 1) * piece]

    out = ring_attention(local(q), local(k), local(v), mesh, axis)
    return mesh_mod.all_gather(out, mesh, axis, dim=1)


def reference_causal_attention(q, k, v):
    """Single-device causal attention, for numerical comparison."""
    scale = q.shape[-1] ** -0.5
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)
