"""A dense KV cache read as K2's lanes: the decode, verify and draft
passes' attention through :func:`~tpuslo_torch.ops.paged_attention.paged_decode_attention`.

A layer's cache side ``(B, T, KV, HD)`` (or int8 ``{"q", "s"}``) is, as
a free view, a pool of ``B * T / BS`` blocks of ``BS`` positions
(:func:`pool_view`): row ``b`` owns blocks ``b * T / BS ...``.  Each query
``(b, j)`` of a pass becomes one lane whose page table row holds row
``b``'s blocks (:func:`lane_table`, which depends on ``(B, K, T, BS)``
alone and is built once per shape and kept, so that a CUDA graph can
replay over it) and whose length is the query's position
(:func:`lane_lengths`): the step's token is already written and visible,
so the lane sees the positions ``<= position``, which is what the plain
attention's causal mask over the cache computes.  A position past the
cache end is clamped to its last position: every position stays visible,
as the mask leaves them.

Why lanes: K2 sizes its split from the block size and the blocks per
lane alone (:func:`~tpuslo_torch.ops.paged_attention.split_plan`) and
each lane reads only its own blocks, so a row's output bits do not
depend on the batch it is computed in; and it reads the cache in its own
dtype, so no pass copies a whole cache to f32.

The block size is the cache length where it fits one block
(``T <= MAX_BLOCK_SIZE``), else the fewest equal blocks
(:func:`lane_block_size`: 2048 positions are two blocks of 1024); both
give spans of 64 positions.
"""

from __future__ import annotations

import functools

import torch

from tpuslo_torch.ops.paged_attention import MAX_BLOCK_SIZE, paged_decode_attention


def lane_block_size(T: int) -> int:
    """``T`` split into the fewest equal blocks of at most
    :data:`~tpuslo_torch.ops.paged_attention.MAX_BLOCK_SIZE` positions."""
    n = -(-T // MAX_BLOCK_SIZE)
    while T % n:
        n += 1
    return T // n


def _blocks(t: torch.Tensor, BS: int) -> torch.Tensor:
    B, T = t.shape[:2]
    return t.view(B * (T // BS), BS, *t.shape[2:])


def pool_view(side, BS: int):
    """A layer's cache side ``(B, T, ...)`` as a pool ``(B * T / BS, BS,
    ...)``, with no copy (int8 sides: codes and scales alike)."""
    if isinstance(side, dict):
        return {"q": _blocks(side["q"], BS), "s": _blocks(side["s"], BS)}
    return _blocks(side, BS)


@functools.lru_cache(maxsize=None)
def lane_table(B: int, K: int, T: int, BS: int, device: torch.device) -> torch.Tensor:
    """``(B * K, T / BS)`` int32: lane ``b * K + j`` reads row ``b``'s
    blocks in order.  Built once per shape and device, then kept."""
    nb = T // BS
    rows = torch.arange(B, dtype=torch.int32, device=device).repeat_interleave(K)
    return (rows[:, None] * nb
            + torch.arange(nb, dtype=torch.int32, device=device)[None, :]).contiguous()


def lane_lengths(positions: torch.Tensor, T: int) -> torch.Tensor:
    """``(B * K,)`` int32 lane lengths from the queries' ``(B, K)``
    positions, clamped to the cache's last position."""
    return positions.reshape(-1).clamp(max=T - 1).to(torch.int32)


def dense_lane_attention(q: torch.Tensor, k_side, v_side, positions: torch.Tensor) -> torch.Tensor:
    """Attention of ``q`` ``(B, K, H, HD)`` over one layer's cache sides
    ``(B, T, KV, HD)``: query ``(b, j)`` sees row ``b``'s positions
    ``<= positions[b, j]``.  Returns ``(B, K, H, HD)`` in q's dtype."""
    B, K, H, HD = q.shape
    T = (k_side["q"] if isinstance(k_side, dict) else k_side).shape[1]
    BS = lane_block_size(T)
    out = paged_decode_attention(
        q.reshape(B * K, H, HD), pool_view(k_side, BS), pool_view(v_side, BS),
        lane_table(B, K, T, BS, q.device), lane_lengths(positions, T),
        block_size=BS, out_dtype=q.dtype,
    )
    return out.reshape(B, K, H, HD)
