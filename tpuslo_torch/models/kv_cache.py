"""KV-cache representations: dense and int8-quantized (PyTorch port of
``tpuslo/models/kv_cache.py``).

* dense: a ``(..., S, KV, HD)`` tensor in the model dtype;
* int8: ``{"q": int8 (..., S, KV, HD), "s": f32 (..., S, KV)}`` with one
  symmetric scale per (position, kv head), amax over the head dim.

Reads go through :func:`kv_load`, which dequantizes ``q * s``.  Writes
go through :func:`kv_write_seq` (contiguous chunk at a scalar start:
prefill and verify), :func:`kv_write_stacked` (every layer at position
0), :func:`kv_write_rows` (one slot per row at per-row positions:
batched decode) or :func:`kv_write_rows_seq` (a chunk per row at per-row
positions), which quantize the incoming slab when the cache is int8.

Unlike the JAX module, whose arrays are immutable, every write here
updates the cache tensors **in place** and returns the same
representation for convenience.  A caller that needs a snapshot to
survive later writes clones it first (``kv_map(torch.clone, kv)``).

``lax.dynamic_update_slice`` clamps a start that runs past the end of
the cache, silently overwriting earlier positions; :func:`kv_write_seq`
raises instead.  :func:`kv_write_rows` drops a row's write at a position
at or past the cache end, as JAX's scatter does: the continuous-batching
engines keep decoding released slots, whose lengths walk past the end,
and such a write must neither raise on the CPU nor trip a device-side
assert on the card.  :func:`kv_write_rows_seq` drops every single
position at or past the cache end in the same way: a finished row of a
speculative batch keeps verifying ``k + 1`` positions from a frontier
that may sit within ``k`` of the end.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from tpuslo_torch.device import resolve_device

KV_DTYPES = ("bf16", "int8")

KV = Any  # a dense tensor or an int8 {"q", "s"} dict


def validate_kv_dtype(kv_dtype: str) -> str:
    """One source of truth for the engine constructors' dtype guard."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}"
        )
    return kv_dtype


def quantize_kv(x: torch.Tensor) -> dict:
    """``(..., KV, HD)`` -> {"q": int8, "s": f32 over HD}.

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    int8 codes equal the JAX module's on the same inputs.
    """
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    s = s.clamp_min(1e-12)
    q = torch.round(x32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def kv_load(kv: KV, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Materialize a cache operand for attention (dequantizing if
    needed)."""
    if isinstance(kv, dict):
        return (kv["q"].float() * kv["s"][..., None]).to(dtype)
    return kv


def kv_write_seq(kv: KV, new: torch.Tensor, start: int) -> KV:
    """Write a contiguous ``(B, K, KV, HD)`` chunk at position ``start``
    into a ``(B, S, KV, HD)``-shaped cache (either representation), in
    place.  Raises if ``start .. start+K`` does not fit the cache."""
    start = int(start)
    K = new.shape[1]
    S = (kv["q"] if isinstance(kv, dict) else kv).shape[1]
    if start < 0 or start + K > S:
        raise ValueError(
            f"KV write of {K} positions at start {start} runs past the "
            f"cache end ({S} positions)"
        )
    if isinstance(kv, dict):
        qs = quantize_kv(new)
        kv["q"][:, start : start + K] = qs["q"]
        kv["s"][:, start : start + K] = qs["s"]
        return kv
    kv[:, start : start + K] = new
    return kv


def kv_write_stacked(kv: KV, new: torch.Tensor) -> KV:
    """Write a layer-stacked ``(L, B, K, KV, HD)`` slab at position 0,
    in place."""
    K = new.shape[2]
    S = (kv["q"] if isinstance(kv, dict) else kv).shape[2]
    if K > S:
        raise ValueError(f"KV write of {K} positions exceeds the cache ({S})")
    if isinstance(kv, dict):
        qs = quantize_kv(new)
        kv["q"][:, :, :K] = qs["q"]
        kv["s"][:, :, :K] = qs["s"]
        return kv
    kv[:, :, :K] = new
    return kv


def kv_write_rows(
    kv: KV, new: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor
) -> KV:
    """Scatter one ``(B, KV, HD)`` slot per row at per-row positions
    (the vector-length batched decode path), in place.

    A row whose position is at or past the cache end writes nothing, as
    JAX's out-of-range scatter drops it: the write goes through a clamped
    index and keeps the old value there, so no index ever leaves the
    cache and rows inside it are written exactly as before.
    """
    S = (kv["q"] if isinstance(kv, dict) else kv).shape[1]
    inside = pos < S
    idx = pos.clamp(max=S - 1)

    def put(side, value):
        keep = inside.view((-1,) + (1,) * (value.ndim - 1))
        side[rows, idx] = torch.where(keep, value, side[rows, idx])

    if isinstance(kv, dict):
        qs = quantize_kv(new)
        put(kv["q"], qs["q"])
        put(kv["s"], qs["s"])
        return kv
    put(kv, new)
    return kv


def rows_seq_index(
    pos: torch.Tensor, K: int, S: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, inside) of a ``K``-position chunk per row from per-row
    starts ``pos`` in a cache of ``S`` positions, both ``(B, K)``.

    ``inside`` marks the positions that lie in the cache.  A position
    past the end is sent to ``position % S``: within one row the wrapped
    indices are distinct from each other and from the positions inside
    (``K <= S``), so a write through ``index`` names every slot once and
    its outcome does not depend on the order of the scatter.
    """
    if K > S:
        raise ValueError(f"a chunk of {K} positions exceeds the cache ({S})")
    idx = pos[:, None] + torch.arange(K, device=pos.device)[None, :]
    return idx % S, idx < S


def kv_write_rows_seq(
    kv: KV, new: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
    index: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> KV:
    """Scatter a ``(B, K, KV, HD)`` chunk per row starting at per-row
    positions (batched verify: every row scores K positions from its
    own cache frontier), in place.

    A position at or past the cache end writes nothing, as JAX's
    out-of-range scatter drops it: it goes through a wrapped index that
    gets its old value back (:func:`rows_seq_index`; ``index`` passes a
    precomputed pair, so that a layer loop computes it once).
    """
    S = (kv["q"] if isinstance(kv, dict) else kv).shape[1]
    idx, inside = index if index is not None else rows_seq_index(pos, new.shape[1], S)
    r = rows[:, None]

    def put(side, value):
        keep = inside.view(inside.shape + (1,) * (value.ndim - 2))
        side[r, idx] = torch.where(keep, value, side[r, idx])

    if isinstance(kv, dict):
        qs = quantize_kv(new)
        put(kv["q"], qs["q"])
        put(kv["s"], qs["s"])
        return kv
    put(kv, new)
    return kv


def init_kv(
    shape: tuple[int, ...],
    dtype: torch.dtype,
    kv_dtype: str,
    device: torch.device | str = "cuda",
) -> KV:
    """One cache side (k or v) of logical shape ``(..., S, KV, HD)``, on
    the card by default (``resolve_device``: raises without one); pass
    ``device="cpu"`` for the plain path on the CPU."""
    device = resolve_device(device)
    if validate_kv_dtype(kv_dtype) == "int8":
        return {
            "q": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_bytes(shape: tuple[int, ...], dtype: torch.dtype, kv_dtype: str) -> int:
    """Device bytes for one cache side (2 bytes/elt in bf16; 1 + 4/HD
    with int8 codes and f32 scales)."""
    n = math.prod(shape)
    if kv_dtype == "int8":
        return n + 4 * (n // shape[-1])
    return n * dtype.itemsize


def kv_leaf_pairs(a: KV, b: KV) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(a leaf, b leaf) pairs of two cache sides in one representation,
    for copies between them (``dst[...] = src[...]`` per pair)."""
    if isinstance(a, dict):
        return [(a["q"], b["q"]), (a["s"], b["s"])]
    return [(a, b)]


def kv_map(fn: Callable[[torch.Tensor], torch.Tensor], kv: KV) -> KV:
    """Apply a tensor->tensor fn to each buffer of either representation
    (clone, repeat-along-batch, per-layer view...)."""
    if isinstance(kv, dict):
        return {"q": fn(kv["q"]), "s": fn(kv["s"])}
    return fn(kv)
