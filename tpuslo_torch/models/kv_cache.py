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
raises instead.  Per-row scatters use PyTorch's own index checks, which
raise on out-of-range rows or positions.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

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
    (the vector-length batched decode path), in place."""
    if isinstance(kv, dict):
        qs = quantize_kv(new)
        kv["q"][rows, pos] = qs["q"]
        kv["s"][rows, pos] = qs["s"]
        return kv
    kv[rows, pos] = new
    return kv


def kv_write_rows_seq(
    kv: KV, new: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor
) -> KV:
    """Scatter a ``(B, K, KV, HD)`` chunk per row starting at per-row
    positions (batched verify: every row scores K positions from its
    own cache frontier), in place."""
    K = new.shape[1]
    idx = pos[:, None] + torch.arange(K, device=pos.device)[None, :]
    if isinstance(kv, dict):
        qs = quantize_kv(new)
        kv["q"][rows[:, None], idx] = qs["q"]
        kv["s"][rows[:, None], idx] = qs["s"]
        return kv
    kv[rows[:, None], idx] = new
    return kv


def init_kv(
    shape: tuple[int, ...],
    dtype: torch.dtype,
    kv_dtype: str,
    device: torch.device | str = "cpu",
) -> KV:
    """One cache side (k or v) of logical shape ``(..., S, KV, HD)``."""
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


def kv_map(fn: Callable[[torch.Tensor], torch.Tensor], kv: KV) -> KV:
    """Apply a tensor->tensor fn to each buffer of either representation
    (clone, repeat-along-batch, per-layer view...)."""
    if isinstance(kv, dict):
        return {"q": fn(kv["q"]), "s": fn(kv["s"])}
    return fn(kv)
