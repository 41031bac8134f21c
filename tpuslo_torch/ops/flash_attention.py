"""Fused attention forward (PyTorch port of ``tpuslo/ops/flash_attention.py``).

:func:`flash_attention` takes the JAX module's layout (q ``(B,S,H,D)``,
k/v ``(B,S,KV,D)``, output in q's dtype) and routes by the device of its
inputs alone:

* a CPU tensor runs :func:`flash_attention_reference`, the plain PyTorch
  version of the kernel's arithmetic (the CPU tests hold it to the
  Pallas kernel in interpret mode);
* a CUDA tensor launches the hand-written Hopper kernel in
  ``csrc/flash_attention.cu`` (built with nvcc at first use, see
  :mod:`tpuslo_torch.ops._build`), or the call raises.  There is no
  fallback from the card to the plain version.

``flash_attention.launches`` counts kernel launches, so that a run can
show that its path went through the kernel.  Only the forward pass is
ported: serving never differentiates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuslo_torch.ops import _build

HEAD_DIM = 128  # the only head dim the kernel is built for


def flash_eligible(q_shape: tuple[int, ...], kv_heads: int) -> bool:
    """Can :func:`flash_attention` handle this full-sequence attention?
    The same predicate as the JAX module at its default 128 blocks:
    S a multiple of 128, D a multiple of 128, H divisible by the kv
    heads."""
    if len(q_shape) != 4:
        return False
    _, S, H, D = q_shape
    return S % 128 == 0 and D % 128 == 0 and H % kv_heads == 0


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's arithmetic: f32 inputs
    and products, GQA by ``h // n_rep``, ``-inf`` masking, and an
    ``l == 0`` guard for rows that see no key.  Output in q's dtype."""
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * D**-0.5
    if causal:
        T = k.shape[1]
        visible = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1)
    denom = torch.where(l_sum == 0.0, torch.ones_like(l_sum), l_sum)
    out = torch.einsum("bhst,bthd->bshd", p, vf) / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.tpuslo_flash_attention_fwd_bf16
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants q (B,S,H,D), k/v (B,S,KV,D)")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(
            f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match "
            f"q {tuple(q.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernel takes bf16; {name} is {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(
                f"{name} needs a unit inner stride and 16-byte aligned rows, "
                f"got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for head dim {HEAD_DIM}, got {D}")
    if not flash_eligible(tuple(q.shape), k.shape[2]):
        raise ValueError(
            f"q {tuple(q.shape)} with {k.shape[2]} kv heads is not "
            "flash-eligible (S % 128, D % 128, H % KV)"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Fused attention.  q: (B, S, H, D); k/v: (B, S, KV, D) with
    H % KV == 0.  Returns (B, S, H, D) in q's dtype.

    On the CPU this is :func:`flash_attention_reference`.  On CUDA it
    launches the Hopper kernel on the current stream (bf16, D = 128,
    S % 128 == 0) and raises on anything else, including a failed build
    or a refused launch.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_kernel_inputs(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D**-0.5, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
