"""Fused attention forward (PyTorch port of ``tpuslo/ops/flash_attention.py``).

:func:`flash_attention` takes the JAX module's layout (q ``(B,S,H,D)``,
k/v ``(B,S,KV,D)``, output in q's dtype) and routes by the device of its
inputs alone:

* a CPU tensor runs :func:`flash_attention_reference`, the plain PyTorch
  version of the kernel's arithmetic (the CPU tests hold it to the
  Pallas kernel in interpret mode);
* a CUDA tensor launches one of two hand-written Hopper kernels (built
  with nvcc at first use, see :mod:`tpuslo_torch.ops._build`), chosen
  by :func:`kernel_route` from the inputs' dtypes and head dim alone:

  - K1, ``csrc/flash_attention.cu``: bf16 at head dims 128 and 256 (TMA
    loads into a two-stage K/V ring, both products on ``wgmma``);
  - K1-f32, ``csrc/attention_f32.cu``: everything else the JAX gate
    admits up to head dim 512 (f32, bf16 or f16 inputs; both products on
    the tensor cores in split precision, 3xTF32 for f32 inputs and p in
    two bf16 or f16 pieces for the others, so that the result holds f32
    accuracy; K/V tiles in a two-stage ``cp.async`` ring; inputs of mixed
    dtypes are read as f32, exactly, as the Pallas kernel casts every
    input to f32);

  a head dim past 512 raises, naming it.  There is no fallback from the
  card to the plain version, and the choice is never a ``try``.

``flash_attention.launches`` counts K1's launches and
``flash_attention.f32_launches`` K1-f32's, so that a run can show that
its path went through the kernel.

Training differentiates it: inputs that autograd records go through
:class:`_FlashAttention`, whose forward is the same routing (the kernel
on the card, counted; the plain version on the CPU) and which saves q, k
and v, as the JAX module's ``_flash_fwd`` does.  Its backward is
:func:`flash_attention_backward`, the plain PyTorch of the JAX module's
``_flash_bwd``: an f32 recompute with k and v repeated over the grouped
heads.  The JAX package has no backward kernel either (XLA computes
``_flash_bwd``); a remat recompute launches the forward kernel again.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuslo_torch.ops import _build, launch_counts

#: The head dims the bf16 ``wgmma`` kernel (K1) is instantiated for.
KERNEL_HEAD_DIMS = (128, 256)
#: The head dims the full-f32 kernel (K1-f32) is instantiated for.  The
#: JAX gate admits any multiple of 128; no model of the repo goes past 128.
F32_HEAD_DIMS = (128, 256, 384, 512)
#: Input dtypes K1-f32 reads (code passed to the kernel).
F32_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTE_WGMMA = "wgmma"
ROUTE_F32 = "f32"


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


def kernel_route(dtypes, head_dim: int) -> str:
    """Which CUDA kernel serves inputs of these dtypes (q, k, v) and head
    dim: :data:`ROUTE_WGMMA` (K1) for bf16 at a head dim in
    :data:`KERNEL_HEAD_DIMS`, else :data:`ROUTE_F32` (K1-f32) at a head
    dim in :data:`F32_HEAD_DIMS`.  Raises ``ValueError`` where no kernel
    is built: a head dim past 512 or outside the tables, or a dtype
    other than f32, bf16 and f16."""
    dtypes = tuple(dtypes)
    if all(d == torch.bfloat16 for d in dtypes) and head_dim in KERNEL_HEAD_DIMS:
        return ROUTE_WGMMA
    if head_dim > F32_HEAD_DIMS[-1]:
        raise ValueError(
            f"no CUDA kernel is built for head dim {head_dim}: flash attention "
            f"on the card takes head dims up to {F32_HEAD_DIMS[-1]}"
        )
    if head_dim not in F32_HEAD_DIMS:
        raise ValueError(
            f"no CUDA kernel is built for head dim {head_dim}; K1-f32 takes "
            f"{F32_HEAD_DIMS}"
        )
    bad = [d for d in dtypes if d not in F32_DTYPES]
    if bad:
        raise ValueError(
            f"flash attention on the card reads f32, bf16 or f16 inputs, got {bad}"
        )
    return ROUTE_F32


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.tpuslo_flash_attention_fwd_bf16
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_f32():
    lib = _build.load("attention_f32")
    fn = lib.tpuslo_flash_attention_fwd_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What both kernels need: the layouts, one device, unit inner
    strides and a flash-eligible shape."""
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
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit inner stride, got strides {t.stride()}")
    if not flash_eligible(tuple(q.shape), k.shape[2]):
        raise ValueError(
            f"q {tuple(q.shape)} with {k.shape[2]} kv heads is not "
            "flash-eligible (S % 128, D % 128, H % KV)"
        )


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What K1 (the bf16 ``wgmma`` kernel) takes: :func:`_check_shapes`
    and :func:`_check_wgmma_inputs`."""
    _check_shapes(q, k, v)
    _check_wgmma_inputs(q, k, v)


def _check_wgmma_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K1's own conditions on inputs that passed :func:`_check_shapes`:
    bf16, what a TMA tensor map can describe, and D 128 or 256."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernel takes bf16; {name} is {t.dtype}")
        # 16-byte multiples, and no broadcast (zero-stride) dim.
        if any(s % 8 for s in t.stride()[:-1]) or any(
            s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)
        ):
            raise ValueError(
                f"{name} needs a unit inner stride and 16-byte aligned rows, "
                f"got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernel is built for head dims {KERNEL_HEAD_DIMS}, got {q.shape[3]}"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Fused attention.  q: (B, S, H, D); k/v: (B, S, KV, D) with
    H % KV == 0.  Returns (B, S, H, D) in q's dtype.

    On the CPU this is :func:`flash_attention_reference`.  On CUDA it
    launches, on the current stream, the kernel :func:`kernel_route`
    names (K1 for bf16 at D 128 or 256, K1-f32 for the rest up to D 512)
    and raises on anything else, including a failed build or a refused
    launch.  Differentiable (:class:`_FlashAttention`).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_forward(q, k, v, causal)


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at ``(q, k, v)`` for the
    output cotangent ``d_out``: the JAX module's ``_flash_bwd`` in plain
    PyTorch.  f32 throughout: the probabilities recomputed with k and v
    repeated over the grouped heads and the causal mask,
    ``ds = p * (dp - sum(dp * p))``, the grouped heads' dk and dv summed
    back onto their kv head, each gradient cast to its input's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    n_rep = H // KV
    scale = D**-0.5
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    do = d_out.float()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    if causal:
        visible = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, float("-inf"))
    p = torch.softmax(s, dim=-1)  # (B, H, S, T)
    dv_rep = torch.einsum("bhst,bshd->bthd", p, do)
    dp = torch.einsum("bshd,bthd->bhst", do, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk_rep = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dk = dk_rep.reshape(B, S, KV, n_rep, D).sum(dim=3)
    dv = dv_rep.reshape(B, S, KV, n_rep, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The forward routing of :func:`flash_attention` (the kernel on the
    card) with :func:`flash_attention_backward` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, d_out, ctx.causal), None)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """:func:`flash_attention`'s forward: the plain version on the CPU,
    the routed kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_shapes(q, k, v)
    if kernel_route((q.dtype, k.dtype, v.dtype), q.shape[3]) == ROUTE_F32:
        return _flash_f32(q, k, v, causal)
    _check_wgmma_inputs(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D**-0.5, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def _vector_rows(t: torch.Tensor) -> torch.Tensor:
    """K1-f32 copies rows into shared memory 16 bytes at a time: a tensor
    whose start or outer strides are not 16-byte aligned is copied to a
    fresh contiguous tensor (the allocator aligns it); any other is read
    in place."""
    if t.data_ptr() % 16 or any((s * t.element_size()) % 16 for s in t.stride()[:3]):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _flash_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """Launch K1-f32.  Inputs of mixed dtypes are read as f32 (exact) and
    the output cast to q's dtype, as the Pallas kernel does."""
    out_dtype = q.dtype
    if not (q.dtype == k.dtype == v.dtype):
        q, k, v = q.float(), k.float(), v.float()
    q, k, v = _vector_rows(q), _vector_rows(k), _vector_rows(v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel_f32()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), F32_DTYPES[q.dtype],
            B, S, H, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            D**-0.5, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention f32 kernel launch failed: CUDA error {err}")
    flash_attention.f32_launches += 1
    return out.to(out_dtype)


flash_attention.launches = 0
flash_attention.f32_launches = 0
launch_counts.register(flash_attention, "launches", "f32_launches")
