"""Batch-invariant RMSNorm, and the residual add fused into it: a
hand-written Hopper kernel and their plain PyTorch versions.

:func:`rms_norm` and :func:`add_rms_norm` route by the device of their
input alone:

* a CPU tensor runs the plain version: :func:`rms_norm_reference`, the
  model's RMSNorm as the JAX module computes it (f32 mean of squares,
  ``rsqrt``, cast back to the input dtype, then times the weight), and
  :func:`add_rms_norm_reference`, the eager residual add before it;
* a CUDA tensor launches ``csrc/batch_invariant.cu`` (built with nvcc at
  first use, see :mod:`tpuslo_torch.ops._build`): one CTA per row, with
  an order of summation over the row that depends on its length alone,
  so that a row's output bits do not depend on how many rows share the
  call or on what they hold.  PyTorch's own reduction picks its block
  shape from the number of rows too, which is why the decode passes of
  one stream and of a batch of slots parted at near-ties.  The fused
  kernel writes the residual ``h + d`` rounded once to the input dtype
  (the eager add's bits) and the norm of that rounded sum, in one pass
  over global memory.  Both take an f32, bf16 or f16 input with a weight
  (and an update) of the same dtype and raise, naming it, on anything
  else; a failed build or launch raises too.  There is no fallback from
  the card to the plain version.

``rms_norm.launches`` and ``add_rms_norm.launches`` count calls that
launched the kernel.

Both are differentiable: inputs that autograd records go through an
``autograd.Function`` whose forward is the same routing (the kernel on
the card) and whose backward is :func:`rms_norm_backward` /
:func:`add_rms_norm_backward`, the gradient of the plain version (the
JAX function ``(x32 * rms).astype(dtype) * weight``, after the residual
add in the model dtype) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuslo_torch.ops import _build, launch_counts

#: Input dtypes the kernel is built for (code passed to the kernel).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype, then scaled by the weight
    (in that order, as the JAX module does)."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def add_rms_norm_reference(
    h: torch.Tensor, d: torch.Tensor, weight: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h + d, rms_norm_reference(h + d))``: the residual add and the
    norm of its (rounded) result, as the model runs them eagerly."""
    h = h + d
    return h, rms_norm_reference(h, weight, eps)


def rms_norm_backward(
    x: torch.Tensor, weight: torch.Tensor, eps: float, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of :func:`rms_norm_reference` at ``(x, weight)`` for
    the output cotangent ``dy``: the plain version differentiated by
    autograd, op for op the vjp of the JAX function (the weight product
    in the input dtype, the normalization in f32)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        wr = weight.detach().requires_grad_()
        y = rms_norm_reference(xr, wr, eps)
        dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    return dx, dw


def add_rms_norm_backward(
    h_sum: torch.Tensor, weight: torch.Tensor, eps: float,
    d_sum: torch.Tensor, dy: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`add_rms_norm_reference` from the rounded sum
    ``h_sum = h + d`` it returned and the cotangents of its two outputs:
    ``(g, dweight)``, ``g = d_sum + dx`` (summed in the model dtype, as
    the JAX vjp sums a value's two cotangents) being the gradient of both
    ``h`` and ``d``."""
    dx, dw = rms_norm_backward(h_sum, weight, eps, dy)
    return d_sum + dx, dw


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("batch_invariant")
    norm = lib.tpuslo_rms_norm
    norm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    norm.restype = ctypes.c_int
    fused = lib.tpuslo_add_rms_norm
    fused.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fused.restype = ctypes.c_int
    return norm, fused


def _check(what: str, x: torch.Tensor, weight: torch.Tensor, *more: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    D = x.shape[-1]
    if x.dtype not in DTYPES or weight.dtype != x.dtype or any(m.dtype != x.dtype for m in more):
        raise ValueError(
            f"the {what} kernel takes tensors of one dtype in "
            f"{sorted(str(d) for d in DTYPES)}, got "
            f"{[str(t.dtype) for t in (x, *more, weight)]}"
        )
    if weight.device != x.device or weight.shape != (D,) or weight.stride(-1) != 1:
        raise ValueError(
            f"the weight must be a ({D},) tensor with unit stride on {x.device}, got "
            f"{tuple(weight.shape)} on {weight.device}"
        )
    for m in more:
        if m.shape != x.shape or m.device != x.device:
            raise ValueError(
                f"{what}: the update must match the input, got {tuple(m.shape)} on "
                f"{m.device} for {tuple(x.shape)} on {x.device}"
            )
    if (D * x.element_size()) % 16 == 0 and weight.data_ptr() % 16:
        raise ValueError(f"{what}: the weight must start on 16 bytes")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``(rows, D)`` with unit inner stride, and, where a row is
    a whole number of 16-byte packs, 16-byte aligned rows (a copy
    otherwise), so that the kernel's path depends on D alone."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    vec = 16 // x.element_size()
    if x2.stride(-1) != 1 or (D % vec == 0 and (x2.data_ptr() % 16 or x2.stride(0) % vec)):
        x2 = x2.contiguous()
        if D % vec == 0 and x2.data_ptr() % 16:
            x2 = x2.clone()
    return x2


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` with a ``(D,)`` weight.

    On the CPU this is :func:`rms_norm_reference`.  On CUDA it launches
    the batch-invariant kernel on the current stream (never waiting for
    the card, so it can be captured in a CUDA graph) and returns a new
    tensor of ``x``'s shape and dtype.
    """
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_norm_forward(x, weight, eps)


def _rms_norm_forward(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    _check("rms_norm", x, weight)
    x2 = _rows(x)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernels()[0](x2.data_ptr(), weight.data_ptr(), out.data_ptr(), x2.shape[0],
                            x2.shape[1], x2.stride(0), out.stride(0), float(eps),
                            DTYPES[x.dtype], stream)
    _raise_on(err, "rms_norm")
    rms_norm.launches += 1
    return out.reshape(x.shape)


def add_rms_norm(
    h: torch.Tensor, d: torch.Tensor, weight: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm after it: ``(h + d, y)`` with
    ``y`` the RMSNorm of the rounded ``h + d`` over the last axis.

    On the CPU this is :func:`add_rms_norm_reference`.  On CUDA it
    launches the fused kernel on the current stream (capturable in a CUDA
    graph) and returns two new tensors of ``h``'s shape and dtype: the
    sum has the eager add's bits, ``y`` the norm kernel's.
    """
    if torch.is_grad_enabled() and (h.requires_grad or d.requires_grad
                                    or weight.requires_grad):
        return _AddRMSNorm.apply(h, d, weight, eps)
    return _add_rms_norm_forward(h, d, weight, eps)


def _add_rms_norm_forward(h: torch.Tensor, d: torch.Tensor, weight: torch.Tensor,
                          eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    if h.device.type == "cpu":
        return add_rms_norm_reference(h, d, weight, eps)
    _check("add_rms_norm", h, weight, d)
    h2, d2 = _rows(h), _rows(d)
    h_out = torch.empty(h2.shape, dtype=h.dtype, device=h.device)
    y = torch.empty(h2.shape, dtype=h.dtype, device=h.device)
    if h2.shape[0] == 0:
        return h_out.reshape(h.shape), y.reshape(h.shape)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernels()[1](h2.data_ptr(), d2.data_ptr(), weight.data_ptr(), h_out.data_ptr(),
                            y.data_ptr(), h2.shape[0], h2.shape[1], h2.stride(0),
                            d2.stride(0), h_out.stride(0), y.stride(0), float(eps),
                            DTYPES[h.dtype], stream)
    _raise_on(err, "add_rms_norm")
    add_rms_norm.launches += 1
    return h_out.reshape(h.shape), y.reshape(h.shape)


class _RMSNorm(torch.autograd.Function):
    """:func:`rms_norm`'s forward routing with :func:`rms_norm_backward`."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        return (*rms_norm_backward(x, weight, ctx.eps, dy), None)


class _AddRMSNorm(torch.autograd.Function):
    """:func:`add_rms_norm`'s forward routing with
    :func:`add_rms_norm_backward`; it keeps the rounded sum, the one
    tensor the gradient needs."""

    @staticmethod
    def forward(ctx, h, d, weight, eps):
        ctx.eps = eps
        h_sum, y = _add_rms_norm_forward(h, d, weight, eps)
        ctx.save_for_backward(h_sum, weight)
        return h_sum, y

    @staticmethod
    def backward(ctx, d_sum, dy):
        h_sum, weight = ctx.saved_tensors
        g, dw = add_rms_norm_backward(h_sum, weight, ctx.eps, d_sum, dy)
        return g, g, dw, None


rms_norm.launches = 0
add_rms_norm.launches = 0
launch_counts.register(rms_norm, "launches")
launch_counts.register(add_rms_norm, "launches")
