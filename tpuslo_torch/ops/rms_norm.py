"""Batch-invariant RMSNorm: a hand-written Hopper kernel and its plain
PyTorch version.

:func:`rms_norm` routes by the device of its input alone:

* a CPU tensor runs :func:`rms_norm_reference`, the model's RMSNorm as
  the JAX module computes it (f32 mean of squares, ``rsqrt``, cast back
  to the input dtype, then times the weight);
* a CUDA tensor launches ``csrc/batch_invariant.cu`` (built with nvcc at
  first use, see :mod:`tpuslo_torch.ops._build`): one CTA per row and an
  order of summation over the row that depends on its length alone, so
  that a row's output bits do not depend on how many rows share the call
  or on what they hold.  PyTorch's own reduction picks its block shape
  from the number of rows too, which is why the decode passes of one
  stream and of a batch of slots parted at near-ties.  It takes an f32,
  bf16 or f16 input with a weight of the same dtype and raises, naming
  it, on anything else; a failed build or launch raises too.  There is
  no fallback from the card to the plain version.

``rms_norm.launches`` counts calls that launched the kernel.
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


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("batch_invariant")
    fn = lib.tpuslo_rms_norm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` with a ``(D,)`` weight.

    On the CPU this is :func:`rms_norm_reference`.  On CUDA it launches
    the batch-invariant kernel on the current stream (never waiting for
    the card, so it can be captured in a CUDA graph) and returns a new
    tensor of ``x``'s shape and dtype.
    """
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    D = x.shape[-1]
    if x.dtype not in DTYPES or weight.dtype != x.dtype:
        raise ValueError(
            f"the RMSNorm kernel takes an input and a weight of one dtype in "
            f"{sorted(str(d) for d in DTYPES)}, got {x.dtype} and {weight.dtype}"
        )
    if weight.device != x.device or weight.shape != (D,) or weight.stride(-1) != 1:
        raise ValueError(
            f"the weight must be a ({D},) tensor with unit stride on {x.device}, got "
            f"{tuple(weight.shape)} on {weight.device}"
        )
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x2.data_ptr(), weight.data_ptr(), out.data_ptr(), x2.shape[0], D,
                        x2.stride(0), out.stride(0), float(eps), DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    return out.reshape(x.shape)


rms_norm.launches = 0
launch_counts.register(rms_norm, "launches")
