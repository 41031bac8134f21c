"""Device resolution for the port's entry points.

Every entry point (``ServeEngine(...)``, ``init_params(...)``) takes an
explicit ``device`` that defaults to ``"cuda"``.  A missing card is an
error, never a quiet move to the CPU: the CPU runs only when the caller
passes ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and
    no CUDA device is available.

    On CUDA this also pins the two process-wide GEMM settings the port's
    numerics rest on: bf16 products accumulate in f32 and are rounded
    once (cuBLAS's reduced-precision split-K reduction is turned off),
    and f32 products run in full f32 (no TF32).  That is the contract of
    the JAX package's ``dot_general(..., preferred_element_type=f32)``
    followed by one cast, which ``tpuslo_torch.models.llama._matmul``
    reproduces.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU, where
    PyTorch runs synchronously)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
