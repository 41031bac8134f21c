"""PyTorch/CUDA port of the toolkit's serving workload.

``tpuslo_torch`` mirrors ``tpuslo``'s module layout
(``tpuslo_torch/models/llama.py`` answers to ``tpuslo/models/llama.py``)
and runs on one NVIDIA Hopper GPU.  It imports ``torch`` and numpy
only: nothing of JAX and nothing of the JAX package, which stays the
reference the port is held against in ``tests/test_torch_*.py``.

Entry points default to ``device="cuda"`` and raise when no CUDA device
is present; the CPU runs only when a caller asks for it explicitly.

Importing the package imports no ``torch``: ``resolve_device`` loads
:mod:`tpuslo_torch.device` at first use, so a process that runs plain
Python only (a straggler host of :mod:`tpuslo_torch.chaos`) starts
without it.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from tpuslo_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
