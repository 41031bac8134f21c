"""PyTorch/CUDA port of the toolkit's serving workload.

``tpuslo_torch`` mirrors ``tpuslo``'s module layout
(``tpuslo_torch/models/llama.py`` answers to ``tpuslo/models/llama.py``)
and runs on one NVIDIA Hopper GPU.  It imports ``torch`` and numpy
only: nothing of JAX and nothing of the JAX package, which stays the
reference the port is held against in ``tests/test_torch_*.py``.

Entry points default to ``device="cuda"`` and raise when no CUDA device
is present; the CPU runs only when a caller asks for it explicitly.
"""

from tpuslo_torch.device import resolve_device

__all__ = ["resolve_device"]
