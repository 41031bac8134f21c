"""Sequence-parallel prefill handoff: ring attention fills a dense cache
(PyTorch port of ``tpuslo/models/sp_serve.py``).

Two long-prompt regimes, one prefill
(:func:`tpuslo_torch.models.longserve.sp_prefill_raw`: ring attention
over the ``sp`` axis, O(S / p) activations per rank):

* **The context exceeds one device's KV**:
  :mod:`tpuslo_torch.models.longserve` keeps the KV split and decodes
  distributed.
* **The context fits one device, but its prefill is slow** (this
  module): the O(S^2) prefill is split over sp, while the decode, one
  token at a time, continues on the ordinary single-device engine.  The
  KV is gathered into the dense cache layout once, at the handoff.
"""

from __future__ import annotations

import torch

from tpuslo_torch.models import kv_cache as kvc
from tpuslo_torch.models.llama import _as_length
from tpuslo_torch.models.longserve import sp_prefill_raw
from tpuslo_torch.parallel import mesh as mesh_mod

# Re-exported: the sharded prefill is this module's compute path.
sp_prefill = sp_prefill_raw


def sp_prefill_into_cache(
    params,
    tokens: torch.Tensor,
    cache: dict,
    cfg,
    mesh,
    axis_name: str = "sp",
    true_length=None,
) -> tuple[torch.Tensor, dict]:
    """:func:`sp_prefill_raw` with the dense-cache contract of
    :func:`tpuslo_torch.models.llama.prefill`: writes the prompt's KV into
    ``cache`` (dense layout, in place), sets ``length`` to
    ``true_length`` and returns the logits the decode loop continues
    from.  ``true_length`` covers pad-bucketed prompts (pad KV past it is
    masked by the decode's ``length``).  The all_gather of each side to
    the dense layout happens here, once: the handoff from the split
    prefill to the unsplit decode."""
    B, S = tokens.shape
    if true_length is None:
        true_length = S
    logits, ks, vs = sp_prefill_raw(
        params, tokens, cfg, mesh, axis_name, true_length=true_length
    )
    if mesh is not None and mesh.distributed:
        ks = mesh_mod.all_gather(ks, mesh, axis_name, dim=2)
        vs = mesh_mod.all_gather(vs, mesh, axis_name, dim=2)
    cache = {
        "k": kvc.kv_write_stacked(cache["k"], ks),
        "v": kvc.kv_write_stacked(cache["v"], vs),
        "length": _as_length(true_length, B, tokens.device),
    }
    return logits, cache
