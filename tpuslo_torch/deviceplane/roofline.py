"""Roofline verdicts: is this launch memory- or compute-bound? (the port's
counterpart of ``tpuslo/deviceplane/roofline.py``).

An attribution that names a fault domain without saying WHICH roof the
workload sits under leaves the operator guessing at the fix (more
batch? fewer bytes? faster dispatch?).  This module folds per-launch
bytes and FLOP estimates into a verdict against the card's public roofs
and returns the ``roofline`` block the JAX package attaches to
serving-path attributions.

The folds (:func:`decode_step_cost`, :func:`roofline_verdict`,
:func:`verdict_from_ledger`, :func:`attach_roofline`) are the JAX
module's.  What changes is where the roofs come from:
:func:`peaks_for_chip` reads a table of the cards the port runs on,
keyed by the name ``torch.cuda.get_device_name()`` gives, and a name it
does not know is an error, never another card's roof.  The folds take
the roofs as required arguments (the JAX module defaults them to its
v5e row); :func:`card_peaks` reads them for the card this process runs
on.

The verdict rule is the classical roofline: the binding roof is the one
the launch uses the larger fraction of.  ``detail`` spells out the
actionable reading (memory-bound decode leaves MFU meaningless;
compute-bound prefill leaves bandwidth meaningless).
"""

from __future__ import annotations

from typing import Any

import torch

from tpuslo_torch.deviceplane.ledger import DeviceLedger

VERDICT_MEMORY_BOUND = "memory_bound"
VERDICT_COMPUTE_BOUND = "compute_bound"

#: NVIDIA H100 SXM5 80 GB, public data sheet: HBM3 rate and dense bf16
#: tensor-core rate.
H100_PEAK_HBM_BW = 3.35e12
H100_PEAK_BF16_FLOPS = 989e12

#: (HBM bytes/s, dense bf16 FLOP/s) by ``torch.cuda.get_device_name()``.
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (H100_PEAK_HBM_BW, H100_PEAK_BF16_FLOPS),
}


def peaks_for_chip(device_kind: str) -> tuple[float, float]:
    """(HBM bytes/s, bf16 FLOP/s) roofs of a card, by the name
    ``torch.cuda.get_device_name()`` gives.  Raises ``KeyError`` for a
    card the table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no roofline peaks for {device_kind!r}; known cards: "
            f"{sorted(PEAKS)}"
        ) from None


def card_peaks(device: int | None = None) -> tuple[float, float]:
    """:func:`peaks_for_chip` of the card this process runs on (the
    current CUDA device, or ``device``).  Raises ``RuntimeError`` without
    a card and ``KeyError`` for a card the table does not hold."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to read the roofs of; pass them")
    return peaks_for_chip(torch.cuda.get_device_name(device))


def decode_step_cost(
    n_params: float,
    kv_cache_bytes: float,
    batch: int = 1,
    param_bytes: float = 2.0,
) -> tuple[float, float]:
    """(bytes, FLOPs) one decode step must move/compute.

    Bytes: weights stream once per step regardless of batch; the dense
    cache reads its FULL allocation every step.  FLOPs: 2 MACs per
    parameter per token, ``batch`` tokens per step.
    """
    step_bytes = n_params * param_bytes + kv_cache_bytes
    step_flops = 2.0 * n_params * batch
    return step_bytes, step_flops


def roofline_verdict(
    device_time_ms: float,
    bytes_moved: float,
    flops: float,
    *,
    peak_bw: float,
    peak_flops: float,
    launch_name: str = "",
) -> dict[str, Any]:
    """Fold one launch's cost estimate into a schema-ready verdict.

    ``device_time_ms`` is the launch's measured device time (ledger
    ``joined`` time for the program); ``bytes_moved``/``flops`` the
    cost model's estimate for one execution; ``peak_bw``/``peak_flops``
    the card's roofs (:func:`peaks_for_chip`, :func:`card_peaks`).
    """
    seconds = max(device_time_ms, 1e-6) / 1e3
    achieved_bw = bytes_moved / seconds
    achieved_flops = flops / seconds
    bw_frac = achieved_bw / peak_bw if peak_bw else 0.0
    flop_frac = achieved_flops / peak_flops if peak_flops else 0.0
    memory_bound = bw_frac >= flop_frac
    verdict = VERDICT_MEMORY_BOUND if memory_bound else VERDICT_COMPUTE_BOUND
    bound_pct = 100.0 * max(bw_frac, flop_frac)
    if memory_bound:
        detail = (
            f"memory-bound: {100 * bw_frac:.1f}% of the "
            f"{peak_bw / 1e9:.0f} GB/s HBM roof vs "
            f"{100 * flop_frac:.1f}% MFU — MFU is the wrong lens here; "
            "headroom means underfilled DMAs or dispatch overhead, and "
            "the levers are bytes/step (quantized KV/weights) or batch"
        )
    else:
        detail = (
            f"compute-bound: {100 * flop_frac:.1f}% MFU vs "
            f"{100 * bw_frac:.1f}% of the HBM roof — the tensor cores are "
            "the wall; the levers are FLOPs/token (shorter context, "
            "sparsity) or a bigger card"
        )
    out: dict[str, Any] = {
        "verdict": verdict,
        "achieved_gb_per_sec": round(achieved_bw / 1e9, 2),
        "peak_gb_per_sec": round(peak_bw / 1e9, 1),
        "hbm_bw_pct": round(100.0 * bw_frac, 2),
        "mfu_pct": round(100.0 * flop_frac, 2),
        "bound_pct": round(bound_pct, 2),
        "device_time_ms": round(device_time_ms, 4),
        "detail": detail,
    }
    if launch_name:
        out["launch"] = launch_name
    return out


def verdict_from_ledger(
    ledger: DeviceLedger,
    bytes_per_step: float,
    flops_per_step: float,
    program_id: str = "",
    *,
    peak_bw: float,
    peak_flops: float,
) -> dict[str, Any] | None:
    """Roofline verdict for the ledger's serving program.

    Uses the MEAN joined device time per launch of ``program_id`` (or
    of every joined launch when unset) so one stalled step does not
    masquerade as a bandwidth collapse; returns None when the ledger
    joined nothing (no device-time denominator — never invent one).
    A launch's device time sums its module spans (one per launch on a
    TPU and in the seeded captures; one per run of its kernels on a
    card), keyed by device, program and launch number.
    """
    per_launch: dict[tuple[int, str, int], float] = {}
    for rec in ledger.launches:
        if rec.bucket == "joined" and (not program_id or rec.program_id == program_id):
            key = (rec.device_pid, rec.program_id, rec.launch_id)
            per_launch[key] = per_launch.get(key, 0.0) + rec.duration_us / 1e3
    times = list(per_launch.values())
    if not times:
        return None
    mean_ms = sum(times) / len(times)
    name = program_id or "joined-launch-mean"
    out = roofline_verdict(
        mean_ms, bytes_per_step, flops_per_step,
        peak_bw=peak_bw, peak_flops=peak_flops, launch_name=name,
    )
    out["launches"] = len(times)
    return out


def attach_roofline(attribution: Any, verdict: dict[str, Any]) -> Any:
    """Attach a verdict block to an attribution (the ``roofline``
    contract block of ``IncidentAttribution``)."""
    attribution.roofline = dict(verdict)
    return attribution
