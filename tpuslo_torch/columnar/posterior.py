"""Naive-Bayes posterior as one batched log-likelihood contraction (the
port's counterpart of ``tpuslo/columnar/posterior.py``).

The scoring math is pure array algebra: with per-sample evidence
weights ``W [n, S]`` and observation mask ``O [n, S]`` over the
likelihood table ``L [S, D]``,

    log_post = log_priors + (W·O) @ log L + (O − W·O) @ log (1 − L)

— a pair of ``(n, S) @ (S, D)`` products plus element-wise prep.  This
module is the single implementation of that kernel, with two lanes over
one body (:func:`_kernel`):

* :func:`_numpy_kernel`, the default and the f64 source of truth
  (``BayesianAttributor.attribute_batch`` calls it; bit for bit the JAX
  package's numpy path);
* :func:`_torch_kernel`, the port's counterpart of the JAX package's
  ``jax.jit`` lane: the same body in torch, f64 throughout (the products
  are cuBLAS f64 GEMMs on the card), on ``resolve_device(device)``,
  ``"cuda"`` by default.  Inputs are copied up and ``(posteriors,
  weights, observed)`` come back as numpy.

Engagement policy (the JAX module's, with the JAX names changed):
numpy is the default — correctness gates (calibrated heldout macro-F1)
are certified on the f64 numpy path.  ``use_torch=None`` (auto)
considers the torch lane only for batches of ≥ :data:`JIT_MIN_BATCH`
rows and only where a CUDA device is present — and then MEASURES before
committing: the first auto call at each power-of-two row bucket times
both lanes on the call's own inputs (the torch lane with its copies in
and out, a ``torch.cuda.synchronize()`` before each clock read, since
the caller gets numpy) and engages the torch lane for that bucket only
when it wins by ≥ :data:`JIT_WIN_MARGIN`; the verdict is cached per
(soft, sharpness, signals, bucket) for the process.
``TPUSLO_COLUMNAR_JIT=1`` forces the torch lane on any size, ``=0``
disables it, and ``TPUSLO_COLUMNAR_JIT_MIN_ROWS=N`` moves the auto floor
(operators set these; the names and meanings are the JAX package's).

One difference from the reference, on purpose: the JAX module's
``resolve_use_jax(n, True)`` quietly returns False (numpy) when jax does
not import.  Here a forced torch lane (``use_torch=True`` or
``TPUSLO_COLUMNAR_JIT=1``) with no card and no ``device="cpu"`` raises
(from :func:`tpuslo_torch.device.resolve_device`): a request for the card
is never served by numpy behind the caller's back.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np


#: Auto mode CONSIDERS the torch lane at this batch size: below it, the
#: launches and copies cost more than the products save, so the probe
#: itself isn't worth paying.  Above it, a measured probe decides (see
#: the module docstring).
JIT_MIN_BATCH = 4096

#: Auto-probe margin: the torch lane must beat numpy by this factor on
#: the timed probe before it engages for a bucket — hysteresis so a
#: marginal win can't flap into a regression on a noisy host.
JIT_WIN_MARGIN = 1.15

#: Probe rows are capped here: timing fidelity saturates while probe
#: cost keeps growing.
JIT_PROBE_MAX_ROWS = 65536

#: (soft, sharpness, n_signals, row_bucket) -> the probe's verdict.
_AUTO_PROBES: dict[tuple[bool, float, int, int], dict[str, Any]] = {}


@dataclass(slots=True)
class PosteriorMatrices:
    """Dense kernel inputs derived from one attributor's tables."""

    log_priors: np.ndarray  # [D]
    log_lik: np.ndarray  # [S, D] log clamp(P)
    log_not_lik: np.ndarray  # [S, D] log clamp(1 - P)
    thresholds: np.ndarray  # [S] warning thresholds (+inf when none)
    warns: np.ndarray  # [S] warning thresholds (NaN when none)
    errs: np.ndarray  # [S] error thresholds (NaN-propagating)
    continuous: np.ndarray  # [S] zero means missing-probe in soft mode
    ambiguous: np.ndarray  # [S] zero is ambiguous (drop mixture)
    p_drop: np.ndarray  # [S, 1] drop prior per ambiguous signal


class _NumpyOps:
    """The array operations :func:`_kernel` needs, in numpy."""

    maximum = staticmethod(np.maximum)
    clip = staticmethod(np.clip)
    log = staticmethod(np.log)
    exp = staticmethod(np.exp)
    where = staticmethod(np.where)
    isfinite = staticmethod(np.isfinite)

    @staticmethod
    def astype(x, like):
        return x.astype(like.dtype)

    @staticmethod
    def rowmax(x):
        return x.max(axis=1, keepdims=True)

    @staticmethod
    def rowsum(x):
        return x.sum(axis=1, keepdims=True)


class _TorchOps:
    """The same operations in torch (``clip`` → ``clamp``, ``astype`` →
    ``.to``); every float stays f64."""

    def __init__(self):
        import torch

        self.log = torch.log
        self.exp = torch.exp
        self.where = torch.where
        self.isfinite = torch.isfinite

    @staticmethod
    def maximum(x, floor: float):
        return x.clamp(min=floor)

    @staticmethod
    def clip(x, lo: float, hi: float):
        return x.clamp(lo, hi)

    @staticmethod
    def astype(x, like):
        return x.to(like.dtype)

    @staticmethod
    def rowmax(x):
        return x.amax(dim=1, keepdim=True)

    @staticmethod
    def rowsum(x):
        return x.sum(dim=1, keepdim=True)


def _kernel(
    values,
    observed,
    log_priors,
    log_lik,
    log_not_lik,
    thresholds,
    warns,
    errs,
    continuous,
    ambiguous,
    p_drop,
    soft: bool,
    sharpness: float,
    xp,
):
    """Shared numpy/torch body; keep op order aligned with the scalar path."""
    obs = observed
    if soft:
        obs = obs & ~(continuous & (values == 0.0))
        scale = xp.maximum(xp.log(errs / warns), 1e-6)
        z = sharpness * xp.log(xp.maximum(values, 1e-300) / warns) / scale
        z = xp.where((values > 0) & xp.isfinite(z), z, -60.0)
        weights = 1.0 / (1.0 + xp.exp(-xp.clip(z, -60.0, 60.0)))
    else:
        weights = xp.astype(obs & (values >= thresholds), values)
    obsf = xp.astype(obs, values)
    w_obs = weights * obsf
    log_post = (
        log_priors + w_obs @ log_lik + (obsf - w_obs) @ log_not_lik
    )
    if soft:
        # Ambiguous zeros: drop mixture replaces the healthy factor.
        zero_counter = xp.astype(obs & ambiguous & (values == 0.0), values)
        not_lik = xp.exp(log_not_lik)
        adj = xp.log(p_drop + (1.0 - p_drop) * not_lik) - log_not_lik
        log_post = log_post + zero_counter @ adj
    shifted = log_post - xp.rowmax(log_post)
    e = xp.exp(shifted)
    posteriors = e / xp.rowsum(e)
    return posteriors, weights, obs


def _numpy_kernel(values, observed, mats, soft, sharpness):
    with np.errstate(divide="ignore", invalid="ignore"):
        return _kernel(
            values, observed,
            mats.log_priors, mats.log_lik, mats.log_not_lik,
            mats.thresholds, mats.warns, mats.errs,
            mats.continuous, mats.ambiguous, mats.p_drop,
            soft=soft, sharpness=sharpness, xp=_NumpyOps,
        )


def _torch_kernel(values, observed, mats, soft, sharpness, device="cuda"):
    """The torch lane: inputs copied to ``resolve_device(device)`` (f64
    values, bool masks), the shared body, results copied back to numpy.
    Raises without a card unless ``device="cpu"``."""
    import torch

    from tpuslo_torch.device import resolve_device

    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    posteriors, weights, obs = _kernel(
        up(values), up(observed),
        up(mats.log_priors), up(mats.log_lik), up(mats.log_not_lik),
        up(mats.thresholds), up(mats.warns), up(mats.errs),
        up(mats.continuous), up(mats.ambiguous), up(mats.p_drop),
        soft=soft, sharpness=sharpness, xp=_TorchOps(),
    )
    return posteriors.cpu().numpy(), weights.cpu().numpy(), obs.cpu().numpy()


def cuda_available() -> bool:
    """Is there a CUDA device for the torch lane (auto mode's gate)?"""
    import torch

    return torch.cuda.is_available()


def _auto_min_rows() -> int:
    env = os.environ.get("TPUSLO_COLUMNAR_JIT_MIN_ROWS", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return JIT_MIN_BATCH


def _row_bucket(n_rows: int) -> int:
    """Largest power-of-two probe bucket INSIDE ``n_rows`` (capped).

    Rounding down matters: the probe slices the call's own inputs to
    the bucket, so an upward-rounded bucket would time fewer rows
    than the key it caches the verdict under — and near the crossover
    that verdict would be applied to batches up to ~2x larger than
    what was actually measured.
    """
    capped = max(1, min(n_rows, JIT_PROBE_MAX_ROWS))
    bucket = 1
    while bucket * 2 <= capped:
        bucket <<= 1
    return bucket


def resolve_use_torch(n_rows: int, use_torch: bool | None) -> bool | None:
    """Arg/env layer of the engagement policy.

    True/False are final verdicts (True raises later without a card,
    unless the caller runs the lane on the CPU); ``None`` means "auto at
    probe-worthy size on a card" — :func:`log_posterior_batch` then
    consults (or runs) the measured per-bucket probe, which needs the
    call's actual inputs.
    """
    if use_torch is not None:
        return bool(use_torch)
    env = os.environ.get("TPUSLO_COLUMNAR_JIT", "")
    if env == "0":
        return False
    if env == "1":
        return True
    if n_rows < _auto_min_rows() or not cuda_available():
        return False
    return None


def _probe_auto(values, observed, mats, soft, sharpness, device="cuda") -> bool:
    """Measure numpy vs the torch lane on THIS call's inputs; cache per
    bucket.

    Each side is timed on its second run (the first pays the torch lane's
    one-off set-up, and warms numpy's caches alike); the torch side
    includes its copies in and out, with the device synchronized before
    each clock read.  Probe cost is bounded: inputs are truncated to the
    probe bucket, and each (soft, sharpness, signals, bucket) key probes
    once per process.
    """
    bucket = _row_bucket(len(values))
    key = (bool(soft), float(sharpness), values.shape[1], bucket)
    cached = _AUTO_PROBES.get(key)
    if cached is not None:
        return cached["jit_wins"]
    from tpuslo_torch.device import resolve_device, synchronize

    dev = resolve_device(device)
    sample = values[:bucket]
    sample_obs = observed[:bucket]
    lanes = (
        ("numpy", lambda: _numpy_kernel(sample, sample_obs, mats, soft, sharpness)),
        ("torch", lambda: _torch_kernel(sample, sample_obs, mats, soft, sharpness, dev)),
    )
    timings = {}
    for label, run in lanes:
        best = 1e30
        for _ in range(2):
            synchronize(dev)
            t0 = time.perf_counter()
            run()
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        timings[label] = best
    speedup = timings["numpy"] / max(timings["torch"], 1e-12)
    _AUTO_PROBES[key] = {
        "jit_wins": speedup >= JIT_WIN_MARGIN,
        "speedup": round(speedup, 3),
        "rows": bucket,
        "numpy_s": timings["numpy"],
        "torch_s": timings["torch"],
    }
    return _AUTO_PROBES[key]["jit_wins"]


def auto_report() -> dict[str, Any]:
    """The tuner's current state, for bench/debug output."""
    return {
        "min_rows": _auto_min_rows(),
        "win_margin": JIT_WIN_MARGIN,
        "probes": {
            f"rows={key[3]}": dict(result)
            for key, result in sorted(_AUTO_PROBES.items())
        },
    }


def auto_threshold() -> int | None:
    """Smallest probed row bucket where the torch lane won (None: it
    never won — auto mode stays on numpy everywhere it has measured)."""
    winners = [
        key[3] for key, result in _AUTO_PROBES.items()
        if result["jit_wins"]
    ]
    return min(winners) if winners else None


def log_posterior_batch(
    values: np.ndarray,
    observed: np.ndarray,
    mats: PosteriorMatrices,
    *,
    soft: bool,
    sharpness: float,
    use_torch: bool | None = None,
    device: str = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Posterior probabilities for a value/observation matrix pair.

    Returns ``(posteriors [n, D], weights [n, S], observed [n, S])`` —
    ``observed`` comes back because soft mode drops exact-zero
    continuous probes from the observation set.  ``device`` is where
    the torch lane runs when it is chosen.
    """
    verdict = resolve_use_torch(len(values), use_torch)
    if verdict is None:
        verdict = _probe_auto(values, observed, mats, soft, sharpness, device)
    if verdict:
        return _torch_kernel(values, observed, mats, soft, sharpness, device)
    return _numpy_kernel(values, observed, mats, soft, sharpness)
