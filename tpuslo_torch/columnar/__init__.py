"""Columnar event spine of the port: for now only the batched naive-Bayes
posterior (:mod:`tpuslo_torch.columnar.posterior`, the port's counterpart
of ``tpuslo/columnar/posterior.py``).  The JAX package's columnar schema,
generator, gate, matcher and serializer are not ported yet."""

from tpuslo_torch.columnar.posterior import (
    JIT_MIN_BATCH,
    JIT_PROBE_MAX_ROWS,
    JIT_WIN_MARGIN,
    PosteriorMatrices,
    auto_report,
    auto_threshold,
    log_posterior_batch,
    resolve_use_torch,
)

__all__ = [
    "JIT_MIN_BATCH",
    "JIT_PROBE_MAX_ROWS",
    "JIT_WIN_MARGIN",
    "PosteriorMatrices",
    "auto_report",
    "auto_threshold",
    "log_posterior_batch",
    "resolve_use_torch",
]
