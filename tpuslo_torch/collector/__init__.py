"""Collectors of the port: the live HBM sampler, the native ring runtime
it writes through, the deterministic synthetic samples the signal
generator expands (the port's own copies of
``tpuslo/collector/{hbm_sampler,native,ringbuf,synthetic}.py``), and the
probe manager that plans and attaches the probes against the CUDA probe
surface (``probe_manager.py``, ``symbols.py``, ``cuda_symbols.json``)."""

from tpuslo_torch.collector.probe_manager import (
    AttachReport,
    AttachResult,
    ProbeManager,
    ProbePlan,
    make_cookie,
)

__all__ = ["AttachReport", "AttachResult", "ProbeManager", "ProbePlan", "make_cookie"]
