"""Collectors of the port: the synthetic spine and its SLO normalization
(``pipeline.py``, ``synthetic.py``), the live HBM sampler, the native
ring runtime it writes through and the agent's ring consumer
(``hbm_sampler.py``, ``native.py``, ``ringbuf.py``), the hello tracer,
the probe-privilege smoke check (``hello_tracer.py``, ``kernel.py``) and
the probe manager that plans and attaches the probes against the CUDA
probe surface (``probe_manager.py``, ``symbols.py``,
``cuda_symbols.json``): the port's own copies of ``tpuslo/collector``.
Importing the package loads no ``torch`` and no native library."""

from tpuslo_torch.collector.pipeline import (
    ERROR_RATE_THRESHOLDS,
    LATENCY_THRESHOLDS,
    THROUGHPUT_THRESHOLDS,
    TTFT_THRESHOLDS,
    inverse_threshold_status,
    normalize_sample,
    threshold_status,
)
from tpuslo_torch.collector.probe_manager import (
    AttachReport,
    AttachResult,
    ProbeManager,
    ProbePlan,
    make_cookie,
)
from tpuslo_torch.collector.synthetic import (
    RawSample,
    SampleMeta,
    build_synthetic_sample,
    generate_synthetic_samples,
    supported_fault_labels,
    supported_synthetic_scenarios,
)

__all__ = [
    "AttachReport",
    "AttachResult",
    "ERROR_RATE_THRESHOLDS",
    "LATENCY_THRESHOLDS",
    "ProbeManager",
    "ProbePlan",
    "THROUGHPUT_THRESHOLDS",
    "TTFT_THRESHOLDS",
    "RawSample",
    "SampleMeta",
    "build_synthetic_sample",
    "generate_synthetic_samples",
    "inverse_threshold_status",
    "make_cookie",
    "normalize_sample",
    "supported_fault_labels",
    "supported_synthetic_scenarios",
    "threshold_status",
]
