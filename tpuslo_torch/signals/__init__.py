"""L2 signal modeling: registry, capability modes, synthetic profiles (the
port's own copy of ``tpuslo/signals``)."""

from tpuslo_torch.signals import constants
from tpuslo_torch.signals.constants import (
    ALL_SIGNALS,
    CAPABILITY_BCC_DEGRADED,
    CAPABILITY_CORE_FULL,
    CAPABILITY_CUDA_FULL,
    CAPABILITY_MODES,
    CAPABILITY_TPU_FULL,
    CPU_SIGNALS,
    HIGH_COST_DISABLE_ORDER,
    TPU_SIGNALS,
    disable_order,
    required_minimum_signals,
    supported_signals_for_mode,
)
from tpuslo_torch.signals.generator import (
    SIGNAL_THRESHOLDS,
    SIGNAL_UNITS,
    Generator,
    errno_for_fault,
    profile_for_fault,
    signal_status,
)
from tpuslo_torch.signals.metadata import (
    Metadata,
    MetadataEnricher,
    ProcMetadataEnricher,
    StaticMetadataEnricher,
    TPUMetadataEnricher,
    parse_cgroup_identity,
)
from tpuslo_torch.signals.mode import (
    detect_capability_mode,
    find_libtpu,
    has_btf,
    has_tpu_surface,
    parse_capability_mode,
)

__all__ = [
    "constants",
    "ALL_SIGNALS",
    "CAPABILITY_BCC_DEGRADED",
    "CAPABILITY_CORE_FULL",
    "CAPABILITY_CUDA_FULL",
    "CAPABILITY_MODES",
    "CAPABILITY_TPU_FULL",
    "CPU_SIGNALS",
    "HIGH_COST_DISABLE_ORDER",
    "TPU_SIGNALS",
    "SIGNAL_THRESHOLDS",
    "SIGNAL_UNITS",
    "Generator",
    "Metadata",
    "MetadataEnricher",
    "ProcMetadataEnricher",
    "StaticMetadataEnricher",
    "TPUMetadataEnricher",
    "detect_capability_mode",
    "disable_order",
    "errno_for_fault",
    "find_libtpu",
    "has_btf",
    "has_tpu_surface",
    "parse_capability_mode",
    "parse_cgroup_identity",
    "profile_for_fault",
    "required_minimum_signals",
    "signal_status",
    "supported_signals_for_mode",
]
