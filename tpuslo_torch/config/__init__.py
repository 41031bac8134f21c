"""The port's own copy of ``tpuslo/config/__init__.py``."""

from tpuslo_torch.config.toolkitcfg import (
    CDGateConfig,
    DeliveryConfig,
    CorrelationConfig,
    IngestConfig,
    OTLPConfig,
    RuntimeConfig,
    SafetyConfig,
    SamplingConfig,
    SLOConfig,
    ToolkitConfig,
    TPUConfig,
    WebhookConfig,
    default_config,
    load_config,
)

__all__ = [
    "CDGateConfig",
    "DeliveryConfig",
    "CorrelationConfig",
    "IngestConfig",
    "OTLPConfig",
    "RuntimeConfig",
    "SafetyConfig",
    "SamplingConfig",
    "SLOConfig",
    "ToolkitConfig",
    "TPUConfig",
    "WebhookConfig",
    "default_config",
    "load_config",
]
