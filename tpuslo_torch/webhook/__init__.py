"""The port's own copy of ``tpuslo/webhook/__init__.py``."""

from tpuslo_torch.webhook.exporter import (
    FORMAT_GENERIC,
    FORMAT_OPSGENIE,
    FORMAT_PAGERDUTY,
    Exporter,
    WebhookError,
    compute_hmac,
    verify_hmac,
)
from tpuslo_torch.webhook.opsgenie import build_opsgenie_payload
from tpuslo_torch.webhook.pagerduty import build_pagerduty_payload

__all__ = [
    "FORMAT_GENERIC",
    "FORMAT_OPSGENIE",
    "FORMAT_PAGERDUTY",
    "Exporter",
    "WebhookError",
    "build_opsgenie_payload",
    "build_pagerduty_payload",
    "compute_hmac",
    "verify_hmac",
]
