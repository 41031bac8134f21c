"""L6 resilient delivery: queue + spool + breaker + replay per sink.

Telemetry must survive exactly the incidents it attributes: every
network sink (OTLP logs, incident webhook) routes through a
:class:`DeliveryChannel` so a collector outage degrades to disk
spooling instead of dropped evidence, and recovery replays the outage
window.  :mod:`tpuslo.delivery.faultsink` is the matching chaos
harness.

The port's own copy of ``tpuslo/delivery/__init__.py``.
"""

from tpuslo_torch.delivery.breaker import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    STATE_VALUES,
    CircuitBreaker,
)
from tpuslo_torch.delivery.channel import (
    DeliveryChannel,
    DeliveryObserver,
    Sink,
    SinkError,
    full_jitter_delay,
)
from tpuslo_torch.delivery.options import DeliveryOptions
from tpuslo_torch.delivery.spool import DiskSpool

__all__ = [
    "STATE_CLOSED",
    "STATE_HALF_OPEN",
    "STATE_OPEN",
    "STATE_VALUES",
    "CircuitBreaker",
    "DeliveryChannel",
    "DeliveryObserver",
    "DeliveryOptions",
    "DiskSpool",
    "Sink",
    "SinkError",
    "full_jitter_delay",
]
