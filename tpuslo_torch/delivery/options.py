"""Delivery tuning knobs shared by config, CLI flags, and EventWriters.

The port's own copy of ``tpuslo/delivery/options.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from tpuslo_torch.delivery.breaker import CircuitBreaker
from tpuslo_torch.delivery.channel import DeliveryChannel, DeliveryObserver, Sink


@dataclass
class DeliveryOptions:
    """Everything needed to build per-sink channels.

    ``spool_dir`` doubles as the enable switch: delivery stays fully
    synchronous (legacy behavior) until an operator points the agent at
    a spool directory.
    """

    spool_dir: str = ""
    queue_max: int = 512
    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    breaker_failure_threshold: int = 5
    breaker_open_duration_s: float = 10.0
    segment_max_bytes: int = 256 * 1024
    spool_max_bytes: int = 64 * 1024 * 1024
    spool_max_age_s: float = 24 * 3600.0
    replay_interval_s: float = 0.5

    @property
    def enabled(self) -> bool:
        return bool(self.spool_dir)

    @classmethod
    def from_config(cls, cfg: object, spool_dir: str = "") -> "DeliveryOptions":
        """Build options from a config section (e.g.
        :class:`tpuslo.config.DeliveryConfig`) by shared field name, so
        a knob added to both dataclasses wires itself without a third
        hand-written copy at the call site."""
        kwargs = {
            f.name: getattr(cfg, f.name)
            for f in fields(cls)
            if hasattr(cfg, f.name)
        }
        if spool_dir:
            kwargs["spool_dir"] = spool_dir
        return cls(**kwargs)

    def build_channel(
        self,
        name: str,
        sink: Sink,
        observer: DeliveryObserver | None = None,
        start_worker: bool = True,
    ) -> DeliveryChannel:
        observer = observer or DeliveryObserver()
        return DeliveryChannel(
            name,
            sink,
            self.spool_dir,
            queue_max=self.queue_max,
            max_attempts=self.max_attempts,
            base_delay_s=self.base_delay_s,
            max_delay_s=self.max_delay_s,
            breaker=CircuitBreaker(
                failure_threshold=self.breaker_failure_threshold,
                open_duration_s=self.breaker_open_duration_s,
                on_state_change=observer.breaker_state,
            ),
            observer=observer,
            segment_max_bytes=self.segment_max_bytes,
            spool_max_bytes=self.spool_max_bytes,
            spool_max_age_s=self.spool_max_age_s,
            replay_interval_s=self.replay_interval_s,
            start_worker=start_worker,
        )
