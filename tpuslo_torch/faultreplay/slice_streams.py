"""Deterministic per-host probe-event streams for slice correlation (the
port's own copy of ``tpuslo/faultreplay/slice_streams.py``: the same
streams from the same arguments).

Extends the faultreplay idea (``pkg/faultreplay/generator.go`` —
deterministic benchmark inputs) to the multi-host dimension the
reference lacks: synthesizes the JSONL that N per-host agents would
emit during collective launches on one pod slice, with an injected
straggler host (optionally caused by a flaky ICI link), so
``tpuslo_torch slicecorr`` and :class:`tpuslo_torch.correlation.multihost.SliceJoiner`
are testable/benchmarkable with zero hardware — the same synthetic-first
spine the rest of the toolkit runs on (SURVEY.md §0).

Straggler physics mirrored from multihost.py: the straggler *enters*
each collective late, so it observes a short wall time while every
punctual host observes base + delay.
"""

from __future__ import annotations

from typing import Any

from tpuslo_torch.signals.constants import (
    SIGNAL_ICI_COLLECTIVE_MS,
    SIGNAL_ICI_LINK_RETRIES,
)


def synthesize_slice_streams(
    n_hosts: int = 4,
    n_launches: int = 8,
    straggler_host: int = 1,
    straggler_delay_ms: float = 40.0,
    base_latency_ms: float = 8.0,
    ici_link: int = -1,
    link_retries_per_launch: float = 4.0,
    slice_id: str = "slice-0",
    program_id: str = "jit_train_step",
    start_unix_nano: int = 1_700_000_000_000_000_000,
    launch_interval_ns: int = 100_000_000,
) -> list[list[dict[str, Any]]]:
    """Per-host lists of probe-event dicts (host index = list index).

    ``ici_link >= 0`` attributes the straggle to that link: the
    straggler host additionally emits ``ici_link_retries_total`` events
    near every launch, which flips the expected cause from
    ``compute_straggler`` to ``ici_link``.
    """
    streams: list[list[dict[str, Any]]] = [[] for _ in range(n_hosts)]
    for launch in range(n_launches):
        ts = start_unix_nano + launch * launch_interval_ns
        for host in range(n_hosts):
            is_straggler = host == straggler_host
            latency = (
                base_latency_ms
                if is_straggler
                else base_latency_ms + straggler_delay_ms
            )
            # Deterministic per-host jitter, small vs the injected skew.
            latency += 0.1 * ((host * 7 + launch * 3) % 5)
            streams[host].append(
                _event(
                    signal=SIGNAL_ICI_COLLECTIVE_MS,
                    host=host,
                    value=latency,
                    unit="ms",
                    ts=ts,
                    slice_id=slice_id,
                    program_id=program_id,
                    launch_id=launch,
                )
            )
            if is_straggler and ici_link >= 0:
                streams[host].append(
                    _event(
                        signal=SIGNAL_ICI_LINK_RETRIES,
                        host=host,
                        value=link_retries_per_launch,
                        unit="count",
                        ts=ts + 1_000_000,
                        slice_id=slice_id,
                        ici_link=ici_link,
                    )
                )
    return streams


def _event(
    signal: str,
    host: int,
    value: float,
    unit: str,
    ts: int,
    slice_id: str,
    program_id: str = "",
    launch_id: int = -1,
    ici_link: int = -1,
) -> dict[str, Any]:
    tpu: dict[str, Any] = {
        "chip": "accel0",
        "slice_id": slice_id,
        "host_index": host,
    }
    if program_id:
        tpu["program_id"] = program_id
    if launch_id >= 0:
        tpu["launch_id"] = launch_id
    if ici_link >= 0:
        tpu["ici_link"] = ici_link
    return {
        "ts_unix_nano": ts,
        "signal": signal,
        "node": f"host-{host}",
        "namespace": "llm-slo",
        "pod": f"agent-{host}",
        "container": "agent",
        "pid": 1000 + host,
        "tid": 1000 + host,
        "value": round(value, 3),
        "unit": unit,
        "status": "warning",
        "tpu": tpu,
    }
