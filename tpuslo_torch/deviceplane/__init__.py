"""Device-plane truth of the port (the counterpart of
``tpuslo/deviceplane``):

* :mod:`tpuslo_torch.deviceplane.dispatch` — the per-dispatch ledger the
  serving front door keeps on every step;
* :mod:`tpuslo_torch.deviceplane.ledger` — tiered joins over profiler
  spans folding every module launch into exactly one bucket (joined /
  helper / compile / idle-gap / unexplained), the buckets summing to
  total device time;
* :mod:`tpuslo_torch.deviceplane.roofline` — bytes/FLOP estimates folded
  into a memory- vs compute-bound verdict against the card's roofs;
* :mod:`tpuslo_torch.deviceplane.synthetic` — seeded captures in the
  layout the port's parser reads, so the ledger is held off the card;
* :mod:`tpuslo_torch.deviceplane.profiler` — the continuous profiler:
  stride-gated capture windows folded through the ledger under a
  measured-overhead governor, and its seeded sweep gate
  (``run_profiler_sweep``).
"""

from tpuslo_torch.deviceplane.dispatch import DispatchLedger
from tpuslo_torch.deviceplane.ledger import (
    BUCKET_COMPILE,
    BUCKET_HELPER,
    BUCKET_IDLE_GAP,
    BUCKET_JOINED,
    BUCKET_UNEXPLAINED,
    TIER_COMPILE_EVENT,
    TIER_FRAME,
    TIER_IDENTITY,
    TIER_LANE_WINDOW,
    CompileEvent,
    DeviceLedger,
    DeviceWindow,
    LaunchRecord,
    build_ledger,
    dispatch_count,
    dispatch_records,
)
from tpuslo_torch.deviceplane.profiler import (
    ContinuousProfiler,
    ProfilerReport,
    ProfilerWindow,
    concat_window_docs,
    run_profiler_sweep,
    seeded_cost_model,
)
from tpuslo_torch.deviceplane.roofline import (
    VERDICT_COMPUTE_BOUND,
    VERDICT_MEMORY_BOUND,
    attach_roofline,
    card_peaks,
    decode_step_cost,
    peaks_for_chip,
    roofline_verdict,
    verdict_from_ledger,
)
from tpuslo_torch.deviceplane.synthetic import synthesize_xprof_trace

__all__ = [
    "BUCKET_COMPILE",
    "BUCKET_HELPER",
    "BUCKET_IDLE_GAP",
    "BUCKET_JOINED",
    "BUCKET_UNEXPLAINED",
    "TIER_COMPILE_EVENT",
    "TIER_FRAME",
    "TIER_IDENTITY",
    "TIER_LANE_WINDOW",
    "CompileEvent",
    "ContinuousProfiler",
    "DeviceLedger",
    "DeviceWindow",
    "DispatchLedger",
    "LaunchRecord",
    "ProfilerReport",
    "ProfilerWindow",
    "VERDICT_COMPUTE_BOUND",
    "VERDICT_MEMORY_BOUND",
    "attach_roofline",
    "build_ledger",
    "card_peaks",
    "concat_window_docs",
    "decode_step_cost",
    "dispatch_count",
    "dispatch_records",
    "peaks_for_chip",
    "roofline_verdict",
    "run_profiler_sweep",
    "seeded_cost_model",
    "synthesize_xprof_trace",
    "verdict_from_ledger",
]
