"""Seeded synthetic captures: the ledger's off-card gate input (the port's
counterpart of ``tpuslo/deviceplane/synthetic.py``).

Emits a trace document in the layout the port's parser reads (a
``torch.profiler`` / Kineto Chrome trace: ``gpu_user_annotation`` events
for the module lane, ``kernel`` events for the ops lane, a device's
index as the event ``pid``) that reproduces, deterministically, every
pathology the real captures showed:

* **steps** — the serving program's module launches, each with a launch
  number and contained kernels (the identity tier's bread and butter);
* **lane-split steps** — some steps' kernels land on a satellite device
  id that carries kernels but no module span — only the lane-window tier
  can recover these;
* **anonymous warmup launches** — module spans without a launch number
  but WITH kernels, placed right after their compile event (the
  compile-event tier's case);
* **dispatch-only helpers** — short module spans with no kernels
  anywhere, named after their owning compilation;
* **orphan helpers** — helpers with no compile-event tie and no step
  frame (trace head), the honest ``unexplained`` remainder;
* **idle gaps** — host think time between steps, plus one optional
  preemption-sized gap.

The random draws are the JAX generator's, in the same order, so the
same seed and arguments give the same span list through the port's
parser as the JAX generator's document gives through the JAX parser:
this module is the parity fixture for everything that folds spans.
The generator returns the trace document, the compile-event list, and a
ground-truth dict the tests hold the ledger to.
"""

from __future__ import annotations

import random
from typing import Any

#: The stream id every synthetic device event runs on.
_STREAM = 7

STEP_PROGRAM = "jit_frontdoor_step"
STEP_FINGERPRINT = "7421988350991137280"
WARMUP_PROGRAM = "jit_prefill_warmup"
WARMUP_FINGERPRINT = "1133557799224466880"
HELPER_NAME = "jit_frontdoor_step.convert_element_type"
ORPHAN_HELPER_NAME = "jit__unattributed_glue"


def _module(pid: int, name: str, ts: float, dur: float) -> dict[str, Any]:
    return {
        "ph": "X", "cat": "gpu_user_annotation", "pid": pid, "tid": _STREAM,
        "name": name, "ts": round(ts, 3), "dur": round(dur, 3),
    }


class _Kernels:
    """Kernel events with a running correlation id, as Kineto writes
    them (the id pairs each kernel with its launch on the host)."""

    def __init__(self) -> None:
        self.correlation = 0

    def __call__(self, pid: int, name: str, ts: float, dur: float) -> dict[str, Any]:
        self.correlation += 1
        return {
            "ph": "X", "cat": "kernel", "pid": pid, "tid": _STREAM,
            "name": name, "ts": round(ts, 3), "dur": round(dur, 3),
            "args": {"correlation": self.correlation, "device": pid,
                     "stream": _STREAM},
        }


def synthesize_xprof_trace(
    seed: int = 1337,
    steps: int = 24,
    devices: int = 1,
    lane_split_every: int = 5,
    helpers_per_step: int = 1,
    orphan_helpers: int = 2,
    warmup_launches: int = 1,
    preemption_gap_ms: float = 0.0,
    ops_per_step: int = 5,
    step_dur_us: tuple[float, float] = (1800.0, 2600.0),
) -> tuple[dict[str, Any], list[dict[str, Any]], dict[str, Any]]:
    """One seeded capture: ``(trace_doc, compile_events, truth)``.

    ``lane_split_every``: every Nth step's kernels move to the satellite
    kernels-only device id (0 disables).  ``preemption_gap_ms`` inserts
    one eviction-sized idle gap mid-capture.  ``step_dur_us`` bounds the
    per-step launch duration draw (pass decode-realistic times when the
    consumer folds a cost model over the launches).
    """
    rng = random.Random(seed)
    kernel = _Kernels()
    events: list[dict[str, Any]] = []
    compile_events: list[dict[str, Any]] = []
    truth: dict[str, Any] = {
        "steps": 0,
        "lane_split_steps": 0,
        "helpers": 0,
        "orphan_helpers": 0,
        "warmups": 0,
        "busy_us": 0.0,
        "idle_us": 0.0,
        "window_us": 0.0,
    }

    for d in range(devices):
        pid = 100 + d
        split_pid = 9000 + d  # kernels-only satellite device id

        t = 1000.0  # µs into the capture
        window_start = t
        busy = 0.0

        # Compile events precede their first executions.
        compile_events.append(
            {
                "program_id": WARMUP_FINGERPRINT,
                "module_name": WARMUP_PROGRAM,
                "end_us": t - 400.0,
                "duration_ms": 180.0,
            }
        )
        compile_events.append(
            {
                "program_id": STEP_FINGERPRINT,
                "module_name": STEP_PROGRAM,
                "end_us": t - 200.0,
                "duration_ms": 950.0,
            }
        )

        # Orphan helpers at the trace head: before any step frame, no
        # compile tie (anonymous name, no fingerprint) — these MUST
        # land in unexplained.
        for _ in range(orphan_helpers):
            dur = rng.uniform(3.0, 9.0)
            events.append(_module(pid, ORPHAN_HELPER_NAME, t, dur))
            busy += dur
            truth["orphan_helpers"] += 1
            t += dur + rng.uniform(2.0, 6.0)

        # Anonymous warmup launches WITH kernels, right after the warmup
        # compile: the compile-event tier's case.
        for _ in range(warmup_launches):
            dur = rng.uniform(400.0, 700.0)
            events.append(
                _module(pid, f"{WARMUP_PROGRAM}({WARMUP_FINGERPRINT})", t, dur)
            )
            cursor = t + 2.0
            for _ in range(3):
                op_dur = rng.uniform(20.0, 60.0)
                events.append(kernel(pid, "fusion.warmup", cursor, op_dur))
                cursor += op_dur + 1.0
            busy += dur
            truth["warmups"] += 1
            t += dur + rng.uniform(20.0, 50.0)

        for step in range(steps):
            run_id = step + 1
            dur = rng.uniform(*step_dur_us)
            events.append(
                _module(
                    pid, f"{STEP_PROGRAM}({STEP_FINGERPRINT})#{run_id}", t, dur
                )
            )
            split = bool(lane_split_every) and (
                step % lane_split_every == lane_split_every - 1
            )
            ops_pid = split_pid if split else pid
            cursor = t + 4.0
            for k in range(ops_per_step):
                op_dur = rng.uniform(40.0, 160.0)
                if cursor + op_dur > t + dur - 2.0:
                    break
                events.append(kernel(ops_pid, f"fusion.{k}", cursor, op_dur))
                cursor += op_dur + rng.uniform(1.0, 8.0)
            busy += dur
            truth["steps"] += 1
            if split:
                truth["lane_split_steps"] += 1
            t += dur

            # Dispatch-only helpers inside the step frame, named after
            # the owning compilation (compile tier catches them by
            # module-name prefix; the frame tier is the backstop).
            for _ in range(helpers_per_step):
                gap = rng.uniform(2.0, 6.0)
                t += gap
                helper_dur = rng.uniform(4.0, 14.0)
                events.append(_module(pid, HELPER_NAME, t, helper_dur))
                busy += helper_dur
                truth["helpers"] += 1
                t += helper_dur

            # Host think time between steps.
            t += rng.uniform(120.0, 420.0)
            if preemption_gap_ms > 0.0 and step == steps // 2:
                t += preemption_gap_ms * 1000.0

        # Close the device window with one final step so the window end
        # is a module span end (keeps the idle accounting independent of
        # the last host gap).
        dur = rng.uniform(*step_dur_us)
        events.append(
            _module(
                pid, f"{STEP_PROGRAM}({STEP_FINGERPRINT})#{steps + 1}", t, dur
            )
        )
        cursor = t + 4.0
        for k in range(2):
            op_dur = rng.uniform(40.0, 120.0)
            events.append(kernel(pid, f"fusion.tail{k}", cursor, op_dur))
            cursor += op_dur + 2.0
        busy += dur
        truth["steps"] += 1
        t += dur

        truth["busy_us"] += busy
        truth["window_us"] += t - window_start
        truth["idle_us"] += (t - window_start) - busy

    return {"traceEvents": events}, compile_events, truth
