"""Real HBM-pressure injector (the port of
``scripts/chaos/injectors/hbm_pressure.py``, same flags and report keys).

Allocates live device buffers (``--chunk-mb`` int8 chunks, zero-filled
and synchronised) until the requested fraction of the card's memory is
held, then sits on them for the fault window.  Co-located serving
traffic sees allocator stalls and OOM retries; the expected witnesses
are a card-wide free-memory reading (``torch.cuda.mem_get_info()`` in
another process) and the serving engines' own allocation stalls.  The
port's HBM sampler reads its own process's ``memory_allocated()``, as
JAX's reads its process's ``bytes_in_use``, so it does not see a
squatter in another process.

The limit is the card's total memory (``mem_get_info()``'s total, JAX's
``bytes_limit``).  The starting point is the card's use, ``total -
free``: on the TPU one process owns the chip, so JAX's ``bytes_in_use``
is the chip's use, while a GPU may be shared by other processes (and
this one's CUDA context), so the card-wide figure answers to it.  The
report adds that starting point (``start_bytes_in_use``) and the card's
name.  Deterministic: allocation sizes derive from the card's reported
memory, not timing.

Without a card that answers it exits 2 with a ``"real": false`` report;
with ``--device cpu`` it exits 2 as JAX's CPU device does ("device
reports no memory stats": the CPU has no device memory to squat).

Usage: python -m tpuslo_torch.chaos.injectors.hbm_pressure
           [--fraction 0.85] [--hold-s 60] [--chunk-mb 256] [--report out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fraction", type=float, default=0.85)
    p.add_argument("--hold-s", type=float, default=60.0)
    p.add_argument("--chunk-mb", type=int, default=256)
    p.add_argument("--report", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    if args.device == "cpu":
        print(json.dumps({
            "injector": "hbm_pressure", "real": False,
            "reason": "device reports no memory stats",
        }))
        return 2
    from tpuslo_torch.chaos.backend_guard import fail_fast_report

    guard = fail_fast_report("hbm_pressure", args.report)
    if guard is not None:
        print(json.dumps(guard))
        return 2

    import torch

    from tpuslo_torch.device import resolve_device

    device = resolve_device(args.device)
    free, limit = torch.cuda.mem_get_info(device)
    target = int(limit * args.fraction)
    chunk_bytes = args.chunk_mb * 1024 * 1024  # 1 byte per int8 element
    held = []
    start = held_bytes = int(limit - free)
    while held_bytes < target:
        held.append(torch.zeros((chunk_bytes,), dtype=torch.int8, device=device))
        torch.cuda.synchronize(device)
        held_bytes += chunk_bytes

    report = {
        "injector": "hbm_pressure",
        "real": True,
        "backend": "cuda",
        "device_name": torch.cuda.get_device_name(device),
        "bytes_limit": int(limit),
        "start_bytes_in_use": start,
        "held_bytes": held_bytes,
        "fraction": round(held_bytes / limit, 4),
        "hold_s": args.hold_s,
    }
    # Flushed: a witness reads the report while the chunks are held.
    print(json.dumps(report), flush=True)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    time.sleep(args.hold_s)
    del held
    return 0


if __name__ == "__main__":
    sys.exit(main())
