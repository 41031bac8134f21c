"""JSONL IO for fault samples and attributions
(the port's own copy of ``tpuslo/attribution/io.py``).

Reference: ``pkg/attribution/io.go:12-39``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import IO, Iterable

from tpuslo_torch.attribution.mapper import FaultSample
from tpuslo_torch.schema import IncidentAttribution


def load_samples_jsonl(path: str | Path) -> list[FaultSample]:
    """Load fault samples from a JSONL file; empty files are an error."""
    samples = []
    with open(path, encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                samples.append(FaultSample.from_dict(json.loads(line)))
            except (json.JSONDecodeError, TypeError, ValueError) as exc:
                raise ValueError(f"{path}:{line_no}: bad sample: {exc}") from exc
    if not samples:
        raise ValueError(f"no samples loaded from {path}")
    return samples


def dump_samples_jsonl(samples: Iterable[FaultSample], sink: IO[str]) -> int:
    count = 0
    for sample in samples:
        sink.write(json.dumps(sample.to_dict(), separators=(",", ":")) + "\n")
        count += 1
    return count


def dump_attributions_jsonl(
    attributions: Iterable[IncidentAttribution], sink: IO[str]
) -> int:
    count = 0
    for att in attributions:
        sink.write(json.dumps(att.to_dict(), separators=(",", ":")) + "\n")
        count += 1
    return count
