"""Workload-identity metadata attached to probe events
(the port's own copy of ``tpuslo/signals/metadata.py``).

Reference: ``pkg/signals/metadata.go:10-118`` — a Metadata struct plus
enrichers: a static enricher for synthetic runs and a /proc-based
enricher that recovers pod/container identity from the cgroup path.  The
TPU-native build adds accelerator identity (chip, slice, host index, XLA
program) and a TPU enricher that discovers ``/dev/accel*`` and the
slice topology from the TPU-VM environment.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, replace
from typing import Protocol


@dataclass
class Metadata:
    """Identity attached to every probe event."""

    node: str = ""
    namespace: str = ""
    pod: str = ""
    container: str = ""
    pid: int = 0
    tid: int = 0
    trace_id: str = ""
    span_id: str = ""
    # TPU-native identity.
    tpu_chip: str = ""
    slice_id: str = ""
    host_index: int = 0
    xla_program_id: str = ""


class MetadataEnricher(Protocol):
    def enrich(self, meta: Metadata) -> Metadata: ...


class StaticMetadataEnricher:
    """Fills blanks from a fixed template (synthetic/agent default)."""

    def __init__(self, template: Metadata):
        self._template = template

    def enrich(self, meta: Metadata) -> Metadata:
        t = self._template
        return replace(
            meta,
            node=meta.node or t.node,
            namespace=meta.namespace or t.namespace,
            pod=meta.pod or t.pod,
            container=meta.container or t.container,
            pid=meta.pid or t.pid,
            tid=meta.tid or t.tid,
            tpu_chip=meta.tpu_chip or t.tpu_chip,
            slice_id=meta.slice_id or t.slice_id,
            host_index=meta.host_index or t.host_index,
            xla_program_id=meta.xla_program_id or t.xla_program_id,
        )


# kubepods cgroup leaf: .../kubepods<...>/pod<uid>/<container-id>
_POD_RE = re.compile(r"kubepods[^/]*/(?:[^/]+/)*pod([0-9a-f-]+)")
# Final path segment, optionally runtime-prefixed: ".../<id>",
# ".../docker-<id>.scope", ".../cri-containerd-<id>.scope".
_CONTAINER_RE = re.compile(r"(?:/|-)([0-9a-f]{12,64})(?:\.scope)?$")


class ProcMetadataEnricher:
    """Recovers pod/container identity from ``/proc/<pid>/cgroup``.

    Reference: ``pkg/signals/metadata.go:74-118``.
    """

    def __init__(self, proc_root: str = "/proc"):
        self._proc_root = proc_root

    def enrich(self, meta: Metadata) -> Metadata:
        if meta.pid <= 0 or (meta.pod and meta.container):
            return meta
        path = os.path.join(self._proc_root, str(meta.pid), "cgroup")
        try:
            content = open(path, encoding="utf-8").read()
        except OSError:
            return meta
        pod, container = parse_cgroup_identity(content)
        return replace(
            meta,
            pod=meta.pod or pod,
            container=meta.container or container,
        )


def parse_cgroup_identity(content: str) -> tuple[str, str]:
    """Extract (pod-uid, container-id) from cgroup file content."""
    pod = ""
    container = ""
    for line in content.splitlines():
        path = line.rsplit(":", 1)[-1]
        if not pod:
            m = _POD_RE.search(path)
            if m:
                pod = m.group(1)
        if not container:
            m = _CONTAINER_RE.search(path)
            if m:
                container = m.group(1)
        if pod and container:
            break
    return pod, container


class TPUMetadataEnricher:
    """Discovers accelerator identity on a TPU-VM host.

    Chip comes from the first ``/dev/accel*`` node; slice/host identity
    from the TPU-VM runtime environment (``TPU_WORKER_ID`` /
    ``MEGASCALE_SLICE_ID`` or their CLOUD_TPU equivalents).
    """

    def __init__(self, dev_glob: str = "/dev/accel*", env: dict[str, str] | None = None):
        self._dev_glob = dev_glob
        self._env = env if env is not None else dict(os.environ)

    def discover_chips(self) -> list[str]:
        return sorted(os.path.basename(p) for p in glob.glob(self._dev_glob))

    def enrich(self, meta: Metadata) -> Metadata:
        chips = self.discover_chips()
        chip = meta.tpu_chip or (chips[0] if chips else "")
        slice_id = meta.slice_id or self._env.get(
            "MEGASCALE_SLICE_ID", self._env.get("TPU_SLICE_ID", "")
        )
        host_raw = self._env.get(
            "TPU_WORKER_ID", self._env.get("CLOUD_TPU_TASK_ID", "")
        )
        try:
            host_index = int(host_raw)
        except (TypeError, ValueError):
            host_index = meta.host_index
        return replace(
            meta,
            tpu_chip=chip,
            slice_id=slice_id,
            host_index=host_index if host_raw else meta.host_index,
        )
