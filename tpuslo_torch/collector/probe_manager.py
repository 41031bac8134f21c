"""Probe lifecycle: plan -> attach -> consume -> shed (the port's copy of
``tpuslo/collector/probe_manager.py``, planning against the CUDA probe
surface).

Each device signal first resolves its attach target through the CUDA
manifest (``cuda_symbols.json`` beside this module, read with
:mod:`json`) and :mod:`tpuslo_torch.collector.symbols`: uprobes on the
driver's ``libcuda.so`` and on NCCL, a kprobe pair on the nvidia
driver's ioctl entry; a signal with no source on one card is left
unplanned with its reason.  The kernel, TLS, derived and sampler
signals plan as the JAX manager plans them.  The native runtime
(``native/probe_manager.cc``, through
:mod:`tpuslo_torch.collector.native`) loads the generic BPF objects from
``ebpf/build`` and attaches them; this class decides what to attach and
when to shed, over the port's :class:`~tpuslo_torch.safety.OverheadGuard`.
One BPF object instance is loaded per signal, so shedding one signal
detaches exactly one object and its ring.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from tpuslo_torch.collector import native, symbols
from tpuslo_torch.safety import OverheadGuard
from tpuslo_torch.signals import constants as sig

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT_OBJ_DIR = _REPO_ROOT / "ebpf" / "build"
DEFAULT_MANIFEST = Path(__file__).resolve().parent / "cuda_symbols.json"

#: Signal id mapping for attach cookies (mirror of tpuslo_event.h).
SIGNAL_IDS = {
    sig.SIGNAL_DNS_LATENCY_MS: native.SIG_DNS_LATENCY,
    sig.SIGNAL_TCP_RETRANSMITS: native.SIG_TCP_RETRANSMIT,
    sig.SIGNAL_RUNQUEUE_DELAY_MS: native.SIG_RUNQ_DELAY,
    sig.SIGNAL_CONNECT_LATENCY_MS: native.SIG_CONNECT_LATENCY,
    sig.SIGNAL_TLS_HANDSHAKE_MS: native.SIG_TLS_HANDSHAKE,
    sig.SIGNAL_CPU_STEAL_PCT: native.SIG_CPU_STEAL,
    sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: native.SIG_MEM_RECLAIM,
    sig.SIGNAL_DISK_IO_LATENCY_MS: native.SIG_DISK_IO,
    sig.SIGNAL_SYSCALL_LATENCY_MS: native.SIG_SYSCALL_LATENCY,
    sig.SIGNAL_XLA_COMPILE_MS: native.SIG_XLA_COMPILE,
    sig.SIGNAL_HBM_ALLOC_STALL_MS: native.SIG_HBM_ALLOC_STALL,
    sig.SIGNAL_HBM_UTILIZATION_PCT: native.SIG_HBM_UTILIZATION,
    sig.SIGNAL_ICI_LINK_RETRIES: native.SIG_ICI_LINK_RETRY,
    sig.SIGNAL_ICI_COLLECTIVE_MS: native.SIG_ICI_COLLECTIVE,
    sig.SIGNAL_HOST_OFFLOAD_STALL_MS: native.SIG_HOST_OFFLOAD,
    sig.SIGNAL_DCN_TRANSFER_MS: native.SIG_DCN_TRANSFER,
}

#: Kernel-signal object files (attach-auto via their SEC definitions).
_KERNEL_OBJECTS = {
    sig.SIGNAL_DNS_LATENCY_MS: "dns_latency.bpf.o",
    sig.SIGNAL_TCP_RETRANSMITS: "tcp_retransmit.bpf.o",
    sig.SIGNAL_RUNQUEUE_DELAY_MS: "runqueue_delay.bpf.o",
    sig.SIGNAL_CONNECT_LATENCY_MS: "connect_latency.bpf.o",
    sig.SIGNAL_CPU_STEAL_PCT: "cpu_steal.bpf.o",
    sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: "mem_reclaim.bpf.o",
    sig.SIGNAL_DISK_IO_LATENCY_MS: "disk_io_latency.bpf.o",
    sig.SIGNAL_SYSCALL_LATENCY_MS: "syscall_latency.bpf.o",
}

#: Derived signals ride their parent probe; they never attach alone.
DERIVED_SIGNALS = {
    sig.SIGNAL_CONNECT_ERRORS: sig.SIGNAL_CONNECT_LATENCY_MS,
    sig.SIGNAL_TLS_HANDSHAKE_FAILS: sig.SIGNAL_TLS_HANDSHAKE_MS,
    # CFS throttling is sampled from cgroupfs, not probed.
    sig.SIGNAL_CFS_THROTTLED_MS: "",
}


@dataclass
class ProbePlan:
    """Resolved attach plan for one signal."""

    signal: str
    object_file: str = ""
    kind: str = "auto"          # auto | uprobe_span | uprobe_counter |
    #                             kprobe_pair | sampler | none
    target_binary: str = ""
    symbol: str = ""
    file_offset: int = 0
    cookie: int = 0
    status: str = "planned"     # planned | no_symbol | no_object | sampler |
    #                             unplanned
    detail: str = ""


@dataclass
class AttachResult:
    signal: str
    attached: bool
    status: str
    detail: str = ""
    symbol: str = ""


@dataclass
class AttachReport:
    results: list[AttachResult] = field(default_factory=list)

    @property
    def attached_signals(self) -> list[str]:
        return [r.signal for r in self.results if r.attached]

    def to_dict(self) -> dict:
        return {
            "attached": self.attached_signals,
            "results": [
                {
                    "signal": r.signal,
                    "attached": r.attached,
                    "status": r.status,
                    "detail": r.detail,
                    "symbol": r.symbol,
                }
                for r in self.results
            ],
        }


def _load_manifest(path: Path) -> dict:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except OSError:
        return {}


def make_cookie(signal: str, symbol: str) -> int:
    """cookie = signal_id<<48 | 48-bit symbol fingerprint (see
    ebpf/c/libtpu_uprobes.bpf.c)."""
    return (SIGNAL_IDS[signal] << 48) | symbols.fingerprint(symbol)


class ProbeManager:
    """Plans and drives real-probe attachment with cost-ordered shed."""

    def __init__(
        self,
        obj_dir: str | os.PathLike = DEFAULT_OBJ_DIR,
        manifest_path: str | os.PathLike = DEFAULT_MANIFEST,
        guard: OverheadGuard | None = None,
        disable_order: list[str] | None = None,
    ):
        self._obj_dir = Path(obj_dir)
        self._manifest = _load_manifest(Path(manifest_path))
        self._guard = guard
        self._disable_order = list(
            disable_order if disable_order is not None else sig.disable_order()
        )
        self._lib = None
        self._pm = None
        self._attached: dict[str, str] = {}  # signal -> object handle name
        self._shed: list[str] = []  # guard-shed signals, shed order

    # ---- availability ------------------------------------------------

    @staticmethod
    def available() -> bool:
        """True when the native runtime AND libbpf are loadable."""
        if not native.runtime_available():
            return False
        return bool(native.load_runtime().tpuslo_pm_available())

    # ---- planning ----------------------------------------------------

    def plan(self, signal_names: list[str]) -> list[ProbePlan]:
        plans: list[ProbePlan] = []
        manifest_signals = self._manifest.get("signals", {})
        libraries = self.libraries()

        for name in signal_names:
            if name in DERIVED_SIGNALS:
                parent = DERIVED_SIGNALS[name]
                plans.append(
                    ProbePlan(
                        signal=name,
                        kind="none",
                        status="planned" if parent else "sampler",
                        detail=f"derived from {parent}" if parent
                        else "sampled from cgroupfs",
                    )
                )
                continue
            if name == sig.SIGNAL_HBM_UTILIZATION_PCT:
                plans.append(
                    ProbePlan(
                        signal=name,
                        kind="sampler",
                        status="sampler",
                        detail="sampled from device runtime stats "
                        "(tpuslo_torch/collector/hbm_sampler.py)",
                    )
                )
                continue
            if name in (
                sig.SIGNAL_DEVICE_IDLE_GAP_MS,
                sig.SIGNAL_DEVICE_EVICTION_EVENTS,
            ):
                plans.append(
                    ProbePlan(
                        signal=name,
                        kind="sampler",
                        status="sampler",
                        detail="sampled from the device-plane ledger "
                        "(tpuslo_torch/deviceplane/ledger.py)",
                    )
                )
                continue
            if name in (
                sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE,
                sig.SIGNAL_DEVICE_MFU_PCT,
            ):
                plans.append(
                    ProbePlan(
                        signal=name,
                        kind="sampler",
                        status="sampler",
                        detail="sampled per capture window by the "
                        "continuous profiler "
                        "(tpuslo_torch/deviceplane/profiler.py)",
                    )
                )
                continue
            if name in _KERNEL_OBJECTS:
                obj = _KERNEL_OBJECTS[name]
                plan = ProbePlan(signal=name, object_file=obj, kind="auto")
                if not (self._obj_dir / obj).exists():
                    plan.status = "no_object"
                    plan.detail = f"{obj} not built (run ebpf/gen.sh)"
                plans.append(plan)
                continue
            if name == sig.SIGNAL_TLS_HANDSHAKE_MS:
                plans.append(self._plan_tls())
                continue
            # Remaining: the device signals, from the CUDA manifest.
            spec = manifest_signals.get(name, {})
            plans.append(self._plan_cuda(name, spec, libraries))
        return plans

    def libraries(self) -> dict[str, str | None]:
        """The manifest's libraries, located: ``{"libcuda": path or None,
        "nccl": path or None}``."""
        finders = {"libcuda": symbols.find_libcuda, "nccl": symbols.find_nccl}
        return {name: finders[name]() for name in self._manifest.get("library", {})
                if name in finders}

    def _plan_tls(self) -> ProbePlan:
        plan = ProbePlan(
            signal=sig.SIGNAL_TLS_HANDSHAKE_MS,
            object_file="tls_handshake.bpf.o",
            kind="uprobe_span",
        )
        tls_lib = symbols.find_tls_library()
        if tls_lib is None:
            plan.status = "no_symbol"
            plan.detail = "no TLS library found"
            return plan
        resolved = symbols.resolve_elf_symbol(
            tls_lib, ["SSL_do_handshake", "SSL_connect", "gnutls_handshake"]
        )
        if resolved is None:
            plan.status = "no_symbol"
            plan.detail = f"no handshake symbol in {tls_lib}"
            return plan
        plan.target_binary = tls_lib
        plan.symbol = resolved.name
        plan.file_offset = resolved.file_offset
        plan.cookie = make_cookie(plan.signal, resolved.name)
        if not (self._obj_dir / plan.object_file).exists():
            plan.status = "no_object"
            plan.detail = f"{plan.object_file} not built"
        return plan

    def _plan_cuda(
        self, name: str, spec: dict, libraries: dict[str, str | None]
    ) -> ProbePlan:
        kind = spec.get("kind", "span")
        candidates = list(spec.get("candidates", []))
        if spec.get("unplanned") or not (candidates or kind == "kprobe_ioctl"):
            return ProbePlan(
                signal=name, kind="none", status="unplanned",
                detail=spec.get("unplanned", "no CUDA source in the manifest"),
            )
        if kind == "kprobe_ioctl":
            plan = ProbePlan(
                signal=name, object_file="accel_ioctl.bpf.o",
                kind="kprobe_pair",
            )
            symbol = symbols.resolve_kernel_symbol(candidates)
            if symbol is None:
                plan.status = "no_symbol"
                plan.detail = "no nvidia ioctl symbol in kallsyms"
                return plan
            plan.symbol = symbol
        else:
            plan = ProbePlan(
                signal=name,
                object_file="libtpu_uprobes.bpf.o",
                kind="uprobe_span" if kind == "span" else "uprobe_counter",
            )
            lib_name = spec.get("library", "libcuda")
            lib = libraries.get(lib_name)
            if lib is None:
                plan.status = "no_symbol"
                plan.detail = f"{lib_name} library not found"
                return plan
            plan.target_binary = lib
            resolved = symbols.resolve_elf_symbol(lib, candidates)
            if resolved is None:
                plan.status = "no_symbol"
                plan.detail = f"no candidate symbol in {lib}"
                return plan
            plan.symbol = resolved.name
            plan.file_offset = resolved.file_offset
            plan.cookie = make_cookie(name, resolved.name)
        if not (self._obj_dir / plan.object_file).exists():
            plan.status = "no_object"
            plan.detail = f"{plan.object_file} not built"
        return plan

    # ---- attachment --------------------------------------------------

    def _ensure_native(self):
        if self._pm is None:
            self._lib = native.load_runtime()
            self._pm = self._lib.tpuslo_pm_new()
        return self._pm

    def attach_all(self, signal_names: list[str]) -> AttachReport:
        report = AttachReport()
        if not self.available():
            for name in signal_names:
                report.results.append(
                    AttachResult(
                        signal=name, attached=False, status="unavailable",
                        detail="native runtime or libbpf unavailable",
                    )
                )
            return report

        pm = self._ensure_native()
        for plan in self.plan(signal_names):
            report.results.append(self._attach_one(pm, plan))
        return report

    def _attach_one(self, pm, plan: ProbePlan) -> AttachResult:
        if plan.kind in ("none", "sampler") or plan.status in (
            "no_object", "no_symbol", "sampler", "unplanned",
        ):
            return AttachResult(
                signal=plan.signal,
                attached=plan.kind == "none" and plan.status == "planned",
                status=plan.status,
                detail=plan.detail,
            )
        handle = f"{plan.object_file}:{plan.signal}"
        obj_path = str(self._obj_dir / plan.object_file)
        rc = self._lib.tpuslo_pm_load(pm, handle.encode(), obj_path.encode())
        if rc != 0:
            return AttachResult(
                signal=plan.signal, attached=False, status="load_failed",
                detail=self._lib.tpuslo_pm_last_error(pm).decode(),
            )
        ok = True
        detail = ""
        if plan.kind == "auto":
            n = self._lib.tpuslo_pm_attach_auto(pm, handle.encode())
            ok = n > 0
            detail = f"attached {n} programs"
        elif plan.kind == "kprobe_pair":
            rc1 = self._lib.tpuslo_pm_attach_kprobe(
                pm, handle.encode(), b"accel_ioctl_begin",
                plan.symbol.encode(), 0,
            )
            rc2 = self._lib.tpuslo_pm_attach_kprobe(
                pm, handle.encode(), b"accel_ioctl_done",
                plan.symbol.encode(), 1,
            )
            ok = rc1 == 0 and rc2 == 0
        elif plan.kind == "uprobe_span":
            begin = (
                b"tpu_span_begin"
                if plan.object_file.startswith("libtpu")
                else b"tls_handshake_begin"
            )
            end = (
                b"tpu_span_end"
                if plan.object_file.startswith("libtpu")
                else b"tls_handshake_done"
            )
            rc1 = self._lib.tpuslo_pm_attach_uprobe(
                pm, handle.encode(), begin, plan.target_binary.encode(),
                plan.file_offset, 0, plan.cookie,
            )
            rc2 = self._lib.tpuslo_pm_attach_uprobe(
                pm, handle.encode(), end, plan.target_binary.encode(),
                plan.file_offset, 1, plan.cookie,
            )
            ok = rc1 == 0 and rc2 == 0
        elif plan.kind == "uprobe_counter":
            rc1 = self._lib.tpuslo_pm_attach_uprobe(
                pm, handle.encode(), b"tpu_counter_hit",
                plan.target_binary.encode(), plan.file_offset, 0,
                plan.cookie,
            )
            ok = rc1 == 0
        if not ok:
            detail = self._lib.tpuslo_pm_last_error(pm).decode()
            self._lib.tpuslo_pm_detach_object(pm, handle.encode())
            return AttachResult(
                signal=plan.signal, attached=False, status="attach_failed",
                detail=detail, symbol=plan.symbol,
            )
        self._attached[plan.signal] = handle
        return AttachResult(
            signal=plan.signal, attached=True, status="attached",
            detail=detail, symbol=plan.symbol,
        )

    # ---- consumption -------------------------------------------------

    def ringbuf_fds(self) -> list[int]:
        """Ring map fds of every attached object (for the consumer)."""
        if self._pm is None:
            return []
        fds = []
        for handle in set(self._attached.values()):
            fd = self._lib.tpuslo_pm_ringbuf_fd(self._pm, handle.encode())
            if fd >= 0:
                fds.append(fd)
        return fds

    # ---- shedding ----------------------------------------------------

    @property
    def attached_signals(self) -> list[str]:
        return list(self._attached)

    def detach_signal(self, signal: str) -> bool:
        handle = self._attached.pop(signal, None)
        if handle is None or self._pm is None:
            return False
        if handle in self._attached.values():
            return True  # another signal still rides this object
        return self._lib.tpuslo_pm_detach_object(
            self._pm, handle.encode()
        ) >= 0

    def shed_highest_cost(self) -> str | None:
        """Detach the most expensive attached signal (disable order)."""
        for candidate in self._disable_order:
            if candidate in self._attached:
                self.detach_signal(candidate)
                self._shed.append(candidate)
                return candidate
        return None

    @property
    def shed_signals(self) -> list[str]:
        """Guard-shed signals awaiting restore, in shed order."""
        return list(self._shed)

    def import_shed(self, signals: list[str]) -> list[str]:
        """Adopt a restored shed list (oldest-shed first).

        Attached signals are detached (the previous incarnation shed
        them for a reason that survives the restart); signals that
        never attached this run are still recorded so ``restore_one``
        retries them in reverse cost order once recovery authorizes it.
        """
        imported: list[str] = []
        for signal in signals:
            if signal in self._shed:
                continue
            if signal in self._attached:
                self.detach_signal(signal)
            self._shed.append(signal)
            imported.append(signal)
        return imported

    def restore_signal(self, signal: str) -> bool:
        """Re-attach one specific shed signal (remediation rollback).

        Like :meth:`restore_one`, a failed re-attach keeps the signal
        on the shed list for a later retry; unlike it, this never
        touches any other shed entry.
        """
        if signal not in self._shed:
            return False
        if signal in self._attached:
            self._shed.remove(signal)  # already back (external attach)
            return True
        report = self.attach_all([signal])
        if signal in report.attached_signals:
            self._shed.remove(signal)
            return True
        return False

    def restore_one(self) -> str | None:
        """Re-attach the most recently shed signal (reverse cost order).

        A failed re-attach (symbols vanished, privileges dropped) keeps
        the signal on the shed list so a later recovery window retries
        it; returns the restored signal or None.
        """
        while self._shed:
            signal = self._shed[-1]
            if signal in self._attached:
                self._shed.pop()  # already back (external attach)
                continue
            report = self.attach_all([signal])
            if signal in report.attached_signals:
                self._shed.pop()
                return signal
            return None
        return None

    def check_overhead(self) -> str | None:
        """Evaluate the guard; shed the highest-cost attached signal on
        breach.  Returns the shed signal, or None."""
        if self._guard is None:
            return None
        decision = self._guard.evaluate()
        if not (decision.valid and decision.over_budget):
            return None
        return self.shed_highest_cost()

    def detach_all(self) -> None:
        for signal in list(self._attached):
            self.detach_signal(signal)
