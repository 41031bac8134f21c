"""The CUDA probe surface: ``tpuslo_torch.collector.probe_manager`` and
``symbols`` beside ``tpuslo/collector``'s.

Each test of ``tests/test_probe_manager.py`` runs here on the port: the
manifest contract (JSON, the CUDA candidates), cookies (equal to the JAX
manager's for the same signal and symbol), ELF and kallsyms resolution
(the same answers as the JAX resolver), planning without objects or
privileges, and cost-ordered shed and restore.  Then what is the port's
own: a synthetic kallsyms with the nvidia driver's ioctl entry plans the
ioctl kprobe, the signals with no source on one card stay unplanned with
their reason, the libraries are found where a process maps them, and
neither the collector nor the prereq package imports ``yaml``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from dataclasses import astuple
from pathlib import Path

import pytest

from tpuslo.collector import probe_manager as jpm
from tpuslo.collector import symbols as jsymbols
from tpuslo_torch.collector import symbols
from tpuslo_torch.collector.probe_manager import (
    DEFAULT_MANIFEST,
    SIGNAL_IDS,
    AttachReport,
    AttachResult,
    ProbeManager,
    make_cookie,
)
from tpuslo_torch.safety import OverheadResult
from tpuslo_torch.signals import constants as sig

REPO = Path(__file__).resolve().parent.parent
CUDA_SIGNALS = ("xla_compile_ms", "hbm_alloc_stall_ms", "ici_collective_latency_ms",
                "host_offload_stall_ms")


def _libc() -> Path:
    candidates = [
        p
        for base in ("/lib", "/usr/lib", "/lib/x86_64-linux-gnu",
                     "/usr/lib/x86_64-linux-gnu", "/lib/aarch64-linux-gnu")
        for p in Path(base).glob("libc.so.6")
        if p.exists()
    ]
    if not candidates:
        pytest.skip("libc.so.6 not found on disk")
    return candidates[0]


def test_manifest_parses_and_covers_the_device_signals():
    manifest = json.loads(DEFAULT_MANIFEST.read_text())
    assert set(manifest["signals"]) == {
        "xla_compile_ms",
        "hbm_alloc_stall_ms",
        "ici_collective_latency_ms",
        "ici_link_retries_total",
        "host_offload_stall_ms",
        "dcn_transfer_latency_ms",
    }
    for name, spec in manifest["signals"].items():
        assert spec["kind"] in ("span", "counter", "kprobe_ioctl")
        assert bool(spec.get("candidates")) != bool(spec.get("unplanned")), name
        if spec["kind"] in ("span", "counter") and spec.get("candidates"):
            assert spec["library"] in manifest["library"]
    assert manifest["signals"]["hbm_alloc_stall_ms"]["library"] == "libcuda"
    assert manifest["signals"]["ici_collective_latency_ms"]["library"] == "nccl"


def test_cookie_encodes_signal_id():
    cookie = make_cookie(sig.SIGNAL_XLA_COMPILE_MS, "cuGraphInstantiateWithFlags")
    assert cookie >> 48 == SIGNAL_IDS[sig.SIGNAL_XLA_COMPILE_MS]
    assert cookie == make_cookie(sig.SIGNAL_XLA_COMPILE_MS, "cuGraphInstantiateWithFlags")
    assert cookie != make_cookie(sig.SIGNAL_XLA_COMPILE_MS, "OtherSymbol")
    # The same cookie the JAX manager gives: the BPF consumer decodes both.
    assert cookie == jpm.make_cookie(sig.SIGNAL_XLA_COMPILE_MS, "cuGraphInstantiateWithFlags")
    assert SIGNAL_IDS == jpm.SIGNAL_IDS


def test_elf_symbol_resolution_against_libc():
    path = _libc()
    resolved = symbols.resolve_elf_symbol(str(path), ["getaddrinfo"])
    assert resolved is not None
    assert "getaddrinfo" in resolved.name.lower()
    assert resolved.file_offset > 0
    want = jsymbols.resolve_elf_symbol(str(path), ["getaddrinfo"])
    assert astuple(resolved) == astuple(want)


def test_elf_resolution_pattern_priority():
    path = _libc()
    resolved = symbols.resolve_elf_symbol(str(path), ["no_such_symbol_xyz", "malloc"])
    assert resolved is not None
    assert "malloc" in resolved.name.lower()
    assert ([astuple(s) for s in symbols.elf_function_symbols(path)]
            == [astuple(s) for s in jsymbols.elf_function_symbols(path)])


def test_kernel_symbol_resolution(tmp_path):
    kallsyms = tmp_path / "kallsyms"
    kallsyms.write_text(
        "0000000000000000 t some_private_fn\n"
        "0000000000000000 T vfio_device_fops_unl_ioctl\n"
        "0000000000000000 D some_data\n"
    )
    hit = symbols.resolve_kernel_symbol(
        ["accel_ioctl", "vfio_device_fops_unl_ioctl"], str(kallsyms)
    )
    assert hit == "vfio_device_fops_unl_ioctl"
    assert symbols.resolve_kernel_symbol(["nope"], str(kallsyms)) is None


def test_plan_reports_missing_objects_and_symbols(tmp_path):
    pm = ProbeManager(obj_dir=tmp_path)  # empty: nothing built
    plans = {p.signal: p for p in pm.plan(list(sig.supported_signals_for_mode("cuda_full")))}
    assert len(plans) == len(sig.ALL_SIGNALS)
    assert plans[sig.SIGNAL_DNS_LATENCY_MS].status == "no_object"
    assert plans[sig.SIGNAL_HBM_UTILIZATION_PCT].kind == "sampler"
    assert "tpuslo_torch/collector/hbm_sampler.py" in plans[sig.SIGNAL_HBM_UTILIZATION_PCT].detail
    assert plans[sig.SIGNAL_CONNECT_ERRORS].kind == "none"
    assert "connect_latency_ms" in plans[sig.SIGNAL_CONNECT_ERRORS].detail
    # No card here: no libcuda -> no_symbol (or no_object where one is found).
    assert plans[sig.SIGNAL_XLA_COMPILE_MS].status in ("no_symbol", "no_object")
    assert plans[sig.SIGNAL_ICI_LINK_RETRIES].status == "unplanned"
    assert plans[sig.SIGNAL_DCN_TRANSFER_MS].status == "unplanned"


def test_attach_all_reports_unavailable_without_privileges(tmp_path):
    pm = ProbeManager(obj_dir=tmp_path)
    report = pm.attach_all([sig.SIGNAL_DNS_LATENCY_MS])
    assert len(report.results) == 1
    result = report.results[0]
    assert not result.attached or result.status == "attached"
    payload = report.to_dict()
    assert "attached" in payload and "results" in payload


def test_shed_order_prefers_device_probes():
    order = sig.disable_order()
    tpu_positions = [order.index(s) for s in sig.TPU_SIGNALS]
    cpu_positions = [order.index(s) for s in sig.CPU_SIGNALS]
    assert max(tpu_positions) < min(cpu_positions)


class _TrippedGuard:
    def evaluate(self):
        return OverheadResult(cpu_pct=9.0, budget_pct=3.0, over_budget=True, valid=True)


def test_check_overhead_sheds_in_cost_order(tmp_path):
    pm = ProbeManager(obj_dir=tmp_path, guard=_TrippedGuard())
    pm._attached = {sig.SIGNAL_DNS_LATENCY_MS: "h1", sig.SIGNAL_ICI_COLLECTIVE_MS: "h2"}
    assert pm.check_overhead() == sig.SIGNAL_ICI_COLLECTIVE_MS
    assert sig.SIGNAL_DNS_LATENCY_MS in pm.attached_signals
    assert pm.shed_signals == [sig.SIGNAL_ICI_COLLECTIVE_MS]


def test_restore_one_reattaches_last_shed(tmp_path, monkeypatch):
    pm = ProbeManager(obj_dir=tmp_path, guard=_TrippedGuard())
    pm._attached = {
        sig.SIGNAL_DNS_LATENCY_MS: "h1",
        sig.SIGNAL_ICI_COLLECTIVE_MS: "h2",
        sig.SIGNAL_XLA_COMPILE_MS: "h3",
    }
    assert pm.check_overhead() == sig.SIGNAL_ICI_COLLECTIVE_MS
    assert pm.check_overhead() == sig.SIGNAL_XLA_COMPILE_MS
    assert pm.shed_signals == [sig.SIGNAL_ICI_COLLECTIVE_MS, sig.SIGNAL_XLA_COMPILE_MS]

    def fake_attach_all(signal_names):
        report = AttachReport()
        for name in signal_names:
            pm._attached[name] = f"restored:{name}"
            report.results.append(AttachResult(signal=name, attached=True, status="attached"))
        return report

    monkeypatch.setattr(pm, "attach_all", fake_attach_all)
    assert pm.restore_one() == sig.SIGNAL_XLA_COMPILE_MS
    assert pm.shed_signals == [sig.SIGNAL_ICI_COLLECTIVE_MS]
    assert pm.restore_one() == sig.SIGNAL_ICI_COLLECTIVE_MS
    assert pm.restore_one() is None


def test_restore_one_keeps_signal_on_failed_reattach(tmp_path, monkeypatch):
    pm = ProbeManager(obj_dir=tmp_path, guard=_TrippedGuard())
    pm._attached = {sig.SIGNAL_ICI_COLLECTIVE_MS: "h2"}
    pm.check_overhead()

    def failing_attach_all(signal_names):
        report = AttachReport()
        report.results.append(
            AttachResult(signal=signal_names[0], attached=False, status="no_symbol"))
        return report

    monkeypatch.setattr(pm, "attach_all", failing_attach_all)
    assert pm.restore_one() is None
    assert pm.shed_signals == [sig.SIGNAL_ICI_COLLECTIVE_MS]


# --- the port's own -------------------------------------------------------


def test_synthetic_kallsyms_plans_the_nvidia_ioctl_kprobe(tmp_path, monkeypatch):
    kallsyms = tmp_path / "kallsyms"
    kallsyms.write_text(
        "0000000000000000 t nvidia_frontend_open\n"
        "0000000000000000 t nvidia_unlocked_ioctl\t[nvidia]\n"
        "0000000000000000 T nvidia_ioctl\t[nvidia]\n"
        "0000000000000000 d nvidia_data\n"
    )
    (tmp_path / "accel_ioctl.bpf.o").write_bytes(b"")
    real = symbols.resolve_kernel_symbol

    def read(path):
        monkeypatch.setattr(symbols, "resolve_kernel_symbol",
                            lambda patterns: real(patterns, str(path)))

    read(kallsyms)
    (plan,) = ProbeManager(obj_dir=tmp_path).plan([sig.SIGNAL_HOST_OFFLOAD_STALL_MS])
    assert (plan.kind, plan.status, plan.symbol) == ("kprobe_pair", "planned",
                                                     "nvidia_unlocked_ioctl")
    assert plan.object_file == "accel_ioctl.bpf.o"
    empty = tmp_path / "empty"
    empty.write_text("0000000000000000 T vfio_device_fops_unl_ioctl\n")
    read(empty)
    (miss,) = ProbeManager(obj_dir=tmp_path).plan([sig.SIGNAL_HOST_OFFLOAD_STALL_MS])
    assert miss.status == "no_symbol" and "nvidia ioctl" in miss.detail


def test_a_found_library_plans_uprobes_with_the_jax_cookie(tmp_path, monkeypatch):
    """With libc standing in for both libraries and a manifest naming its
    symbols, each span plans on the resolved symbol's file offset and
    the cookie is ``make_cookie``'s."""
    libc = str(_libc())
    manifest = json.loads(DEFAULT_MANIFEST.read_text())
    manifest["signals"]["hbm_alloc_stall_ms"]["candidates"] = ["malloc"]
    manifest["signals"]["ici_collective_latency_ms"]["candidates"] = ["no_such", "getaddrinfo"]
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(manifest))
    (tmp_path / "libtpu_uprobes.bpf.o").write_bytes(b"")
    monkeypatch.setenv("TPUSLO_LIBCUDA_PATH", libc)
    monkeypatch.setenv("TPUSLO_NCCL_PATH", libc)
    pm = ProbeManager(obj_dir=tmp_path, manifest_path=path)
    plans = {p.signal: p for p in pm.plan(list(CUDA_SIGNALS[:3]))}
    for name, pattern in (("hbm_alloc_stall_ms", "malloc"),
                          ("ici_collective_latency_ms", "getaddrinfo")):
        plan = plans[name]
        want = symbols.resolve_elf_symbol(libc, [pattern])
        assert (plan.status, plan.kind, plan.target_binary) == ("planned", "uprobe_span", libc)
        assert (plan.symbol, plan.file_offset) == (want.name, want.file_offset)
        assert plan.cookie == jpm.make_cookie(name, want.name)
    # libc has no cuGraphInstantiate: the library was found, nothing resolved.
    miss = plans["xla_compile_ms"]
    assert (miss.status, miss.target_binary) == ("no_symbol", libc)
    assert "no candidate symbol" in miss.detail


def test_unplanned_signals_report_their_reason_and_never_attach(tmp_path):
    pm = ProbeManager(obj_dir=tmp_path)
    for plan in pm.plan([sig.SIGNAL_ICI_LINK_RETRIES, sig.SIGNAL_DCN_TRANSFER_MS]):
        assert plan.kind == "none" and plan.status == "unplanned"
        assert "one card" in plan.detail
        result = pm._attach_one(None, plan)
        assert not result.attached and result.status == "unplanned"


def test_libraries_are_found_where_a_process_maps_them(tmp_path):
    lib = tmp_path / "libcuda.so.1"
    lib.write_bytes(b"\x7fELF")
    nccl = tmp_path / "libnccl.so.2"
    nccl.write_bytes(b"\x7fELF")
    maps = tmp_path / "maps"
    maps.write_text(
        f"7f00-7f01 r-xp 00000000 08:01 1 {lib}\n"
        f"7f02-7f03 r-xp 00000000 08:01 2 {nccl}\n"
        "7f04-7f05 rw-p 00000000 00:00 0 [heap]\n"
    )
    assert symbols.find_libcuda(paths=(), maps=str(maps), env={}) == str(lib)
    assert symbols.find_nccl(paths=(), maps=str(maps), env={}) == str(nccl)
    assert symbols.find_libcuda(paths=(str(tmp_path / "libcuda.so*"),),
                                maps=str(tmp_path / "none"), env={}) == str(lib)
    assert symbols.find_libcuda(paths=(), maps=str(tmp_path / "none"),
                                env={"TPUSLO_LIBCUDA_PATH": str(nccl)}) == str(nccl)
    assert symbols.find_libcuda(paths=(), maps=str(tmp_path / "none"), env={}) is None


def test_the_collector_and_prereq_import_no_yaml():
    code = ("import sys, tpuslo_torch.collector, tpuslo_torch.collector.probe_manager, "
            "tpuslo_torch.prereq, tpuslo_torch.prereq.checker, tpuslo_torch.signals.mode; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', 'jax', 'tpuslo')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_remediation_engine_sheds_and_restores_through_the_manager(tmp_path, monkeypatch):
    """``remediation/actions.py`` takes a probe manager by duck type: a
    probe-shed action on the port's manager detaches the signal, and its
    rollback attaches it again."""
    from tpuslo_torch.remediation.actions import ACTION_PROBE_SHED, ActionBindings

    pm = ProbeManager(obj_dir=tmp_path)
    pm._attached = {sig.SIGNAL_XLA_COMPILE_MS: "h"}

    def fake_attach_all(signal_names):
        report = AttachReport()
        for name in signal_names:
            pm._attached[name] = "again"
            report.results.append(AttachResult(signal=name, attached=True, status="attached"))
        return report

    monkeypatch.setattr(pm, "attach_all", fake_attach_all)
    action = ActionBindings(probe_manager=pm).build(ACTION_PROBE_SHED, sig.SIGNAL_XLA_COMPILE_MS)
    assert action.apply().ok
    assert pm.attached_signals == [] and pm.shed_signals == [sig.SIGNAL_XLA_COMPILE_MS]
    assert action.rollback().ok
    assert pm.attached_signals == [sig.SIGNAL_XLA_COMPILE_MS] and pm.shed_signals == []
