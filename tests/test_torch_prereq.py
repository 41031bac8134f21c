"""Host prerequisites and the capability tier on the CUDA probe surface:
``tpuslo_torch.prereq`` and ``tpuslo_torch.signals.mode`` beside the JAX
package's.

``evaluate`` runs on pairs of snapshots that differ only in the device
fields (``/dev/accel*``, ``libtpu.so`` and JAX there; ``/dev/nvidia*``,
``libcuda.so`` and torch with CUDA here): every other check is JAX's,
name, severity, verdict and detail; the device checks stand in the same
places with the same severity and verdict.  On a host with neither
surface both packages pick the same capability mode.
"""

from __future__ import annotations

import dataclasses

import pytest

from tpuslo import prereq as jprereq
from tpuslo.signals import mode as jmode
from tpuslo_torch import prereq
from tpuslo_torch.signals import constants as sig
from tpuslo_torch.signals import mode

DEVICE_CHECKS = {"accel_devices": "nvidia_devices", "libtpu": "libcuda", "jax": "torch_cuda"}

HOSTS = [
    dict(kernel_release="6.1.0", has_btf=True, is_root=True, bpftool="/usr/sbin/bpftool",
         clang="", kind="", helm="/usr/bin/helm"),
    dict(kernel_release="4.19.0"),
    dict(kernel_release="weird", has_btf=False, is_root=False, clang="/usr/bin/clang"),
    dict(kernel_release="5.15.0-1051-gcp", has_btf=True, is_root=False, kind="/usr/bin/kind"),
]


def _pair(host: dict, device: bool):
    j = jprereq.HostSnapshot(**host, accel_devices=["/dev/accel0"] if device else [],
                             libtpu_path="/usr/lib/libtpu.so" if device else "",
                             jax_available=device)
    t = prereq.HostSnapshot(**host, nvidia_devices=["/dev/nvidia0"] if device else [],
                            libcuda_path="/usr/lib/x86_64-linux-gnu/libcuda.so.1"
                            if device else "", torch_cuda=device)
    return jprereq.evaluate(j), prereq.evaluate(t)


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("host", range(len(HOSTS)))
def test_evaluate_matches_jax_outside_the_device_checks(host, device):
    want, got = _pair(HOSTS[host], device)
    assert [DEVICE_CHECKS.get(r.name, r.name) for r in want] == [r.name for r in got]
    for w, g in zip(want, got):
        assert (g.severity, g.passed) == (w.severity, w.passed), g.name
        if w.name not in DEVICE_CHECKS:
            assert g.to_dict() == w.to_dict()


def test_device_checks_name_the_card_surface():
    _, got = _pair(HOSTS[0], device=False)
    checks = {r.name: r for r in got}
    assert "/dev/nvidia" in checks["nvidia_devices"].detail
    assert "libcuda.so not found" in checks["libcuda"].detail
    assert not checks["torch_cuda"].passed
    _, got = _pair(HOSTS[0], device=True)
    checks = {r.name: r for r in got}
    assert checks["nvidia_devices"].detail == "/dev/nvidia0"
    assert checks["libcuda"].detail.endswith("libcuda.so.1")


def test_parse_kernel_release_matches_jax():
    for release in ("6.18.5-fc-v18", "5.15.0", "4.19.0"):
        assert prereq.parse_kernel_release(release) == jprereq.parse_kernel_release(release)
    with pytest.raises(ValueError):
        prereq.parse_kernel_release("weird")


def test_collect_snapshot_runs_on_this_host(tmp_path):
    snap = prereq.collect_snapshot(nvidia_glob=str(tmp_path / "nvidia[0-9]*"), env={})
    assert snap.kernel_release and snap.nvidia_devices == []
    torch = pytest.importorskip("torch")
    assert snap.torch_cuda == (torch.version.cuda is not None)
    names = {f.name for f in dataclasses.fields(snap)}
    assert {"nvidia_devices", "libcuda_path", "torch_cuda"} <= names
    assert not {"accel_devices", "libtpu_path", "jax_available"} & names


@pytest.mark.parametrize("btf", [True, False])
def test_a_host_with_neither_surface_picks_the_jax_mode(tmp_path, btf):
    btf_path = tmp_path / "vmlinux"
    if btf:
        btf_path.write_bytes(b"")
    kw = dict(btf_path=str(btf_path), accel_glob=str(tmp_path / "accel*"), env={})
    got = mode.detect_capability_mode(**kw, nvidia_glob=str(tmp_path / "nvidia[0-9]*"),
                                      libcuda_paths=(str(tmp_path / "libcuda.so*"),))
    assert got == jmode.detect_capability_mode(**kw)
    assert got == (sig.CAPABILITY_CORE_FULL if btf else sig.CAPABILITY_BCC_DEGRADED)


@pytest.mark.parametrize("surface", ["device_node", "libcuda"])
def test_the_cuda_surface_picks_cuda_full_with_every_signal(tmp_path, surface):
    btf_path = tmp_path / "vmlinux"
    btf_path.write_bytes(b"")
    if surface == "device_node":
        (tmp_path / "nvidia0").write_bytes(b"")
    else:
        (tmp_path / "libcuda.so.1").write_bytes(b"")
    got = mode.detect_capability_mode(
        btf_path=str(btf_path), accel_glob=str(tmp_path / "accel*"), env={},
        nvidia_glob=str(tmp_path / "nvidia[0-9]*"),
        libcuda_paths=(str(tmp_path / "libcuda.so*"),))
    assert got == sig.CAPABILITY_CUDA_FULL
    assert sig.supported_signals_for_mode(got) == list(sig.ALL_SIGNALS)
    assert mode.parse_capability_mode("cuda_full") == sig.CAPABILITY_CUDA_FULL


def test_the_tpu_surface_still_wins_and_modes_keep_jax_order(tmp_path):
    btf_path = tmp_path / "vmlinux"
    btf_path.write_bytes(b"")
    (tmp_path / "accel0").write_bytes(b"")
    (tmp_path / "nvidia0").write_bytes(b"")
    assert mode.detect_capability_mode(
        btf_path=str(btf_path), accel_glob=str(tmp_path / "accel*"), env={},
        nvidia_glob=str(tmp_path / "nvidia[0-9]*")) == sig.CAPABILITY_TPU_FULL
    from tpuslo.signals import constants as jsig

    assert [m for m in sig.CAPABILITY_MODES if m != sig.CAPABILITY_CUDA_FULL] == list(
        jsig.CAPABILITY_MODES)
