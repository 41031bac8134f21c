"""The serving benches' audit, ``tpuslo_torch.analysis.jitaudit``, on the
CPU: the registry's API (the part of ``tpuslo.analysis.jitaudit`` the two
benches call), recapture rules, and the counts a front door and a
speculative engine produce once it is installed.

On the CPU nothing is captured and PyTorch reports no synchronizing
call, so the capture and recapture counts are 0 and the host-sync count
is the fused reads alone.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tpuslo.analysis import jitaudit as jaudit  # noqa: E402
from tpuslo_torch.analysis import jitaudit  # noqa: E402
from tpuslo_torch.models import frontdoor, llama, serve, speculative  # noqa: E402

CFG = dataclasses.replace(llama.llama_tiny(max_seq_len=96), dtype=torch.float32)


@pytest.fixture()
def installed():
    assert not jitaudit.installed()
    jitaudit.install()
    jitaudit.registry().reset()
    yield jitaudit.registry()
    jitaudit.uninstall()
    jitaudit.registry().reset()


@pytest.fixture(scope="module")
def pair():
    target = serve.ServeEngine(CFG, rng_seed=0, device="cpu")
    return target, serve.ServeEngine(CFG, params=target.params, device="cpu")


def test_the_benches_api_matches_the_jax_module():
    for name in ("install", "uninstall", "installed", "registry"):
        assert callable(getattr(jitaudit, name)) and callable(getattr(jaudit, name))
    for name in ("steady_compile_count", "host_sync_count", "reset"):
        assert callable(getattr(jitaudit.JitAuditRegistry, name))
        assert callable(getattr(jaudit.JitAuditRegistry, name))


class _Owner:
    """An engine stand-in: anything weakly referenceable."""


def test_recapture_rules_on_a_private_registry():
    reg = jitaudit.JitAuditRegistry()
    a, b = _Owner(), _Owner()
    reg.on_capture(a, "spec_round:1", 12.0)
    reg.on_capture(b, "spec_round:1", 11.0)  # another owner: a first capture
    reg.on_capture(a, "spec_round_batch:4", 9.0)
    assert (reg.capture_count(), reg.steady_compile_count()) == (3, 0)
    reg.on_capture(a, "spec_round:1", 10.0)  # a key the owner holds
    assert (reg.capture_count(), reg.steady_compile_count()) == (4, 1)
    assert [e.recapture for e in reg.captures] == [False, False, False, True]
    reg.on_host_read()
    reg.on_host_read()
    reg.on_sync()
    assert reg.host_sync_count() == 3
    reg.reset()
    assert (reg.capture_count(), reg.steady_compile_count(), reg.host_sync_count()) == (0, 0, 0)


def test_a_front_door_capturing_after_its_first_dispatch_recaptures(pair):
    """A front door captures when it is built; a capture once it has
    dispatched (inside ``step()``) is a recapture, whatever its key."""
    reg = jitaudit.JitAuditRegistry()
    fd = frontdoor.FrontDoorEngine(*pair, k=3, max_slots=2, rounds_per_step=2)
    reg.on_capture(fd, "spec_multi_round:2x2", 5.0)
    fd.submit("dispatch once", max_new_tokens=20, stop_at_eos=False)
    fd.step()
    reg.on_capture(fd, "spec_multi_round:2x3", 5.0)
    assert [e.recapture for e in reg.captures] == [False, True]


def test_a_new_owner_at_a_freed_owners_address_holds_nothing():
    """Engines come and go (a bench builds one per pass); a new engine
    that Python places where a freed one was is not recapturing."""
    import gc

    reg = jitaudit.JitAuditRegistry()
    for _ in range(50):
        owner = _Owner()
        reg.on_capture(owner, "spec_multi_round:16x3", 5.0)
        del owner
        gc.collect()
    assert (reg.capture_count(), reg.steady_compile_count()) == (50, 0)
    reg.on_capture(None, "spec_round:1", 1.0)
    reg.on_capture(None, "spec_round:1", 1.0)
    assert reg.steady_compile_count() == 0


def test_install_is_idempotent_and_uninstall_restores_the_hooks():
    assert speculative.GraphedDispatch.on_capture is None and serve._HostRead.on_read is None
    jitaudit.install()
    jitaudit.install()
    try:
        assert jitaudit.installed()
        assert serve._HostRead.on_read is not None
        assert speculative.GraphedDispatch.on_capture is not None
    finally:
        jitaudit.uninstall()
        jitaudit.uninstall()
    assert not jitaudit.installed()
    assert speculative.GraphedDispatch.on_capture is None and serve._HostRead.on_read is None


def test_a_front_door_reads_once_per_steady_step_and_captures_nothing(installed, pair):
    fd = frontdoor.FrontDoorEngine(*pair, k=3, max_slots=2, rounds_per_step=2)
    for i in range(2):
        fd.submit(f"audited {i}", max_new_tokens=30, stop_at_eos=False)
    fd.step()  # admission: one read of the first tokens, one of the step
    assert installed.host_sync_count() == 2
    for n in range(3):
        fd.step()
        assert installed.host_sync_count() == 3 + n
    assert (installed.capture_count(), installed.steady_compile_count()) == (0, 0)
    assert installed.syncs == 0


def test_a_stream_reads_once_per_round(installed, pair):
    spec = speculative.SpeculativeEngine(*pair, k=3)
    tokens = spec.generate("audited stream", max_new_tokens=17, stop_at_eos=False)
    assert len(tokens) == 17
    assert installed.host_sync_count() == 1 + spec.rounds  # the first token, then one per round
    assert installed.capture_count() == 0


def test_graphed_dispatch_reports_no_capture_on_the_cpu(installed):
    calls = []
    run = speculative.GraphedDispatch(
        lambda: calls.append(1) or torch.ones(2), "spec_round", (torch.zeros(1), 3),
        torch.device("cpu"), "spec_round:1", owner=_Owner())
    assert run.graph is None and run.capture_ms is None
    assert torch.equal(run(), torch.ones(2)) and calls == [1]
    assert installed.capture_count() == 0
