"""The port's process entry, ``python -m tpuslo_torch frontdoor``, held to
``python -m tpuslo frontdoor``.

Both entries' ``main`` run in this process on the CPU with the same argv
and the same stepping fake clock (each module's ``time`` is replaced, so
the burn windows, the prefeed and ``consider(..., now_s)`` read the same
instants): every status row must be equal in every key but ``ts``, the
``--json`` summaries equal, and the runtime snapshot's ``progress``,
``burn`` and ``remediation`` components equal.  Then both restart on
their state dirs for more cycles, a JAX-written state dir resumes in
the port's entry with JAX's own rows, and a port-written one in JAX's.  Both serve ``llama_tiny`` in
f32, the port on the JAX engine's seed-0 weights carried over through
``bridge.params_from_numpy``, so the snapshot's front-door component
(its token streams included) is equal as well.

A subprocess run of the port's entry is killed with SIGKILL once its
snapshot holds the demotion, restarted, and held to the chaos lane's
audit (``chip_smoke.audit_resume``, the same code the card's phase
runs).  Without ``--device cpu`` the entry refuses to start on a box
with no card; the dispatcher's usage text and exit codes are checked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.cli import frontdoor as jentry  # noqa: E402
from tpuslo.models import frontdoor as jfd  # noqa: E402
from tpuslo.models import llama as jl  # noqa: E402
from tpuslo_torch import __main__ as tdispatch  # noqa: E402
from tpuslo_torch.cli import frontdoor as tentry  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import frontdoor as tfd  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

FRESH, RESTART = 30, 40  # cycles of the first run, and of the restarted one


class FakeTime:
    """A stand-in for an entry module's ``time``: ``time()`` steps a
    quarter second from ``base`` per call; the monotonic clock and sleep
    stay real (they bound the loop, not the burn windows)."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)

    def __init__(self, base: float):
        self.now = base

    def time(self) -> float:
        self.now += 0.25
        return self.now


class ServingTime:
    """A stand-in for the front-door engine module's ``time``: its
    request clock stands still and its wall anchor is ``base``, so every
    outcome the engine records into the burn engine lands at ``base``
    with zero TTFT and TPOT on both sides (the real clocks would put the
    JAX engine's first-cycle compile into its TTFT); everything else is
    the real module."""

    def __init__(self, base: float):
        self._ns = int(base * 1e9)

    def perf_counter(self) -> float:
        return 0.0

    def time_ns(self) -> int:
        return self._ns

    def __getattr__(self, name):
        return getattr(time, name)


def run_main(module, argv: list[str], base: float, workdir: Path) -> dict:
    """One in-process run of ``module.main`` on ``workdir``'s status file
    and state dir, under a ``FakeTime(base)`` and a ``ServingTime(base)``."""
    argv = argv + ["--interval-s", "0", "--json", "--status-out", str(workdir / "status.jsonl"),
                   "--state-dir", str(workdir)]
    stdout, stderr = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "time", FakeTime(base))
        for engine_module in (jfd, tfd):
            mp.setattr(engine_module, "time", ServingTime(base))
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = module.main(argv)
    assert rc == 0, stderr.getvalue()
    return {"summary": json.loads(stdout.getvalue()), "stderr": stderr.getvalue(),
            "rows": chip_smoke.read_rows(workdir / "status.jsonl"),
            "state": json.loads((workdir / "frontdoor-state.json").read_text())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Fresh runs of both entries, their restarts, the port's resume of a
    copy of the JAX-written state dir and JAX's of the port's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("entry")
    tiny_j, tiny_t = jl.llama_tiny, tl.llama_tiny
    cfg_j = dataclasses.replace(tiny_j(max_seq_len=128), dtype=jnp.float32)
    cfg_t = dataclasses.replace(tiny_t(max_seq_len=128), dtype=torch.float32)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg_j))
    pt = bridge.params_from_numpy(params, cfg_t, "cpu")
    build = tentry.build_engines
    base = float(int(time.time()))
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            # Both entries serve llama_tiny in f32, the port on the JAX
            # engine's seed-0 weights, so their token streams agree too.
            mp.setattr(jl, "llama_tiny", lambda **kw: dataclasses.replace(
                tiny_j(**kw), dtype=jnp.float32))
            mp.setattr(tl, "llama_tiny", lambda **kw: dataclasses.replace(
                tiny_t(**kw), dtype=torch.float32))
            mp.setattr(tentry, "build_engines", lambda device: build(device, params=pt))
            for name in ("jax", "port", "cross", "cross_back"):
                (root / name).mkdir()
            port_argv = ["--device", "cpu"]
            out["jax"] = run_main(jentry, ["--cycles", str(FRESH)], base, root / "jax")
            shutil.copytree(root / "jax", root / "cross", dirs_exist_ok=True)
            out["port"] = run_main(tentry, port_argv + ["--cycles", str(FRESH)], base,
                                   root / "port")
            shutil.copytree(root / "port", root / "cross_back", dirs_exist_ok=True)
            later = base + 600.0
            out["jax_restart"] = run_main(jentry, ["--cycles", str(RESTART)], later, root / "jax")
            out["port_restart"] = run_main(tentry, port_argv + ["--cycles", str(RESTART)], later,
                                           root / "port")
            out["cross"] = run_main(tentry, port_argv + ["--cycles", str(RESTART)], later,
                                    root / "cross")
            out["cross_back"] = run_main(jentry, ["--cycles", str(RESTART)], later,
                                         root / "cross_back")
    finally:
        torch.set_num_threads(threads)
    return out


def test_fresh_rows_equal_jax(runs):
    want, got = runs["jax"]["rows"], runs["port"]["rows"]
    assert [r["cycle"] for r in got] == list(range(FRESH))
    assert chip_smoke.rows_mismatch(got, want) == []
    assert [r["ts"] for r in got] == [r["ts"] for r in want]  # the same fake instants
    before, after = chip_smoke.entry_orders(got)
    assert (before, after) == (["burny", "steady"], ["steady", "burny"])
    assert got[0]["remediation_applied"] and not got[0]["order_flipped"]
    assert all(r["order_flipped"] and r["restored"] == "cold" for r in got[1:])


def test_fresh_summaries_equal_jax(runs):
    assert runs["port"]["summary"] == runs["jax"]["summary"] == {
        "cycles": FRESH, "burn_state": "fast_burn", "priority": 10,
        "remediation_phase": "verifying", "order_flips": FRESH - 1}


def test_snapshot_components_equal_jax(runs):
    """The state files hold the same progress, burn windows and
    remediation ledger; the front door's component is the same too, the
    port serving on JAX's weights (``results`` is the token streams)."""
    want, got = runs["jax"]["state"], runs["port"]["state"]
    assert got["schema_version"] == want["schema_version"] == 1
    assert sorted(got["components"]) == ["burn", "frontdoor", "progress", "remediation"]
    for name in ("progress", "burn", "remediation"):
        assert got["components"][name] == want["components"][name], name
    fd_got, fd_want = got["components"]["frontdoor"], want["components"]["frontdoor"]
    assert fd_got["counters"] == fd_want["counters"]
    assert fd_got["next_id"] == fd_want["next_id"] == 2 * FRESH
    assert fd_got["results"] == fd_want["results"]


def test_restart_rows_and_summary_equal_jax(runs):
    want, got = runs["jax_restart"], runs["port_restart"]
    assert chip_smoke.rows_mismatch(got["rows"], want["rows"]) == []
    assert [r["cycle"] for r in got["rows"]] == list(range(FRESH)) + list(range(FRESH, RESTART))
    assert all(r["restored"] == "restored" and r["order_flipped"]
               for r in got["rows"][FRESH:])
    # The restarted incarnation applied nothing, so it reports no phase.
    assert got["summary"] == want["summary"] == {
        "cycles": RESTART, "burn_state": "fast_burn", "priority": 10,
        "remediation_phase": "", "order_flips": RESTART - FRESH}
    for name in ("progress", "burn", "remediation"):
        assert got["state"]["components"][name] == want["state"]["components"][name]


def test_stderr_lines_match_jax(runs):
    """The same stderr lines, but for the snapshot's age and the port's
    one extra line naming the device."""
    def lines(text):
        return [line.split(" (age ")[0] for line in text.splitlines()]

    for jax_run, port_run in (("jax", "port"), ("jax_restart", "port_restart")):
        got = lines(runs[port_run]["stderr"])
        assert got[0] == "frontdoor: serving on cpu"
        assert got[1:] == lines(runs[jax_run]["stderr"])
    assert "frontdoor: remediation demote_tenant -> burny phase=verifying" in \
        runs["port"]["stderr"]
    assert "runtime: snapshot restored" in runs["port_restart"]["stderr"]
    assert "remediation demote_tenant" not in runs["port_restart"]["stderr"]


def test_a_jax_state_dir_resumes_in_the_port(runs):
    """The port's entry restarted on the JAX entry's state dir (every
    component written by JAX) gives the rows and summary of JAX's own
    resume."""
    want, got = runs["jax_restart"], runs["cross"]
    assert "components: progress,burn,frontdoor,remediation" in got["stderr"]
    assert chip_smoke.rows_mismatch(got["rows"], want["rows"]) == []
    assert got["summary"] == want["summary"]
    assert got["state"]["components"] == want["state"]["components"]


def test_a_port_state_dir_resumes_in_jax(runs):
    """And the reverse: the JAX entry restarted on the port's state dir
    gives the rows and summary of the port's own resume."""
    want, got = runs["port_restart"], runs["cross_back"]
    assert "components: progress,burn,frontdoor,remediation" in got["stderr"]
    assert chip_smoke.rows_mismatch(got["rows"], want["rows"]) == []
    assert got["summary"] == want["summary"]
    assert got["state"]["components"] == want["state"]["components"]


def test_without_a_card_the_entry_refuses_to_start(capsys):
    """No ``--device``: the entry serves on the card or not at all."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entry would serve on it")
    assert tentry.main(["--cycles", "1"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err
    assert tentry.main(["--cycles", "1", "--device", "meta"]) == 2
    assert "unsupported device" in capsys.readouterr().err


def test_the_module_entry_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entry would serve on it")
    out = subprocess.run([sys.executable, "-m", "tpuslo_torch", "frontdoor", "--cycles", "1",
                          "--status-out", str(tmp_path / "status.jsonl")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device is available" in out.stderr
    assert out.stdout == ""
    assert not (tmp_path / "status.jsonl").exists()


def test_kill_9_and_resume_pass_the_chaos_audit(tmp_path):
    """SIGKILL the entry once its snapshot holds the demotion; the
    restart resumes from the snapshot, keeps the demotion and applies
    nothing twice."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    resume = chip_smoke.kill_and_resume(tmp_path / "kill", "cpu", env=env)
    assert resume["failures"] == []
    assert resume["resumed_at"] == resume["snapshot_cycle"] >= 1
    assert resume["cycles"] == resume["killed_after_cycle"] + chip_smoke.ENTRY_RESUME_CYCLES
    assert resume["summary"]["remediation_phase"] == ""
    assert resume["stderr"].count("remediation demote_tenant") == 1
    # Every row on disk parses: the kill tore none (or the tear was dropped).
    rows = resume["rows"]
    assert [r["cycle"] for r in rows if r["restored"] == "restored"] == list(
        range(resume["resumed_at"], resume["cycles"]))


class TestDispatcher:
    def test_usage_lists_the_ported_binaries(self, capsys):
        assert tdispatch.main([]) == 2
        out = capsys.readouterr().out
        assert out == ("usage: python -m tpuslo_torch <binary> [flags]\n\nbinaries:\n"
                       "  agent\n  frontdoor\n  icibench\n  loadgen\n  slicecorr\n  train\n")
        assert tdispatch.main(["--help"]) == 0
        assert capsys.readouterr().out == out

    @pytest.mark.parametrize("name", ["fleetagg", "sloctl", "nosuch"])
    def test_other_binaries_are_not_ported_yet(self, capsys, name):
        assert tdispatch.main([name]) == 2
        assert capsys.readouterr().err == f"tpuslo_torch: binary {name!r} not ported yet\n"

    def test_the_ported_binaries_are_the_jax_dispatchers(self):
        from tpuslo import __main__ as jdispatch

        for name, module in tdispatch.BINARIES.items():
            assert jdispatch.BINARIES[name] == module.replace("tpuslo_torch.", "tpuslo.", 1)

    def test_a_broken_pipe_exits_141(self, tmp_path):
        """``python -m tpuslo_torch frontdoor --help | head -1``: the
        closed pipe ends the binary with 141 and a note on stderr."""
        script = (
            "import sys\n"
            "from tpuslo_torch import __main__ as d\n"
            "from tpuslo_torch.cli import frontdoor as f\n"
            "def main(argv):\n"
            "    raise BrokenPipeError\n"
            "f.main = main\n"
            "sys.exit(d.main(['frontdoor']))\n")
        out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 141
        assert "tpuslo_torch frontdoor: broken pipe, output truncated" in out.stderr

    def test_the_console_script_is_declared(self):
        text = (ROOT / "pyproject.toml").read_text()
        assert 'tpuslo-torch = "tpuslo_torch.__main__:main"' in text
