"""The load generator: ``tpuslo_torch.cli.loadgen`` against the JAX
package's ``tpuslo.cli.loadgen``.

The module is plain Python in both packages, so for the same seed and
flags the records, the tenant-mix errors and the CLI's output must be
identical, over every arrival model, tenant mix and prefix grouping.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from tpuslo.cli import loadgen as jlg
from tpuslo_torch.cli import loadgen as tlg

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 42, 1337])
@pytest.mark.parametrize("arrival", jlg.ARRIVALS)
@pytest.mark.parametrize("tenants,mix,prefix_rate,groups", [
    (1, "", 0.0, 1),
    (4, "40,30,20,10", 0.35, 1),
    (3, "70,20", 0.9, 8),
])
def test_records_equal_jax(seed, arrival, tenants, mix, prefix_rate, groups):
    kw = dict(profile="chat_short", rps=48.0, duration_s=1.0, seed=seed, arrival=arrival,
              tenants=tenants, tenant_mix=mix, prefix_rate=prefix_rate, prefix_groups=groups)
    want = jlg.synthesize_requests(**kw)
    assert len(want) == 48
    assert tlg.synthesize_requests(**kw) == want


@pytest.mark.parametrize("tenant_idx,groups", [(0, 1), (2, 5), (7, 8)])
def test_helpers_equal_jax(tenant_idx, groups):
    assert tlg.prefix_group_weights(tenant_idx, groups) == jlg.prefix_group_weights(
        tenant_idx, groups)
    assert tlg.prefix_group_name(groups) == jlg.prefix_group_name(groups)
    assert tlg.PROFILES == jlg.PROFILES and tlg.ARRIVALS == jlg.ARRIVALS


@pytest.mark.parametrize("spec,tenants", [
    ("", 3), ("70,20,10", 3), ("5", 4), ("70,,10", 3), ("1,2,3", 2), ("1,-1", 2),
    ("x", 1), ("1", 0),
])
def test_parse_tenant_mix_equals_jax(spec, tenants):
    def outcome(mod):
        try:
            return ("ok", mod.parse_tenant_mix(spec, tenants))
        except ValueError as exc:
            return ("error", str(exc))

    assert outcome(tlg) == outcome(jlg)


def test_arrival_offsets_and_unknown_arrival_equal_jax():
    import random

    for arrival in jlg.ARRIVALS:
        assert tlg.arrival_offsets_ms(arrival, 20, 2.0, random.Random(5)) == (
            jlg.arrival_offsets_ms(arrival, 20, 2.0, random.Random(5)))
    with pytest.raises(ValueError) as want:
        jlg.arrival_offsets_ms("bursty", 3, 1.0, random.Random(0))
    with pytest.raises(ValueError) as got:
        tlg.arrival_offsets_ms("bursty", 3, 1.0, random.Random(0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [
    ["--rps", "3", "--duration-s", "4"],
    ["--profile", "chat_short", "--arrival", "burst", "--tenants", "4", "--tenant-mix",
     "40,30,20,10", "--prefix-rate", "0.35", "--rps", "12", "--duration-s", "2", "--seed",
     "1337"],
    ["--arrival", "poisson", "--tenants", "1", "--tenant", "acme", "--rps", "2",
     "--duration-s", "5", "--error-rate", "0.3", "--error-after-s", "1", "--slow-ttft-rate",
     "0.2", "--slo-out", "SLO"],
])
def test_cli_output_equals_jax(argv, tmp_path):
    """``python -m tpuslo_torch loadgen`` writes what ``python -m tpuslo
    loadgen`` writes: stdout, the --slo-out file and the stderr line."""
    outs = {}
    for pkg in ("tpuslo", "tpuslo_torch"):
        slo = tmp_path / f"{pkg}.slo.jsonl"
        args = [str(slo) if a == "SLO" else a for a in argv]
        proc = subprocess.run([sys.executable, "-m", pkg, "loadgen", *args], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        stderr = proc.stderr.replace(str(slo), "SLO")
        outs[pkg] = (proc.stdout, slo.read_text() if slo.exists() else None, stderr)
    assert outs["tpuslo_torch"] == outs["tpuslo"]
    assert outs["tpuslo"][0].count("\n") >= 8


def test_the_port_dispatcher_lists_loadgen():
    from tpuslo_torch.__main__ import BINARIES

    assert BINARIES["loadgen"] == "tpuslo_torch.cli.loadgen"
