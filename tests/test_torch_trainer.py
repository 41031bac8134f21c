"""The port's trainer and ``python -m tpuslo_torch train`` on the CPU.

* loss descent on ``llama_tiny`` and ``mixtral_tiny``;
* a resume (3 steps with a checkpoint, then 3 more in fresh objects)
  equals the uninterrupted 6 steps bitwise, for both families;
* the port's trainer over JAX's f32 ``llama_tiny`` weights follows JAX's
  trainer's loss curve (same seed, corpus and batches) to rtol 1e-5;
* ``python -m tpuslo_torch train --cpu-mesh 1`` prints JSON lines with
  the keys of ``tpuslo/cli/train.py``'s lines; ``--cpu-mesh N`` trains
  over N gloo ranks with JAX's mesh summary, and a plan of more slices
  than its devices divide into exits 2 with JAX's plan error.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuslo.models import llama as jl  # noqa: E402
from tpuslo.models import trainer as jtrainer  # noqa: E402
from tpuslo.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from tpuslo.parallel.mesh import plan_for_devices as jplan  # noqa: E402
from tpuslo_torch.cli import train as tcli  # noqa: E402
from tpuslo_torch.models import bridge  # noqa: E402
from tpuslo_torch.models import llama as tl  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402
from tpuslo_torch.models import train as ttrain  # noqa: E402
from tpuslo_torch.models.trainer import TrainerConfig, train  # noqa: E402
from tpuslo_torch.parallel.mesh import make_mesh, plan_for_devices  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
CORPUS = [f"sample {i}: pack my box with five dozen liquor jugs" for i in range(60)]
TCFG = dict(batch=4, seq_len=32, seed=3)
FAMILIES = {
    "llama": (tl.llama_tiny(max_seq_len=64), None),
    "mixtral": (tm.mixtral_tiny(max_seq_len=64), tm.build_moe_train_step),
}


def _mesh():
    return make_mesh(plan_for_devices(1), devices=["cpu"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_descends(family):
    cfg, builder = FAMILIES[family]
    result = train(cfg, _mesh(), CORPUS, TrainerConfig(steps=5, **TCFG), step_builder=builder)
    assert result["first_step"] == 0 and result["last_step"] == 5
    losses = result["losses"]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_equals_uninterrupted_bitwise(tmp_path, family):
    cfg, builder = FAMILIES[family]
    full = train(cfg, _mesh(), CORPUS, TrainerConfig(steps=6, **TCFG),
                 step_builder=builder)["losses"]
    ckpt_dir = str(tmp_path / "ckpts")
    first = train(cfg, _mesh(), CORPUS, TrainerConfig(steps=3, ckpt_every=3, **TCFG),
                  checkpoint_dir=ckpt_dir, step_builder=builder)
    assert first["last_step"] == 3
    second = train(cfg, _mesh(), CORPUS, TrainerConfig(steps=6, ckpt_every=3, **TCFG),
                   checkpoint_dir=ckpt_dir, step_builder=builder)
    assert second["first_step"] == 3 and second["last_step"] == 6
    assert first["losses"] + second["losses"] == full


def test_loss_curve_follows_the_jax_trainer():
    cfg_j = dataclasses.replace(jl.llama_tiny(max_seq_len=64), dtype=jnp.float32)
    cfg_t = dataclasses.replace(tl.llama_tiny(max_seq_len=64), dtype=torch.float32)
    want = jtrainer.train(cfg_j, jmake_mesh(jplan(1)), CORPUS,
                          jtrainer.TrainerConfig(steps=6, **TCFG))["losses"]
    p0 = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(TCFG["seed"]), cfg_j))

    def builder(mesh, cfg):
        step_fn, _ = ttrain.build_sharded_train_step(mesh, cfg)

        def init_fn(seed, restored=None):
            params = ttrain.trainable(bridge.params_from_numpy(p0, cfg, mesh.device))
            return params, ttrain.make_optimizer().init(params)

        return step_fn, init_fn

    got = train(cfg_t, _mesh(), CORPUS, TrainerConfig(steps=6, **TCFG),
                step_builder=builder)["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _jax_cli_keys() -> list[set[str]]:
    """The key sets of the JSON lines ``tpuslo/cli/train.py`` prints."""
    tree = ast.parse((REPO / "tpuslo" / "cli" / "train.py").read_text())
    return [{k.value for k in node.keys} for node in ast.walk(tree)
            if isinstance(node, ast.Dict) and node.keys
            and all(isinstance(k, ast.Constant) for k in node.keys)
            and {"step", "done"} & {k.value for k in node.keys}]


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
def test_cli_prints_the_jax_lines(capsys, model):
    rc = tcli.main(["--cpu-mesh", "1", "--model", model, "--steps", "3", "--batch", "2",
                    "--seq-len", "32"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    step_keys, done_keys = sorted(_jax_cli_keys(), key=len)
    assert [set(line) for line in lines] == [step_keys] * 3 + [done_keys]
    assert [line["step"] for line in lines[:3]] == [1, 2, 3]
    done = lines[-1]
    assert done["done"] is True and done["model"] == model
    assert (done["first_step"], done["last_step"]) == (0, 3)
    assert done["final_loss"] == lines[2]["loss"]
    assert done["mesh"] == ({"dp": 1, "ep": 1} if model.startswith("mixtral")
                            else {"dcn": 1, "dp": 1, "fsdp": 1, "tp": 1})


@pytest.mark.parametrize("argv", [["--cpu-mesh", "3", "--slices", "2"],
                                  ["--cpu-mesh", "1", "--slices", "2"]])
def test_cli_refuses_more_than_one_device(capsys, argv):
    """A plan of more slices than its devices divide into exits 2 with JAX's
    plan error (``--cpu-mesh 1 --slices 2``: one device, two slices)."""
    n, slices = int(argv[1]), int(argv[3])
    with pytest.raises(ValueError) as jax_error:
        jplan(n, slices)
    assert tcli.main(argv) == 2
    assert str(jax_error.value) in capsys.readouterr().err


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_one_rank_group_mesh_trains_as_one_device(tmp_path, family):
    """A mesh of one rank over an initialized process group (a script that
    keeps a one-rank group open, as chip_smoke does on the card) trains
    through the one-device step, bit for bit the mesh without a group."""
    import torch.distributed as dist

    cfg, builder = FAMILIES[family]
    tcfg = TrainerConfig(steps=2, **TCFG)
    want = train(cfg, _mesh(), CORPUS, tcfg, step_builder=builder)["losses"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = _mesh()
        assert mesh.distributed and mesh.size == 1
        got = train(cfg, mesh, CORPUS, tcfg, step_builder=builder)["losses"]
    finally:
        dist.destroy_process_group()
    assert got == want


@pytest.mark.parametrize("model,n,slices", [("llama_tiny", 4, 1), ("llama_tiny", 8, 2),
                                            ("mixtral_tiny", 4, 1)])
def test_cli_trains_over_a_cpu_mesh(capsys, model, n, slices):
    """``--cpu-mesh N`` trains over N gloo ranks: JAX's ``mesh`` summary
    (the plan of N devices, or dp x ep with ep = gcd(N, n_experts)) and a
    descending loss."""
    argv = ["--cpu-mesh", str(n), "--model", model, "--steps", "4", "--batch", "8",
            "--seq-len", "32"]
    if slices > 1:
        argv += ["--slices", str(slices)]
    assert tcli.main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    done = lines[-1]
    if model.startswith("mixtral"):
        assert done["mesh"] == {"dp": 1, "ep": 4}
    else:
        plan = jplan(n, slices)
        assert done["mesh"] == {"dcn": plan.dcn, "dp": plan.dp, "fsdp": plan.fsdp, "tp": plan.tp}
    losses = [line["loss"] for line in lines[:-1]]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert (done["first_step"], done["last_step"]) == (0, 4)


def test_cli_resumes_from_its_checkpoints(capsys, tmp_path):
    base = ["--cpu-mesh", "1", "--batch", "2", "--seq-len", "32",
            "--checkpoint-dir", str(tmp_path / "c"), "--ckpt-every", "2"]
    assert tcli.main(base + ["--steps", "2"]) == 0
    capsys.readouterr()
    assert tcli.main(base + ["--steps", "4"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["step"] for line in lines[:-1]] == [3, 4]
    assert (lines[-1]["first_step"], lines[-1]["last_step"]) == (2, 4)


def test_the_dispatcher_runs_train(capsys):
    from tpuslo_torch.__main__ import BINARIES, main

    assert BINARIES["train"] == "tpuslo_torch.cli.train"
    assert main(["train", "--cpu-mesh", "1", "--steps", "1", "--batch", "2",
                 "--seq-len", "32"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["last_step"] == 1
