"""The port's MoE train step over a ``(dp, ep)`` mesh
(``mixtral.build_moe_train_step``) through the trainer, against
``tpuslo.models.mixtral``'s on a JAX ``(dp, ep)`` mesh of the conftest's
CPU devices: the port of ``tests/test_trainer.py``'s MoE resume test.

f32 ``mixtral_tiny`` (4 experts, top 2, drop-free) from JAX's weights at
dp 2 x ep 2, as one group of 4 gloo ranks:

* each rank holds two whole experts and the whole router; the batch
  splits over dp alone;
* the trainer trains (the loss descends), checkpoints after 2 steps and
  resumes to 4 in fresh objects with the uninterrupted loss curve bit for
  bit, on every rank;
* the losses follow JAX's trainer on the same weights, corpus and batches
  within 1e-4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_train_mesh_ranks as ranks  # noqa: E402
from tpuslo.models import mixtral as jm  # noqa: E402
from tpuslo.models import trainer as jtrainer  # noqa: E402
from tpuslo_torch.models import mixtral as tm  # noqa: E402
from tpuslo_torch.ops import moe as tmoe  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

CORPUS = [f"sample {i}: pack my box with five dozen liquor jugs" for i in range(60)]
TCFG = dict(batch=4, seq_len=32, seed=3)
DP, EP, STEPS = 2, 2, 4
LOSS_TOL = 1e-4


def _jcfg():
    return dataclasses.replace(jm.mixtral_tiny(max_seq_len=64), dtype=jnp.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(TCFG["seed"]), _jcfg()))
    ckpt = str(tmp_path_factory.mktemp("moe-mesh") / "ckpts")
    return tmesh.run_ranks(ranks.moe_trainer_rank, DP * EP, timeout_s=ranks.RANK_TIMEOUT_S,
                           args=(DP, params, CORPUS, TCFG, ckpt, STEPS))


@pytest.fixture(scope="module")
def jax_losses():
    mesh = Mesh(np.array(jax.devices()[:DP * EP]).reshape(DP, EP), ("dp", "ep"))
    return jtrainer.train(_jcfg(), mesh, CORPUS, jtrainer.TrainerConfig(steps=STEPS, **TCFG),
                          step_builder=jm.build_moe_train_step)["losses"]


def test_ranks_hold_their_experts_and_split_the_batch_over_dp(port):
    cfg = ranks.mixtral_cfg()
    for r in port:
        assert r["experts"] == (cfg.n_layers, cfg.n_experts // EP, cfg.dim, cfg.ffn_dim)
        assert r["router"] == (cfg.n_layers, cfg.dim, cfg.n_experts)
        assert r["data_axes"] == ("dp",)


def test_the_dp_ep_trainer_descends_and_every_rank_agrees(port):
    full = port[0]["full"]["losses"]
    assert len(full) == STEPS and full[-1] < full[0]
    for r in port[1:]:
        assert r["full"]["losses"] == full


def test_the_dp_ep_trainer_resumes_bit_for_bit(port):
    for r in port:
        first, second = r["first"], r["second"]
        assert first["last_step"] == STEPS // 2
        assert second["first_step"] == STEPS // 2 and second["last_step"] == STEPS
        assert first["losses"] + second["losses"] == r["full"]["losses"]


def test_the_losses_follow_jaxs_dp_ep_trainer(port, jax_losses):
    np.testing.assert_allclose(port[0]["full"]["losses"], jax_losses, rtol=0, atol=LOSS_TOL)


def test_a_droppy_config_is_refused_over_more_than_one_data_rank():
    cfg = dataclasses.replace(tm.mixtral_tiny(), capacity_factor=1.0).moe()
    mesh = tmesh.Mesh(None, torch.device("cpu"), axes=(("dp", "ep"), (2, 1)))
    with pytest.raises(ValueError, match="drop-free routing"):
        tmoe.moe_mlp_train({}, torch.zeros((4, cfg.dim)), cfg, mesh)


def test_the_train_layout_is_jaxs_dp_ep_layout():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "ep"))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jm.param_shardings(mesh), is_leaf=lambda v: hasattr(v, "spec"))[0]:
        want["/".join(k.key for k in path)] = {i: a for i, a in enumerate(s.spec)
                                               if a is not None}
    assert tm.TRAIN_LAYOUT == want
