"""The MoE MLP: ``tpuslo_torch.ops.moe`` against ``tpuslo.ops.moe``.

The same f32 weights and inputs (drawn by JAX and numpy from fixed
seeds) go through both packages on the CPU.  Tolerances: the block's
output 1e-5 in f32; the routing (each kept token's expert and place in
the expert's buffer, and every drop) exactly; the load-balancing loss
1e-6.  A token's expert may differ only where JAX's k-th and (k+1)-th
router logits lie within 1e-6 (a tie the two sorts may break apart).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.ops import moe as jmoe  # noqa: E402
from tpuslo_torch.ops import moe as tmoe  # noqa: E402

OUT_TOL = 1e-5
LOSS_TOL = 1e-6
TIE_TOL = 1e-6

# (tokens, n_experts, top_k, capacity_factor): drop-free and dropping.
CASES = [
    (16, 8, 2, 4.0),
    (64, 8, 2, 2.0),
    (64, 8, 2, 0.5),
    (33, 4, 2, 2.0),
    (40, 4, 1, 0.25),
    (24, 6, 3, 1.0),
    (8, 1, 1, 0.01),
]


def _cfgs(T, E, K, cf, D=32, F=64):
    del T
    return (jmoe.MoEConfig(dim=D, ffn_dim=F, n_experts=E, top_k=K, capacity_factor=cf,
                           dtype=jnp.float32),
            tmoe.MoEConfig(dim=D, ffn_dim=F, n_experts=E, top_k=K, capacity_factor=cf,
                           dtype=torch.float32))


def _inputs(T, E, K, cf, seed=0):
    cj, ct = _cfgs(T, E, K, cf)
    pj = jmoe.init_moe_params(jax.random.PRNGKey(seed), cj)
    pt = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in pj.items()}
    x = np.random.default_rng(seed + 1).standard_normal((T, cj.dim)).astype(np.float32)
    return cj, ct, pj, pt, x


def _dropped(logits: np.ndarray, cfg, capacity: int) -> int:
    """Choices JAX's routing drops for these logits."""
    dispatch, _ = jmoe._routing(jnp.asarray(logits), cfg, capacity)
    return logits.shape[0] * cfg.top_k - int(np.asarray(dispatch).sum())


@pytest.mark.parametrize("T,E,K,cf", CASES)
def test_moe_mlp_matches_jax(T, E, K, cf):
    cj, ct, pj, pt, x = _inputs(T, E, K, cf)
    want = np.asarray(jmoe.moe_mlp(pj, jnp.asarray(x), cj))
    got = tmoe.moe_mlp(pt, torch.from_numpy(x), ct)
    assert got.dtype == torch.float32 and got.shape == (T, cj.dim)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)


def test_the_cases_cover_drops():
    """At least three cases drop choices, and the drop-free ones drop none."""
    drops = []
    for T, E, K, cf in CASES:
        cj, _, pj, _, x = _inputs(T, E, K, cf)
        logits = np.array(jmoe.router_logits(pj, jnp.asarray(x)))
        drops.append(_dropped(logits, cj, cj.capacity(T)))
    assert sum(d > 0 for d in drops) >= 3, drops
    assert drops[0] == drops[1] == drops[3] == 0, drops


@pytest.mark.parametrize("T,E,K,cf", CASES)
def test_routing_kept_set_and_places_equal_jax(T, E, K, cf):
    """Every kept (token, expert, place) of JAX's dispatch tensor is the
    port's, and nothing else is."""
    cj, ct, pj, _, x = _inputs(T, E, K, cf)
    logits = np.array(jmoe.router_logits(pj, jnp.asarray(x)))
    capacity = cj.capacity(T)
    dispatch, combine = jmoe._routing(jnp.asarray(logits), cj, capacity)
    want = {tuple(int(i) for i in idx) for idx in np.argwhere(np.asarray(dispatch) > 0)}
    r = tmoe._routing(torch.from_numpy(logits), ct, capacity)
    got = {(t, int(r.experts[t, k]), int(r.positions[t, k]))
           for t in range(T) for k in range(K) if bool(r.kept[t, k])}
    assert got == want
    # The combine weights of the kept places are the port's gates.
    comb = np.asarray(combine)
    for t, e, c in got:
        k = int((r.experts[t] == e).nonzero()[0, 0])
        assert abs(comb[t, e, c] - float(r.gates[t, k])) < 1e-7


@pytest.mark.parametrize("seed", range(4))
def test_routing_flips_only_at_near_ties(seed):
    """On random tokens at bf16-rounded inputs the k chosen experts equal
    JAX's top-k, except where its k-th and (k+1)-th logits are a tie."""
    cj, ct, pj, _, x = _inputs(128, 8, 2, 2.0, seed=seed)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    logits = np.array(jmoe.router_logits(pj, jnp.asarray(x)))
    _, want = jax.lax.top_k(jnp.asarray(logits), 2)
    got = tmoe._routing(torch.from_numpy(logits), ct, ct.capacity(128)).experts.numpy()
    ordered = np.sort(logits, axis=-1)[:, ::-1]
    for t in range(logits.shape[0]):
        if set(np.asarray(want[t]).tolist()) != set(got[t].tolist()):
            assert ordered[t, 1] - ordered[t, 2] < TIE_TOL, t


def test_exact_ties_pick_the_lower_expert_as_jax_does():
    _, ct = _cfgs(4, 8, 2, 2.0)
    logits = np.zeros((4, 8), np.float32)
    logits[1, 5] = logits[1, 6] = 1.0
    _, want = jax.lax.top_k(jnp.asarray(logits), 2)
    got = tmoe._routing(torch.from_numpy(logits), ct, 4).experts.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _rotated(T, E):
    return np.eye(E, dtype=np.float32)[np.arange(T) % E] * 1e-4


@pytest.mark.parametrize("logits", [
    lambda: np.zeros((64, 8), np.float32) + _rotated(64, 8),
    lambda: np.eye(8, dtype=np.float32)[np.zeros(64, int)] * 20,
    lambda: np.random.default_rng(3).standard_normal((50, 4)).astype(np.float32),
    lambda: np.random.default_rng(4).standard_normal((7, 6)).astype(np.float32) * 5,
], ids=["uniform", "hot", "random4", "random6"])
def test_load_balancing_loss_matches_jax(logits):
    lg = logits()
    want = float(jmoe.load_balancing_loss(jnp.asarray(lg), lg.shape[1]))
    got = float(tmoe.load_balancing_loss(torch.from_numpy(lg), lg.shape[1]))
    assert abs(got - want) < LOSS_TOL


def test_load_balancing_loss_is_one_at_uniform_and_large_when_hot():
    uniform = np.zeros((64, 8), np.float32) + _rotated(64, 8)
    assert abs(float(tmoe.load_balancing_loss(torch.from_numpy(uniform), 8)) - 1.0) < 1e-3
    hot = np.eye(8, dtype=np.float32)[np.zeros(64, int)] * 20
    assert float(tmoe.load_balancing_loss(torch.from_numpy(hot), 8)) > 5.0


def test_return_aux_matches_jax():
    cj, ct, pj, pt, x = _inputs(32, 8, 2, 4.0)
    yj, aj = jmoe.moe_mlp(pj, jnp.asarray(x), cj, return_aux=True)
    yt, at = tmoe.moe_mlp(pt, torch.from_numpy(x), ct, return_aux=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=OUT_TOL, rtol=0)
    assert abs(float(at) - float(aj)) < LOSS_TOL


def test_capacity_drop_zeroes_token_output():
    """One expert of capacity 1: only the first token gets a place, every
    later token comes back exactly zero (the residual carries it)."""
    _, ct = _cfgs(8, 1, 1, 0.01)
    params = tmoe.init_moe_params(0, ct, device="cpu")
    x = torch.randn((8, ct.dim), generator=torch.Generator().manual_seed(1))
    assert ct.capacity(8) == 1
    y = tmoe.moe_mlp(params, x, ct)
    assert float(y[1:].abs().max()) == 0.0
    assert float(y[0].abs().max()) > 0.0


def test_bf16_block_is_finite_in_the_input_dtype():
    ct = tmoe.MoEConfig(dim=32, ffn_dim=64, n_experts=8, top_k=2, capacity_factor=4.0)
    params = tmoe.init_moe_params(0, ct, device="cpu")
    x = torch.randn((16, 32), generator=torch.Generator().manual_seed(1)).bfloat16()
    y = tmoe.moe_mlp(params, x, ct)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())


def test_init_keeps_the_router_f32_and_stacks_the_experts():
    ct = tmoe.MoEConfig(dim=32, ffn_dim=48, n_experts=4)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), ct, device="cpu")
    assert p["router"].dtype == torch.float32 and p["router"].shape == (32, 4)
    assert {k: tuple(p[k].shape) for k in ("w1", "w3", "w2")} == {
        "w1": (4, 32, 48), "w3": (4, 32, 48), "w2": (4, 48, 32)}
    assert all(p[k].dtype == torch.bfloat16 for k in ("w1", "w3", "w2"))
    again = tmoe.init_moe_params(0, ct, device="cpu")
    assert torch.equal(again["w2"], tmoe.init_moe_params(0, ct, device="cpu")["w2"])


@pytest.mark.parametrize("T", [1, 7, 64])
def test_capacity_matches_jax(T):
    for _, E, K, cf in CASES:
        cj, ct = _cfgs(T, E, K, cf)
        assert ct.capacity(T) == cj.capacity(T)


def _ep_mesh_at(n: int, rank: int):
    """A mesh object of ``n`` ep ranks seen from ``rank``, with no group
    behind it: enough for what raises, or cuts, before any collective."""
    from tpuslo_torch.parallel import mesh as tmesh

    return tmesh.Mesh(None, torch.device("cpu"), backend="gloo", ranks={"ep": rank},
                      axes=(("ep",), (n,)))


@pytest.mark.parametrize("fn", ["moe_mlp_sharded", "moe_params_specs", "place_moe_params"])
def test_expert_parallelism_waits_for_the_multi_device_slice(fn):
    """Expert parallelism, once the multi-device slice's, is ported: the
    layout table names JAX's split dims, a rank's shard is JAX's
    ``addressable_shards[r].data``, and ``moe_mlp_sharded`` refuses what
    JAX refuses, with its messages, before any collective.  (The sharded
    outputs against JAX: ``test_torch_moe_mesh.py``.)"""
    from jax.sharding import Mesh

    cj, ct, pj, pt, x = _inputs(16, 8, 2, 2.0)
    if fn == "moe_params_specs":
        for axis in ("ep", "experts"):
            want = {k: (list(s).index(axis) if axis in s else None)
                    for k, s in jmoe.moe_params_specs(axis).items()}
            assert tmoe.moe_params_specs(axis) == want
        return
    if fn == "place_moe_params":
        for n in (2, 4):
            placed = jmoe.place_moe_params(pj, Mesh(np.array(jax.devices()[:n]), ("ep",)))
            for r in range(n):
                got = tmoe.place_moe_params(pt, _ep_mesh_at(n, r))
                for k, leaf in placed.items():
                    shard = next(s for s in leaf.addressable_shards
                                 if s.device == jax.devices()[r])
                    np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data))
        return
    for n, rows, what in ((3, 12, "n_experts"), (2, 15, "tokens")):
        xs = jnp.asarray(x[:rows])
        with pytest.raises(ValueError, match=f"{what}=.* not divisible by ep={n}") as jerr:
            jmoe.moe_mlp_sharded(pj, xs, cj, Mesh(np.array(jax.devices()[:n]), ("ep",)))
        with pytest.raises(ValueError) as terr:
            tmoe.moe_mlp_sharded(pt, torch.from_numpy(x[:rows]), ct, _ep_mesh_at(n, 0))
        assert str(terr.value) == str(jerr.value)
