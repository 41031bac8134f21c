"""The port's ring attention (``tpuslo_torch.ops.ring_attention``) against
``tpuslo.ops.ring_attention``: over 2 and 4 gloo ranks on the CPU against
JAX's ``ring_attention_sharded`` on a JAX CPU mesh of the same size, and
against both packages' ``reference_causal_attention``, with GQA (2 query
heads per kv head) beside it; over one rank bit for bit the call with no
mesh.  Inputs are f32 from a numpy seed, at the JAX test's shape (B 2,
S 8 per rank, D 8), held to 1e-4 (``tests/test_models.py``'s tolerance).
One group of ranks runs per world size (``test_torch_sp_ranks.ring_checks``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import test_torch_sp_ranks as ranks  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402

jring = importlib.import_module("tpuslo.ops.ring_attention")
tring = importlib.import_module("tpuslo_torch.ops.ring_attention")

TOL = 1e-4


def _cases(world: int) -> dict:
    """(q, k, v, n_rep) per case: multi-head, and GQA with 2 query heads
    per kv head."""
    gen = np.random.default_rng(100 + world)
    S = 8 * world

    def normal(*shape):
        return gen.standard_normal(shape, dtype=np.float32)

    return {"mha": (normal(2, S, 2, 8), normal(2, S, 2, 8), normal(2, S, 2, 8), 1),
            "gqa": (normal(2, S, 4, 8), normal(2, S, 2, 8), normal(2, S, 2, 8), 2)}


@pytest.fixture(scope="module")
def groups():
    """One group of ranks per world size, run at its first use."""
    ran: dict = {}

    def get(world: int):
        if world not in ran:
            ran[world] = (_cases(world), tmesh.run_ranks(
                ranks.ring_checks, world, timeout_s=ranks.RANK_TIMEOUT_S,
                args=(_cases(world),)))
        return ran[world]

    return get


def _repeat(x: np.ndarray, n_rep: int) -> np.ndarray:
    return np.repeat(x, n_rep, axis=2)


@pytest.mark.parametrize("world", [2, 4])
def test_the_ring_matches_jax_ring_attention_sharded(groups, world):
    cases, got = groups(world)
    q, k, v, _ = cases["mha"]
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    want = np.asarray(jring.ring_attention_sharded(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), mesh))
    for r in got:
        np.testing.assert_allclose(r["out"]["mha"].numpy(), want, atol=TOL)
    assert all(torch.equal(r["out"]["mha"], got[0]["out"]["mha"]) for r in got)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["mha", "gqa"])
def test_the_ring_matches_both_references(groups, world, case):
    cases, got = groups(world)
    q, k, v, n_rep = cases[case]
    jref = np.asarray(jring.reference_causal_attention(
        jnp.asarray(q), jnp.asarray(_repeat(k, n_rep)), jnp.asarray(_repeat(v, n_rep))))
    tref = tring.reference_causal_attention(
        torch.from_numpy(q), torch.from_numpy(_repeat(k, n_rep)),
        torch.from_numpy(_repeat(v, n_rep))).numpy()
    for r in got:
        np.testing.assert_allclose(r["out"][case].numpy(), jref, atol=TOL)
        np.testing.assert_allclose(r["out"][case].numpy(), tref, atol=TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_kv_travels_the_ring_p_minus_1_times(groups, world):
    """JAX rotates k and v p times and never reads the last rotation; the
    port makes the p - 1 it reads, each at kv-head width."""
    _, got = groups(world)
    for r in got:
        assert r["calls"]["gqa"] == {"shift": 2 * (world - 1)}
        assert r["calls"]["mha"] == {"shift": 2 * (world - 1), "all_gather": 1}


def test_sp1_over_one_gloo_rank_is_the_call_with_no_mesh_bit_for_bit(groups):
    _, (got,) = groups(1)
    for case in ("mha", "gqa"):
        assert torch.equal(got["out"][case], got["no_mesh"][case]), case
        assert got["calls"][case] == {}


@pytest.mark.parametrize("case", ["mha", "gqa"])
def test_the_ring_with_no_mesh_matches_jax(case):
    q, k, v, n_rep = _cases(1)[case]
    got = tring.ring_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               n_rep=n_rep).numpy()
    want = np.asarray(jring.reference_causal_attention(
        jnp.asarray(q), jnp.asarray(_repeat(k, n_rep)), jnp.asarray(_repeat(v, n_rep))))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_an_indivisible_sequence_is_refused():
    mesh = tmesh.Mesh(None, torch.device("cpu"), backend="gloo", axes=(("sp",), (3,)))
    x = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        tring.ring_attention_sharded(x, x, x, mesh)
