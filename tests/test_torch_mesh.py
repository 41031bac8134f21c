"""The port's meshes against ``tpuslo.parallel.mesh``: the same
factorization for 1-64 devices and 1, 2 and 4 slices (exact), a
one-device mesh, a plan of more devices refused without a process group,
and, inside spawned gloo ranks, ``make_mesh`` giving JAX's axis names and
sizes for 2, 4 and 8 devices (and 4 over 2 slices) with one subgroup per
axis, and ``sp_mesh`` giving the JAX tests' one-axis ``("sp",)`` mesh,
over which ``all_reduce`` sums and, with ``op="max"``, takes JAX's
``pmax``."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_sp_ranks as sp_ranks  # noqa: E402
import test_torch_tp_ranks as ranks  # noqa: E402
import test_torch_train_mesh_ranks as train_ranks  # noqa: E402
from tpuslo.parallel import mesh as jmesh  # noqa: E402
from tpuslo_torch.parallel import mesh as tmesh  # noqa: E402


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_plan_for_devices_matches_jax(slices):
    for n in range(1, 65):
        if slices > 1 and n % slices:
            with pytest.raises(ValueError, match="not divisible"):
                jmesh.plan_for_devices(n, slices)
            with pytest.raises(ValueError, match="not divisible"):
                tmesh.plan_for_devices(n, slices)
            continue
        want = jmesh.plan_for_devices(n, slices)
        got = tmesh.plan_for_devices(n, slices)
        assert (got.dp, got.fsdp, got.tp, got.dcn) == (want.dp, want.fsdp, want.tp, want.dcn)
        assert got.n_devices == want.n_devices == n


def test_one_device_mesh_on_the_cpu():
    mesh = tmesh.make_mesh(tmesh.plan_for_devices(1), devices=["cpu"])
    assert mesh.device == torch.device("cpu")
    assert mesh.plan == tmesh.MeshPlan() and mesh.plan.n_devices == 1


@pytest.mark.parametrize("plan", [tmesh.plan_for_devices(2), tmesh.plan_for_devices(8),
                                  tmesh.MeshPlan(dcn=2)])
def test_a_multi_device_mesh_is_refused(plan):
    """Without an initialized process group a plan of more than one
    device raises and says how to start ranks; no one-device mesh is
    built in its place."""
    with pytest.raises(RuntimeError, match="run_ranks"):
        tmesh.make_mesh(plan, devices=["cpu"] * 8)


@pytest.mark.parametrize("n,slices", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_make_mesh_in_ranks_gives_jaxs_axes(n, slices):
    want = jmesh.make_mesh(jmesh.plan_for_devices(n, slices), jax.devices()[:n])
    got = tmesh.run_ranks(ranks.mesh_axes, n, timeout_s=ranks.RANK_TIMEOUT_S, args=(slices,))
    devices = want.devices  # rank r sits where device r sits in JAX's mesh
    for r, view in enumerate(got):
        assert view["axis_names"] == list(want.axis_names)
        assert view["shape"] == dict(want.shape)
        coords = [int(c[0]) for c in np.nonzero(devices == jax.devices()[r])]
        assert [view["ranks"][a] for a in want.axis_names] == coords
        for axis in want.axis_names:
            # The sum of the rank ids over the axis's group: the ranks whose
            # coordinates differ from r's on that axis alone.
            a = list(want.axis_names).index(axis)
            idx = [slice(None) if i == a else c for i, c in enumerate(coords)]
            members = [d.id for d in devices[tuple(idx)].reshape(-1)]
            assert view["sums"][axis] == sum(members), axis


def test_sp_mesh_in_ranks_gives_jaxs_axis_and_reduces_by_sum_and_max():
    from jax.sharding import Mesh

    want = Mesh(np.array(jax.devices()[:3]), ("sp",))
    got = tmesh.run_ranks(sp_ranks.sp_mesh_checks, 3, timeout_s=ranks.RANK_TIMEOUT_S)
    for r, view in enumerate(got):
        assert view["axis_names"] == list(want.axis_names)
        assert view["shape"] == dict(want.shape) and view["rank"] == r
        assert view["plan"] is None
        assert view["sum"] == [3.0, 30.0]
        assert view["max"] == view["max_bf16"] == [2.0, 20.0]
        assert view["x_after"] == [float(r), float(10 * r)]  # a new tensor; x unchanged
        assert view["calls"] == {"all_reduce": 1, "all_reduce_max": 2}


def test_the_collectives_have_their_transposes_under_autograd():
    """In 2 gloo ranks, ``sum(y * c_r)`` of each collective's output ``y``
    for rank-dependent cotangents ``c_r``: each input's gradient is what
    the transpose gives (all_reduce and copy_to: the sum of the ranks'
    cotangents; reduce_from: the rank's own; all_gather: its part of the
    sum; reduce_scatter: its cotangent gathered; shift: the next rank's;
    all_to_all: the inverse exchange of the cotangents), and the backward's
    calls are counted."""
    got = tmesh.run_ranks(train_ranks.autograd_collectives_rank, 2,
                          timeout_s=train_ranks.RANK_TIMEOUT_S)

    def c(r, cols=4):
        return train_ranks.cotangent(r, cols)

    for r, out in enumerate(got):
        want = {
            "all_reduce": c(0) + c(1),
            "copy_to": c(0) + c(1),
            "reduce_from": c(r),
            "all_gather": (c(0, 8) + c(1, 8))[:, 4 * r:4 * r + 4],
            "reduce_scatter": torch.cat([c(0, 2), c(1, 2)], dim=1),
            "shift": c((r + 1) % 2),
            "all_to_all": torch.cat([c(i)[:, 2 * r:2 * r + 2] for i in range(2)], dim=1),
        }
        for op, grad in want.items():
            np.testing.assert_allclose(out[op]["grad"], grad.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"rank {r} {op}")
        assert out["all_gather"]["calls"] == {"all_gather": 1, "reduce_scatter": 1}
        assert out["reduce_scatter"]["calls"] == {"reduce_scatter": 1, "all_gather": 1}
        assert out["shift"]["calls"] == {"shift": 2}
        assert out["all_to_all"]["calls"] == {"all_to_all": 2}
        assert out["all_reduce"]["calls"] == {"all_reduce": 2}
        assert out["copy_to"]["calls"] == {"all_reduce": 1}
        assert out["reduce_from"]["calls"] == {"all_reduce": 1}


def test_place_and_gather_leaf_round_trip_on_every_layout():
    """Each rank's :func:`place_leaf` part of a leaf, over a tuple of axes
    too, is the row-major run JAX's sharding gives it; a mesh of one rank
    keeps the whole leaf (as a copy)."""
    leaf = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    one = tmesh.Mesh(tmesh.MeshPlan(), torch.device("cpu"))
    part = tmesh.place_leaf(leaf, {0: ("dp", "fsdp"), 1: "tp"}, one)
    assert torch.equal(part, leaf) and part.data_ptr() != leaf.data_ptr()
    assert tmesh.gather_leaf(part, {0: "fsdp"}, one) is part
    plan = tmesh.MeshPlan(dp=2, fsdp=2, tp=2)
    for dp in range(2):
        for fsdp in range(2):
            for tp in range(2):
                mesh = tmesh.Mesh(plan, torch.device("cpu"),
                                  ranks={"dp": dp, "fsdp": fsdp, "tp": tp})
                got = tmesh.place_leaf(leaf, {0: ("dp", "fsdp"), 1: "tp"}, mesh)
                row = dp * 2 + fsdp
                assert torch.equal(got, leaf[2 * row:2 * row + 2, 3 * tp:3 * tp + 3])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.place_leaf(leaf, {1: ("dp", "fsdp")}, mesh)


def test_the_card_is_required_without_a_device_list():
    if torch.cuda.is_available():
        assert tmesh.make_mesh(tmesh.MeshPlan()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(tmesh.MeshPlan())
