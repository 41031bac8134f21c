"""The port's meshes against ``tpuslo.parallel.mesh``: the same
factorization for 1-64 devices and 1, 2 and 4 slices (exact), a
one-device mesh, a plan of more devices refused without a process group,
and, inside spawned gloo ranks, ``make_mesh`` giving JAX's axis names and
sizes for 2, 4 and 8 devices (and 4 over 2 slices) with one subgroup per
axis."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_tp_ranks as ranks  # noqa: E402
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


def test_the_training_shardings_name_13b():
    for fn, args in ((tmesh.param_shardings, (None,)), (tmesh.batch_sharding, (None,)),
                     (tmesh.optimizer_state_shardings, (None, None, None))):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13b"):
            fn(*args)


def test_the_card_is_required_without_a_device_list():
    if torch.cuda.is_available():
        assert tmesh.make_mesh(tmesh.MeshPlan()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(tmesh.MeshPlan())
