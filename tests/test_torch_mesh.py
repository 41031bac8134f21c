"""The port's mesh plans against ``tpuslo.parallel.mesh``: the same
factorization for 1-64 devices and 1, 2 and 4 slices (exact), a
one-device mesh, and a refusal naming ROADMAP item 13 for more."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

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
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        tmesh.make_mesh(plan, devices=["cpu"] * 8)


def test_the_card_is_required_without_a_device_list():
    if torch.cuda.is_available():
        assert tmesh.make_mesh(tmesh.MeshPlan()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(tmesh.MeshPlan())
