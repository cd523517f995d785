"""The port's hierarchical runtime (``repro_torch.pods``) on the CPU.

One gloo world of four ranks, a 2 x 2 x 1 ``("pod", "data", "model")``
mesh, started once for the module by
``repro_torch.launch.worlds.run_world``; the rank-side code is
``tests/torch_psrun_worlds.py::pods_scenarios``.  On the quad app
(P = 8, two pods of four workers, two worker shards a pod):

- ``cross_validate_pods`` for all five models (two-tier configs), the
  wired path and a pod outage: bsp, ssp and essp bit-identical to the
  port's ``simulate``, vap within the budget with exact decisions, the
  staleness bound and the replica divergence within their bounds (the
  value-divergence envelope for vap);
- ``run_with_pod_rejoin``: the spliced state equals the live one leaf by
  leaf (``splice_exact``), the three segments equal the uninterrupted
  churned run, the rejoined pod's reads keep the staleness bound, on the
  dense path and the wired one (drain and drop);
- a config whose ``n_pods`` is not the mesh's pod axis raises;
- every rank returns the same results.
"""
import pytest
import torch_psrun_worlds as worlds

from repro_torch.launch.worlds import run_world
from repro_torch.psrun import validate as tval

MODELS = list(worlds.MODELS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("torch_psrun_worlds:pods_scenarios", 4,
                     tmp_path_factory.mktemp("pods_world4"),
                     args=((2, 2, 1),))


def test_every_rank_agrees(world):
    assert [r["world"] for r in world] == [4] * 4
    for other in world[1:]:
        assert other["cross"] == world[0]["cross"]
        assert other["rejoin"] == world[0]["rejoin"]


@pytest.mark.parametrize("case", MODELS + ["wired", "essp_pod_outage"])
def test_cross_validate_pods(world, case):
    res = world[0]["cross"][case]
    assert res["ok"], res
    model = "essp" if case in ("wired", "essp_pod_outage") else case
    if model in ("bsp", "ssp", "essp"):
        assert all(v == 0.0 for v in res["max_diff"].values())
    if model == "vap":
        assert res["decisions_exact"]
        assert max(res["max_ulp"].values()) <= tval.VAP_ULP_BUDGET


@pytest.mark.parametrize("case", ["ssp", "essp", "wired", "essp_pod_outage"])
def test_replica_divergence_within_bound(world, case):
    div = world[0]["cross"][case]["replica_divergence"]
    assert div["ok"] and div["max"] <= div["bound"], div


def test_vap_replica_value_divergence(world):
    vdiv = world[0]["cross"]["vap"]["replica_value_divergence"]
    assert vdiv["ok"], vdiv


@pytest.mark.parametrize("case", ["essp", "wired_drain", "wired_drop"])
def test_pod_rejoin_is_bit_exact(world, case):
    r = world[0]["rejoin"][case]
    assert r["splice_exact"]
    assert all(r["equal_to_uninterrupted"].values()), \
        r["equal_to_uninterrupted"]
    assert r["staleness_post"]["violations"] == 0


def test_mismatched_n_pods_raises(world):
    assert "must match the mesh pod axis" in world[0]["n_pods_guard"]
