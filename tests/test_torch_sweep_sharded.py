"""The port's sweep sharded over the ranks of a world, on the CPU.

The rank-side code is ``tests/torch_sweep_worlds.py``.  Two worlds run
every scenario once per module: a world of one rank in the test process
(gloo over an in-process store, taken down after the module) and a gloo
world of four ranks started by ``repro_torch.launch.worlds.run_world``.
The scenarios, on the quad app (P = 4, d = 16), three configs of two
families and three seeds (so both families pad on four shards):

- a 1-D ``("batch",)`` mesh (``make_batch_mesh``) with a ``post`` of the
  time model's breakdown (folded over each run's config index and seed)
  and ``timeit``;
- the ``"pod"`` dimension of ``make_pods_mesh(2, 2, 1)`` (one pod of
  one rank in the world of one), replicated over ``"data"``;
- ``post`` with ``keep_traces=False``, with a leaf that is no tensor
  (each run's own ``(cfg_idx, seed)``, gathered as an object);
- ``tune.frontier(devices=[...])``.

Each is bit-equal on rank 0 to the unsharded sweep and to each run's
``simulate`` and ``post`` in the same world (so at the sharded runs'
thread count), every rank holds the whole result, each rank made its
share of the runs with the padding, and the traces and posts are held to
the JAX package's unsharded ``sweep`` on the same seeds with
``test_torch_sweep``'s budget.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch_sweep_worlds as worlds  # noqa: E402
from test_torch_sweep import _assert_parity, _assert_posts, \
    _jax_breakdown  # noqa: E402

from repro.core import consistency as jc  # noqa: E402
from repro.core.sweep import sweep as jax_sweep  # noqa: E402
from repro_torch.launch.mesh import ensure_world  # noqa: E402
from repro_torch.launch.worlds import run_world  # noqa: E402

WORLDS = ["world1", "world4"]
SCENARIOS = ["batch", "pods", "lean", "frontier"]


@pytest.fixture(scope="module")
def world1():
    """The scenarios in a world of one rank in this process."""
    made = not dist.is_initialized()
    ensure_world(torch.device("cpu"))
    try:
        yield [worlds.sweep_scenarios()]
    finally:
        if made:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world("torch_sweep_worlds:sweep_scenarios", 4,
                     tmp_path_factory.mktemp("sweep_world4"))


@pytest.fixture(scope="module")
def jax_want(quad_app):
    cfgs = worlds.configs(jc)
    return {"traces": jax_sweep(quad_app, cfgs, worlds.T, seeds=worlds.SEEDS),
            "posts": jax_sweep(quad_app, cfgs, worlds.T, seeds=worlds.SEEDS,
                               keep_traces=False, post=_jax_breakdown(3))}


def test_world_shapes(world1, world4):
    assert world1[0]["world"] == 1
    assert world1[0]["batch_mesh"] == [1]
    assert world1[0]["pods_mesh"] == [1, 1, 1]
    assert [r["rank"] for r in world4] == [0, 1, 2, 3]
    assert world4[0]["batch_mesh"] == [4]
    assert world4[0]["pods_mesh"] == [2, 2, 1]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_bit_equal_to_unsharded_and_simulate(request, world, scenario):
    verdict = request.getfixturevalue(world)[0]["verdicts"][scenario]
    assert verdict and all(verdict.values()), verdict


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y)
                                        for x, y in zip(a, b, strict=True))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_rank_holds_the_whole_result(world4, scenario):
    first = world4[0]["results"][scenario]
    for r in world4[1:]:
        got = {k: v for k, v in r["results"][scenario].items()
               if k != "n_runs"}                  # each rank's own count
        want = {k: v for k, v in first.items() if k != "n_runs"}
        assert _tree_equal(got, want), (r["rank"], scenario)


def test_each_rank_runs_its_padded_share(world1, world4):
    """Per family, 6 and 3 runs: padded to 8 and 4 on four shards (2 + 1
    runs a rank), to 6 and 4 over two pods (3 + 2); ``timeit`` runs
    twice.  One rank runs all 9."""
    assert {k: world1[0]["results"][k]["n_runs"]
            for k in ("batch", "pods", "lean")} == \
        {"batch": 18, "pods": 9, "lean": 9}
    for r in world4:
        assert {k: r["results"][k]["n_runs"]
                for k in ("batch", "pods", "lean")} == \
            {"batch": 6, "pods": 5, "lean": 3}
    res = world4[0]["results"]["batch"]
    assert res["traces"][0]["staleness"].shape == \
        (len(worlds.SEEDS), worlds.T, worlds.P, worlds.P)
    assert res["windows"] == [6, 5, 6]        # ssp family: s = 4 + 2
    assert world4[0]["results"]["lean"]["traces"] == [None] * 3


@pytest.mark.parametrize("world", WORLDS)
def test_padded_runs_carry_their_own_index_and_seed(request, world):
    """Each config's posts come back in seed order with the run's own
    config index and seed, the padding sliced off; a leaf that is no
    tensor comes back as a list."""
    posts = request.getfixturevalue(world)[0]["results"]["lean"]["posts"]
    for i, p in enumerate(posts):
        assert p["run"] == [(i, sd) for sd in worlds.SEEDS]


class _Run:
    """Seed ``j`` of a batched numpy trace, as a `Trace`-like object."""

    def __init__(self, batched, j):
        for k, v in batched.items():
            setattr(self, k, None if v is None or isinstance(v, dict)
                    else v[j])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", ["batch", "pods", "lean"])
def test_held_to_jax_sweep(request, jax_want, world, scenario):
    res = request.getfixturevalue(world)[0]["results"][scenario]
    want = jax_want
    for i in range(len(worlds.configs(jc))):
        if scenario != "lean":
            for j in range(len(worlds.SEEDS)):
                _assert_parity(_Run(res["traces"][i], j),
                               want["traces"].trace(i, j),
                               f"{world}:{scenario}[{i}, {j}]")
        if scenario != "pods":
            _assert_posts(res["posts"][i], want["posts"].post(i),
                          f"{world}:{scenario} post[{i}]")
