"""The port's mesh plan (``repro_torch.core.sharded``, ``launch.mesh``)
against its local plan and the reference's, the cells of the reference's
``tests/test_mesh_fit.py`` and ``tests/test_sharded.py``.

The 1 x 1 mesh runs in this process (a world of one, set up and torn
down by the port). The multi-rank cells run as four gloo processes on
the CPU, started once for the file by ``torchrun`` with its own timeout
(at most 4 ranks: the suite itself runs on 6 workers). Each rank writes
its results; the tests compare them here with the port's local plan and
the reference's, on the same data.

Bit for bit: every leaf of the gathered finish (``gather_finish=True``)
at (256, 24) over 1 x 1, 2 x 2 and 4 x 1 (both compactions) and at the
non-divisible (250, 23) over 2 x 2 (OLS and adaptive lasso): the order
does not depend on how the samples split at these cells, and the finish
is the local plan's arithmetic on the reassembled data. The moment sums
themselves are bit-equal only where each shard is a whole number of the
kernel's 128-sample sub-sums (1 x 1 and 2 x 2 at m = 256; not 4 x 1,
whose 64-row shards sum in another order, within fp32 rounding). The
sharded finish (``gather_finish=False``) reduces the covariance in
another order and is held to atol 1e-4, rtol 1e-3, the reference's
tolerance (ROADMAP's accepted differences).
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from repro.core import api as japi
from repro.core.ordering import causal_order as jcausal_order
from repro.data.simulate import simulate_lingam as jsimulate_lingam
from repro_torch.core import api, batched, ordering
from repro_torch.data.simulate import simulate_lingam, simulate_var_stocks
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import mesh_cells

torch.set_num_threads(1)

LASSO = dict(prune_method="adaptive_lasso", prune_kwargs=dict(lam=0.05),
             prune_threshold=0.02)
MESHES = {
    "1x1": (("data", 1), ("model", 1)),
    "2x2": (("data", 2), ("model", 2)),
    "4x1": (("data", 4), ("model", 1)),
}


def _x(gt):
    return torch.as_tensor(np.ascontiguousarray(gt.data, np.float32))


def _assert_leaves_equal(a, b):
    for u, v in zip(a.to_numpy() if hasattr(a, "to_numpy") else a,
                    b.to_numpy() if hasattr(b, "to_numpy") else b):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# in process: the 1 x 1 mesh, routing rules, the spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_mesh_1x1_bit_identical_in_process(compaction):
    """The degenerate mesh (1 x 1) in this process: every leaf equals the
    local plan's, the order the reference's, and no process group
    outlives the fit."""
    gt = simulate_lingam(m=250, d=9, seed=0)
    part = api.Partition(mesh=MESHES["1x1"], chunk=64)
    ref = api.fit_fn(_x(gt), api.FitConfig(compaction=compaction,
                                            min_stage=3))
    got = api.fit_fn(_x(gt), api.FitConfig(compaction=compaction,
                                            min_stage=3, partition=part))
    _assert_leaves_equal(ref, got)
    jref = japi.fit_fn(jnp.asarray(jsimulate_lingam(m=250, d=9,
                                                    seed=0).data),
                       japi.FitConfig(compaction=compaction, min_stage=3))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(jref.order))
    assert not dist.is_initialized()


def test_mesh_scope_nests_and_tears_down():
    with launch_mesh.mesh_scope(MESHES["1x1"], "cpu") as outer:
        with launch_mesh.mesh_scope(MESHES["1x1"], "cpu") as inner:
            assert inner is outer  # one world, one mesh
        assert dist.is_initialized()
        assert outer.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_mesh.mesh_from_spec(MESHES["2x2"], "cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        with launch_mesh.mesh_scope(MESHES["2x2"], "cpu"):
            pass


@pytest.mark.parametrize("world,build,shape,names", [
    (256, lambda: launch_mesh.make_production_mesh(device_type="cpu"),
     (16, 16), ("data", "model")),
    (512, lambda: launch_mesh.make_production_mesh(multi_pod=True,
                                                   device_type="cpu"),
     (2, 16, 16), ("pod", "data", "model")),
    (8, lambda: launch_mesh.make_debug_mesh(device_type="cpu"), (4, 2),
     ("data", "model")),
    (12, lambda: launch_mesh.make_debug_mesh(2, 3, pod=2,
                                             device_type="cpu"),
     (2, 2, 3), ("pod", "data", "model")),
])
def test_named_meshes_over_a_world_of_their_size(world, build, shape,
                                                  names):
    """The reference's production layouts (16 x 16, 2 x 16 x 16) and the
    debug mesh, built as rank 0 of a world of their size (torch's fake
    process group stands in for the ranks): the axes, their sizes, and
    one sub-group per axis of that size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = build()
        assert tuple(mesh.mesh.shape) == shape
        assert mesh.mesh_dim_names == names
        for name, size in zip(names, shape):
            assert mesh[name].size() == size
            assert dist.get_world_size(mesh.get_group(name)) == size
        with pytest.raises(ValueError, match="spans"):
            launch_mesh.mesh_from_spec((("data", world * 2),), "cpu")
    finally:
        launch_mesh._MESHES.clear()
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_debug_mesh_defaults_to_the_card():
    """Like every entry point of the port, the debug mesh is a card mesh
    unless the caller asks for the CPU."""
    import inspect

    for fn in (launch_mesh.make_debug_mesh, launch_mesh.make_production_mesh,
               launch_mesh.mesh_from_spec, launch_mesh.mesh_scope,
               launch_mesh.init_from_env):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda", fn.__name__


def test_batched_engine_rejects_partition():
    """The batched and mesh plans are orthogonal; nesting fails loudly."""
    part = api.Partition(mesh=MESHES["1x1"])
    with pytest.raises(ValueError, match="mesh partition"):
        batched.fit_many(torch.zeros((2, 64, 4)),
                         api.FitConfig(partition=part))


def test_fit_from_stats_rejects_partition():
    x = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="local/batched plans only"):
        api.fit_from_stats(x, x.mean(0), torch.eye(4),
                           api.FitConfig(partition=api.Partition()))


def test_partition_spec_validation_matches_reference():
    for kw in (dict(mesh=(("data", 2), ("data", 2))),
               dict(sample_axes=("pod",)),
               dict(pair_axis="data")):
        with pytest.raises(ValueError):
            japi.Partition(**kw)
        with pytest.raises(ValueError):
            api.Partition(**kw)
    p = api.Partition(mesh={"data": 4, "model": 2}, sample_axes="data")
    jp = japi.Partition(mesh={"data": 4, "model": 2}, sample_axes="data")
    assert (p.mesh, p.sample_axes, p.chunk, p.gather_finish) == (
        jp.mesh, jp.sample_axes, jp.chunk, jp.gather_finish)
    assert hash(api.FitConfig(partition=p)) == hash(
        api.FitConfig(partition=api.Partition(
            mesh=(("data", 4), ("model", 2)))))


def test_mesh_staged_compaction_keeps_col_multiple():
    """On a pair axis of 2 the staged ordering's buffers stay even: a
    one-rank mesh reducer of width multiple 2 gives the local order."""

    class Even(ordering.LocalReducer):
        col_multiple = 2

    gt = simulate_lingam(m=300, d=11, seed=4)
    x = _x(gt)
    want = ordering.compact_order_impl(x, ordering.LocalReducer(),
                                       min_stage=3)
    xp = torch.nn.functional.pad(x, (0, 1))
    got = ordering.compact_order_impl(xp, Even(), d=11, min_stage=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# four gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _cells():
    """The cells the four ranks run (``repro_torch.launch.mesh_cells``):
    (256, 24) over each mesh and compaction ("a"); the non-divisible
    (250, 23) over 2 x 2 with chunk 32, OLS and adaptive lasso, gathered
    and sharded finish ("b"); the ordering alone (reference
    tests/test_sharded.py) over 2 x 2 and a pod-style 3-axis mesh, plain
    and fused standardize ("c"); the engine's mesh regime ("e") and
    VarLiNGAM through a partition ("v")."""
    cells = []
    for tag in ("2x2", "4x1"):
        for comp in ("none", "staged"):
            cells.append(dict(key=f"a/{tag}/{comp}", kind="fit", m=256,
                              d=24, seed=0, config=dict(compaction=comp),
                              partition=dict(mesh=MESHES[tag], chunk=64)))
    for gather in (True, False):
        for prune, kw in (("ols", {}), ("lasso", LASSO)):
            cells.append(dict(
                key=f"b/{gather}/{prune}", kind="fit", m=250, d=23, seed=2,
                config=dict(compaction="staged", min_stage=4, **kw),
                partition=dict(mesh=MESHES["2x2"], chunk=32,
                               gather_finish=gather)))
    for fused in (False, True):
        for seed in (0, 1):
            cells.append(dict(key=f"c/{fused}/{seed}", kind="order",
                              m=2000, d=9, seed=seed, mesh=MESHES["2x2"],
                              chunk=256, fused_standardize=fused))
        cells.append(dict(key=f"c/{fused}/pod", kind="order", m=1600, d=7,
                          seed=3, mesh=(("pod", 2), ("data", 1),
                                        ("model", 2)),
                          sample_axes=("pod", "data"), chunk=200,
                          fused_standardize=fused))
    part = dict(mesh=MESHES["2x2"], chunk=64)
    cells.append(dict(key="e", kind="engine", m=256, d=12, n=3,
                      config=dict(compaction="staged"), partition=part))
    cells.append(dict(key="v", kind="varlingam", m=2000, d=10,
                      edge_prob=0.2, seed=0, partition=part,
                      facade=dict(lags=1, prune_threshold=0.1,
                                  compaction="staged")))
    return cells


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the cells as four gloo processes on the CPU; {key: array} of
    each rank's results."""
    out_dir = tmp_path_factory.mktemp("mesh_ranks")
    _, reports, arrays = mesh_cells.launch(_cells(), str(out_dir), nproc=4,
                                           device="cpu", timeout=600)
    assert all(r["collectives"] == "ok" for r in reports), reports
    return arrays


def _fit(ranks, key, rank=0):
    return tuple(ranks[rank][f"{key}/{n}"]
                 for n in ("order", "adjacency", "resid_var"))


def test_every_rank_holds_the_same_results(ranks):
    for r in range(1, 4):
        assert ranks[r].keys() == ranks[0].keys()
        for key, val in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][key], val, err_msg=key)


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "4x1"])
@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_mesh_fit_bit_identical_to_local(ranks, mesh, compaction):
    """(256, 24): the mesh fit's leaves equal the local plan's bit for
    bit, and its order the reference's local order."""
    gt = simulate_lingam(m=256, d=24, seed=0)
    ref = api.fit_fn(_x(gt), api.FitConfig(compaction=compaction))
    if mesh == "1x1":
        got = api.fit_fn(_x(gt), api.FitConfig(
            compaction=compaction,
            partition=api.Partition(mesh=MESHES["1x1"], chunk=64))).to_numpy()
    else:
        got = _fit(ranks, f"a/{mesh}/{compaction}")
    _assert_leaves_equal(ref, got)
    jref = japi.fit_fn(jnp.asarray(jsimulate_lingam(m=256, d=24,
                                                    seed=0).data),
                       japi.FitConfig(compaction=compaction))
    np.testing.assert_array_equal(got[0], np.asarray(jref.order))


@pytest.mark.parametrize("prune", ["ols", "lasso"])
def test_mesh_fit_nondivisible_bit_identical(ranks, prune):
    """(250, 23) over 2 x 2, chunk 32: both axes padded; OLS and adaptive
    lasso leaves equal the local plan's."""
    kw = {} if prune == "ols" else LASSO
    gt = simulate_lingam(m=250, d=23, seed=2)
    ref = api.fit_fn(_x(gt), api.FitConfig(compaction="staged",
                                            min_stage=4, **kw))
    _assert_leaves_equal(ref, _fit(ranks, f"b/True/{prune}"))
    jref = japi.fit_fn(jnp.asarray(jsimulate_lingam(m=250, d=23,
                                                    seed=2).data),
                       japi.FitConfig(compaction="staged", min_stage=4,
                                      **kw))
    np.testing.assert_array_equal(ranks[0][f"b/True/{prune}/order"],
                                  np.asarray(jref.order))


@pytest.mark.parametrize("prune", ["ols", "lasso"])
def test_mesh_sharded_finish_within_tolerance(ranks, prune):
    """``gather_finish=False``: the data are never reassembled, so the
    covariance sums in another order: the same order, coefficients and
    residual variances within atol 1e-4, rtol 1e-3 (the reference's
    tolerance; FISTA's 400 steps amplify the ulps on the lasso path)."""
    kw = {} if prune == "ols" else LASSO
    gt = simulate_lingam(m=250, d=23, seed=2)
    ref = api.fit_fn(_x(gt), api.FitConfig(compaction="staged",
                                            min_stage=4, **kw))
    order, adj, rv = _fit(ranks, f"b/False/{prune}")
    np.testing.assert_array_equal(order, ref.order.numpy())
    np.testing.assert_allclose(adj, ref.adjacency.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(rv, ref.resid_var.numpy(), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_ordering_matches_single_device(ranks, fused):
    """The reference's tests/test_sharded.py cells: 2 x 2 at (2000, 9),
    seeds 0 and 1, and a pod-style 3-axis mesh at (1600, 7), plain and
    with the fused standardize: orders equal the port's local order and
    the reference's."""
    cells = [(2000, 9, s, f"c/{fused}/{s}") for s in (0, 1)]
    cells.append((1600, 7, 3, f"c/{fused}/pod"))
    for m, d, seed, key in cells:
        gt = simulate_lingam(m=m, d=d, seed=seed)
        want = ordering.causal_order(_x(gt)).numpy()
        np.testing.assert_array_equal(ranks[0][key], want, err_msg=key)
        jwant = np.asarray(jcausal_order(jnp.asarray(
            jsimulate_lingam(m=m, d=d, seed=seed).data)))
        np.testing.assert_array_equal(ranks[0][key], jwant, err_msg=key)


def test_mesh_routing_engine_and_varlingam(ranks):
    """A partitioned config handed to the engine or the VarLiNGAM facade
    gives exactly what the mesh plan gives on the same data, and the
    facade recovers the structure as the local one does."""
    for i in range(3):
        got, direct = _fit(ranks, f"e/{i}"), _fit(ranks, f"e/{i}/direct")
        _assert_leaves_equal(got, direct)
        assert sorted(got[0].tolist()) == list(range(12))
    r = ranks[0]
    np.testing.assert_array_equal(r["v/order"], r["v/direct_order"])
    np.testing.assert_array_equal(r["v/b0"], r["v/direct_b0"])
    true_edges = r["v/true_b0"] != 0
    est_edges = np.abs(r["v/b0"]) > 0.1
    assert (true_edges & est_edges).sum() >= 0.6 * true_edges.sum()
    x, _, _ = simulate_var_stocks(m=2000, d=10, edge_prob=0.2, seed=0)
    from repro_torch.core import VarLiNGAM

    local = VarLiNGAM(lags=1, prune_threshold=0.1, compaction="staged",
                      device="cpu").fit(x)
    np.testing.assert_array_equal(r["v/order"], local.causal_order_)
