"""Port's root-cause attribution and query engine against the JAX
reference (the RCA and query tests of tests/test_infer.py).

Both sides take the same fitted graph: the reference's fit, carried into
the port with ``FitResult.from_numpy``, so the answers compare the query
code alone. The reference runs on the CPU with the ``blocked`` backend
and tuning off; the port with ``device="cpu"``.

Tolerances: noise scores, contributions, effects and interventional
moments within 1e-5 absolute plus 1e-5 relative of the reference's
(float32 products and triangular solves of d <= 13, summed in other
orders); the contribution split sums to the target's deviation within
1e-3 (the reference test's bound); the query engine's batches against
the port's own direct calls within 1e-6, and slabbed against whole-batch
RCA within 1e-6 relative and absolute (a product over fewer rows may
round differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.data.simulate import simulate_lingam
from repro.infer import query as jquery
from repro.infer import rca as jrca
from repro_torch.core import api
from repro_torch.infer import effects, intervene, query, rca

torch.set_num_threads(1)

JCFG = japi.FitConfig(backend="blocked", compaction="staged", tune="off")
TOL = dict(rtol=1e-5, atol=1e-5)
# The CPU's matrix product blocks rows by their count, so a slab's rows
# may round differently from the whole batch's (4e-7 seen at |z| ~ 1).
TOL_SLAB = dict(rtol=1e-6, atol=1e-6)


def _fits(gt):
    """The reference's fit of ``gt`` and the same graph in the port."""
    jres = japi.fit_fn(jnp.asarray(gt.data), JCFG)
    res = api.FitResult.from_numpy(np.asarray(jres.order),
                                   np.asarray(jres.adjacency),
                                   np.asarray(jres.resid_var), device="cpu")
    return jres, res


def _anomalous_rows(gt, k, shift, n, seed):
    """Fresh samples from the true SEM with noise of variable k shifted."""
    rng = np.random.default_rng(seed)
    d = gt.adjacency.shape[0]
    e = rng.uniform(0.0, 1.0, size=(n, d))
    e[:, k] += shift
    return np.linalg.solve(np.eye(d) - gt.adjacency, e.T).T.astype(
        np.float32)


def test_rca_matches_reference_and_recovers_injected_noise():
    gt = simulate_lingam(m=20_000, d=8, seed=6)
    jres, res = _fits(gt)
    t_true = np.linalg.inv(np.eye(8) - gt.adjacency)
    k = int(gt.order[0])
    downstream = np.abs(t_true[:, k]) * (np.arange(8) != k)
    target = int(np.argmax(downstream))
    rows = _anomalous_rows(gt, k, shift=6.0, n=32, seed=11)
    mean = gt.data.mean(axis=0)
    got = rca.attribute(res, rows, mean=mean, target=target)
    want = jrca.attribute(jres, rows, mean=mean, target=target)
    np.testing.assert_allclose(got.scores, want.scores, **TOL)
    np.testing.assert_allclose(got.contributions, want.contributions, **TOL)
    np.testing.assert_array_equal(got.root, want.root)
    (gv, gz), (wv, wz) = (zip(*r.ranking(0)) for r in (got, want))
    assert gv == wv
    np.testing.assert_allclose(gz, wz, **TOL)
    assert np.all(got.root == k)
    assert np.abs(got.scores[:, k]).min() > 5.0
    np.testing.assert_allclose(got.contributions.sum(axis=1),
                               rows[:, target] - mean[target], atol=1e-3)


@pytest.mark.parametrize("chunk", [64, 100, 301])
def test_rca_slabs_match_whole_batch(chunk):
    gt = simulate_lingam(m=4000, d=6, seed=8)
    jres, res = _fits(gt)
    rows = gt.data[:301]
    mean = gt.data.mean(axis=0)
    whole = rca.attribute(res, rows, mean=mean, target=3)
    slabbed = rca.attribute(res, rows, mean=mean, target=3, chunk=chunk)
    np.testing.assert_allclose(whole.scores, slabbed.scores, **TOL_SLAB)
    np.testing.assert_allclose(whole.contributions, slabbed.contributions,
                               **TOL_SLAB)
    np.testing.assert_array_equal(whole.root, slabbed.root)
    want = jrca.attribute(jres, rows, mean=mean, chunk=chunk)
    np.testing.assert_allclose(slabbed.scores, want.scores, **TOL)
    assert rca.attribute(res, rows[0], mean=mean).scores.shape == (1, 6)


def test_pad_rows_matches_reference():
    block = np.arange(10, dtype=np.float32).reshape(5, 2)
    for slab in (5, 8, 16):
        np.testing.assert_array_equal(rca._pad_rows(block, slab),
                                      jrca._pad_rows(block, slab))
    b3 = np.ones((2, 3, 4), np.float32)
    np.testing.assert_array_equal(rca._pad_rows(b3, 8, axis=1),
                                  jrca._pad_rows(b3, 8, axis=1))


def _graphs():
    """Fits at two widths, with and without observational moments, in
    both packages."""
    out = {}
    for d in (9, 13):
        gt = simulate_lingam(m=1200, d=d, seed=d)
        jres, res = _fits(gt)
        mean = gt.data.mean(axis=0)
        cov = np.cov(gt.data.T, ddof=0).astype(np.float32)
        out[d] = (jres, res, mean, cov, gt)
    return out


def _mixed(graphs, make_graph, q):
    """The reference test's mixed micro-batch, plus moment-carrying
    graphs and a second RCA row count."""
    g9, g13 = (make_graph(graphs[d]) for d in (9, 13))
    g9m = make_graph(graphs[9], moments=True)
    rows9 = graphs[9][4].data[:7]
    return [
        q.EffectQuery(graph=g9),
        q.EffectQuery(graph=g9m),
        q.EffectQuery(graph=g13),
        q.InterventionQuery(graph=g9, do={0: 1.0}),
        q.InterventionQuery(graph=g9m, do={3: -1.0, 1: 0.5}),
        q.InterventionQuery(graph=g13, do={}),
        q.RCAQuery(graph=g9, rows=np.ones((7, 9), np.float32), target=2),
        q.RCAQuery(graph=g9m, rows=rows9, target=5),
        q.RCAQuery(graph=g13, rows=graphs[13][4].data[:4]),
        q.RCAQuery(graph=g9, rows=rows9[0]),
    ]


def test_query_engine_matches_reference_engine():
    graphs = _graphs()

    def port_graph(g, moments=False):
        _, res, mean, cov, _ = g
        if moments:
            return query.FittedGraph.from_result(res, mean=mean, cov=cov)
        return res

    def ref_graph(g, moments=False):
        jres, _, mean, cov, _ = g
        if moments:
            return jquery.FittedGraph.from_result(jres, mean=mean, cov=cov)
        return jres

    got = query.QueryEngine(batch_size=2, device="cpu").run(
        _mixed(graphs, port_graph, query))
    want = jquery.QueryEngine(batch_size=8).run(
        _mixed(graphs, ref_graph, jquery))
    for g, w in zip(got, want):
        if isinstance(g, query.EffectQuery):
            np.testing.assert_allclose(g.effects, w.effects, **TOL)
        elif isinstance(g, query.InterventionQuery):
            np.testing.assert_allclose(g.mean, w.mean, **TOL)
            np.testing.assert_allclose(g.cov, w.cov, **TOL)
        else:
            np.testing.assert_allclose(g.result.scores, w.result.scores,
                                       **TOL)
            np.testing.assert_array_equal(g.result.root, w.result.root)
            assert g.result.target == w.result.target
            if w.result.contributions is None:
                assert g.result.contributions is None
            else:
                np.testing.assert_allclose(g.result.contributions,
                                           w.result.contributions, **TOL)
        np.testing.assert_allclose(g.graph.mean.numpy(), w.graph.mean,
                                   **TOL)
        np.testing.assert_allclose(g.graph.noise_var.numpy(),
                                   w.graph.noise_var, **TOL)


def test_query_engine_batches_equal_direct_calls():
    """Each answer of a batched group equals the port's direct function
    on that graph alone."""
    graphs = _graphs()
    _, res9, mean9, cov9, gt9 = graphs[9]
    fg = query.FittedGraph.from_result(res9, mean=mean9, cov=cov9)
    qs = query.QueryEngine(batch_size=8, device="cpu").run([
        query.EffectQuery(graph=res9),
        query.EffectQuery(graph=graphs[13][1]),
        query.InterventionQuery(graph=fg, do={0: 1.0}),
        query.InterventionQuery(graph=res9, do={2: -2.0}),
        query.RCAQuery(graph=fg, rows=gt9.data[:6], target=4),
        query.RCAQuery(graph=res9, rows=gt9.data[6:12], target=1),
    ])
    np.testing.assert_allclose(qs[0].effects,
                               effects.total_effects(res9).numpy(), atol=1e-6)
    np.testing.assert_allclose(qs[1].effects, effects.total_effects(
        graphs[13][1]).numpy(), atol=1e-6)
    for q, kw in ((qs[2], dict(mean=mean9, cov=cov9)), (qs[3], {})):
        mu, cov = intervene.interventional_moments(q.graph.result, q.do,
                                                   **kw)
        np.testing.assert_allclose(q.mean, mu, atol=1e-6)
        np.testing.assert_allclose(q.cov, cov, atol=1e-6)
    for q, mean in ((qs[4], mean9), (qs[5], None)):
        direct = rca.attribute(
            api.FitResult(res9.order, res9.adjacency, q.graph.noise_var),
            q.rows, mean=mean, target=q.target)
        np.testing.assert_allclose(q.result.scores, direct.scores,
                                   atol=1e-6)
        np.testing.assert_allclose(q.result.contributions,
                                   direct.contributions, atol=1e-6)


def test_fitted_graph_of_numpy_results_and_unresolved_refs():
    _, res, mean, _, _ = _graphs()[9]
    host = api.FitResult(*res.to_numpy())
    fg = query.FittedGraph.from_result(host, mean=mean, device="cpu")
    assert fg.device.type == "cpu" and fg.d == 9
    (q,) = query.QueryEngine(device="cpu").run([query.EffectQuery(
        graph=host)])
    np.testing.assert_allclose(q.effects, effects.total_effects(res).numpy(),
                               atol=1e-6)
    with pytest.raises(TypeError):
        query.QueryEngine(device="cpu").run(
            [query.EffectQuery(graph="stream-0")])
    with pytest.raises(TypeError, match="unknown query type"):
        query.QueryEngine(device="cpu").run([query.EffectQuery(graph=res),
                                             _NotAQuery(res)])


class _NotAQuery:
    def __init__(self, graph):
        self.graph = graph


def test_rca_and_queries_raise_without_a_card(monkeypatch):
    _, res, _, _, _ = _graphs()[9]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.FittedGraph.from_result(api.FitResult(*res.to_numpy()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.QueryEngine().run([query.EffectQuery(
            graph=api.FitResult(*res.to_numpy()))])
