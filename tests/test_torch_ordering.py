"""The local plan's ordering, compacted at every step, on the CPU.

The local plan runs ``ordering.masked_order_impl`` on every device
and for both compactions: step k at width d - k, the residual update
leaving the root's column and label out of the buffer it writes (on the
card ``step_passes.residualize``, here its plain version
``ordering.compact_residualize``). So its index arithmetic is checked
against a plain Python list of labels, its order against the mesh plan's
composed schedules (``full_width_order_impl``, ``compact_order_impl``), and
the ``order.pair_terms`` counter against the pair count of each schedule:
d^2 (d - 1) for the masked scan, the stage widths' sum for the staged
one, (d + 1) d (d - 1) / 3 for the loop compacted at every step. The
step's scores and root: ``step_passes.scores_root`` on a CPU tensor is
``ordering.step_scores`` and ``torch.argmax``, the first of tied maxima
winning; the CPU's step keeps that composed path (``order.scores`` spans
with ``path="composed"``, no ``order.scores_kernel`` count).
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import api, measures, ordering
from repro_torch.data.simulate import simulate_lingam
from repro_torch.kernels import step_passes
from repro_torch.obs import metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.reset_all()
    yield
    obs.disable()
    obs.reset_all()


def _x(m, d, seed):
    gt = simulate_lingam(m=m, d=d, seed=seed)
    return torch.tensor(np.ascontiguousarray(gt.data), dtype=torch.float32)


def _pair_terms():
    return metrics.snapshot()["counters"].get("order.pair_terms", 0.0)


def _spans(spans):
    for sp in spans:
        yield sp
        yield from _spans(sp.children)


def _span_names(spans):
    for sp in _spans(spans):
        yield sp.name


def _tied_moments(twins, w, seed=0):
    """(cm1, cm2, M1, M2), float32 (b, w) and (b, w, w), one element per
    entry of ``twins``: element k's columns ``twins[k]`` score 0, the best
    score, and every other column below it (their residuals on the twins
    have the largest entropy, and the twins' residuals on them a small
    one); an empty entry makes every column alike, so all scores tie."""
    g = measures.GAMMA
    rng = np.random.default_rng(seed)
    b = len(twins)
    m1 = g + 0.05 * rng.random((b, w, w))
    m2 = 0.1 * rng.standard_normal((b, w, w))
    cm1, cm2 = np.full((b, w), g + 0.02), np.full((b, w), 0.05)
    for k, ts in enumerate(twins):
        if not ts:
            m1[k], m2[k] = g + 0.03, 0.07
        for t in ts:
            m1[k, :, t], m2[k, :, t] = g + 0.5, 0.3
        for t in ts:
            m1[k, t, :], m2[k, t, :] = g, 0.0
    return tuple(torch.tensor(a, dtype=torch.float32)
                 for a in (cm1, cm2, m1, m2))


def test_survivors_keep_a_list_of_labels():
    """Dropping a root column by ``survivors`` keeps the labels a Python
    list keeps with ``pop``: each batch element drops its own root, at
    every width down to one column."""
    rng = np.random.default_rng(0)
    d, b = 11, 4
    want = [list(range(d)) for _ in range(b)]
    labels = torch.arange(d).expand(b, d)
    for w in range(d, 1, -1):
        root = torch.tensor(rng.integers(0, w, size=b))
        picked = [lst.pop(int(r)) for lst, r in zip(want, root)]
        assert torch.gather(labels, -1, root[:, None])[:, 0].tolist() == picked
        labels = torch.gather(labels, -1, ordering.survivors(root, w))
        assert labels.tolist() == want
    assert ordering.survivors(torch.tensor(0), 2).tolist() == [1]
    assert ordering.survivors(torch.tensor(1), 2).tolist() == [0]


@pytest.mark.parametrize("w,root", [(2, 0), (2, 1), (5, 0), (5, 2), (5, 4)])
def test_compact_residualize_is_the_masked_update_without_the_root(w, root):
    """The plain compacting update: the masked update's other columns bit
    for bit, in order; the root's label at position k of the order and,
    at w = 2, the surviving label after it; the other labels in order."""
    x = _x(400, w, seed=w + root)
    red = ordering.LocalReducer()
    _, _, mu, var = ordering.step_standardize(x, red)
    r = torch.tensor(root)
    full, _ = ordering.residualize(x, torch.ones(w, dtype=torch.bool), r,
                                   mu, var, red)
    labels = torch.arange(10, 10 + w)
    order = torch.full((w + 3,), -1, dtype=torch.int64)
    x_new, labels_new = ordering.compact_residualize(x, r, mu, var, labels,
                                                     order, 2, red)
    keep = [j for j in range(w) if j != root]
    assert torch.equal(x_new, full[:, keep])
    assert labels_new.tolist() == [10 + j for j in keep]
    assert order[2] == 10 + root
    if w == 2:
        assert order[3] == 10 + keep[0]
    assert order[:2].tolist() == [-1, -1]


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 9])
def test_active_width_order_equals_masked(d):
    """On the CPU the loop compacted at every step gives the masked scan's
    order, and the staged schedule's, at widths that reach 1; columns
    past ``d`` (padding) are left out."""
    x = _x(600, d, seed=40 + d) if d > 1 else torch.randn(600, 1)
    red = ordering.LocalReducer()
    masked = ordering.full_width_order_impl(x, red)
    every = ordering.masked_order_impl(x, red)
    assert every.dtype == torch.int64
    assert torch.equal(every, masked)
    assert torch.equal(every, ordering.compact_order_impl(x, red,
                                                          min_stage=2))
    padded = torch.cat([x, torch.zeros(x.shape[0], 2)], dim=-1)
    assert torch.equal(every, ordering.masked_order_impl(padded, red, d=d))
    assert sorted(every.tolist()) == list(range(d))


def test_active_width_order_batch_elements_pick_their_own_roots():
    """A batch whose elements pick different roots at the same step: each
    element's order is that of its own fit."""
    xs = torch.stack([_x(500, 7, seed=s) for s in range(4)])
    red = ordering.LocalReducer()
    every = ordering.masked_order_impl(xs, red)
    singles = torch.stack([ordering.full_width_order_impl(xk, red)
                           for xk in xs])
    assert torch.equal(every, singles)
    assert len({tuple(o) for o in every[:, :2].tolist()}) > 1


def _staged_pairs(d, frac, min_stage):
    return sum(n * w * (w - 1)
               for w, n in ordering._stage_schedule(d, frac, min_stage))


@pytest.mark.parametrize("compaction", ["none", "staged"])
@pytest.mark.parametrize("batch", [None, 3])
def test_pair_terms_counter_on_the_composed_path(compaction, batch):
    """``order.pair_terms`` adds w (w - 1) per moment call, times the
    batch, on the mesh plan's composed schedules: d^2 (d - 1) for the
    masked scan, the stage widths' sum for the staged schedule; nothing
    with telemetry off."""
    d, frac, min_stage = 9, 0.25, 3
    x = (_x(400, d, seed=5) if batch is None
         else torch.stack([_x(400, d, seed=s) for s in range(batch)]))

    def order():
        red = ordering.LocalReducer()
        if compaction == "none":
            return ordering.full_width_order_impl(x, red)
        return ordering.compact_order_impl(x, red, frac=frac,
                                           min_stage=min_stage)

    order()
    assert _pair_terms() == 0.0
    obs.enable()
    order()
    want = (d * d * (d - 1) if compaction == "none"
            else _staged_pairs(d, frac, min_stage))
    assert _pair_terms() == want * (batch or 1)
    assert want > (d + 1) * d * (d - 1) // 3


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_local_fit_runs_the_compacted_loop(compaction):
    """``fit_fn`` on the CPU runs the loop compacted at every step whatever
    ``compaction`` is: the masked scan's order, sum_{w=2..d} w (w - 1)
    pair terms, and no stage gather (``order.compact``)."""
    d = 9
    x = _x(500, d, seed=11)
    obs.enable()
    got = api.fit_fn(x, api.FitConfig(compaction=compaction, min_stage=3))
    assert _pair_terms() == sum(w * (w - 1) for w in range(2, d + 1))
    names = list(_span_names(obs.roots()))
    assert names.count("order.standardize") == d - 1
    assert "order.compact" not in names
    obs.disable()
    assert torch.equal(got.order, ordering.full_width_order_impl(
        x, ordering.LocalReducer()))


@pytest.mark.parametrize("d", [2, 9, 40])
def test_pair_terms_counter_on_the_compacted_loop(d):
    """The loop compacted at every step counts (d + 1) d (d - 1) / 3 pair
    terms, the sum over widths w = d .. 2 of w (w - 1): the count the
    benchmark's roofline needs."""
    x = torch.randn(300, d)
    obs.enable()
    ordering.masked_order_impl(x, ordering.LocalReducer())
    assert _pair_terms() == (d + 1) * d * (d - 1) // 3
    assert _pair_terms() == sum(w * (w - 1) for w in range(2, d + 1))


@pytest.mark.parametrize("twins", [[(2, 5)], [(2, 5), (0, 6), (), (3, 4)]])
def test_scores_root_plain_version_is_step_scores_and_argmax(twins):
    """On a CPU tensor ``scores_root`` is ``step_scores`` with every column
    active and ``torch.argmax``, unbatched and for a batch: tied best
    columns go to the first of them, and an element whose scores all tie
    to column 0; no kernel launch is counted."""
    cm1, cm2, m1, m2 = _tied_moments(twins, 7)
    if len(twins) == 1:
        cm1, cm2, m1, m2 = cm1[0], cm2[0], m1[0], m2[0]
    before = step_passes.scores_launches
    root, k_list = step_passes.scores_root(cm1, cm2, m1, m2)
    want = ordering.step_scores(cm1, cm2, m1, m2,
                                torch.ones(cm1.shape, dtype=torch.bool))
    assert torch.equal(k_list, want)
    assert torch.equal(root, torch.argmax(want, dim=-1))
    assert root.dtype == torch.int64 and root.shape == cm1.shape[:-1]
    assert root.reshape(-1).tolist() == [ts[0] if ts else 0 for ts in twins]
    for k, ts in enumerate(twins):
        scores = k_list.reshape(len(twins), -1)[k]
        if ts:
            assert scores[list(ts)].eq(0).all()
            others = [c for c in range(7) if c not in ts]
            assert scores[others].lt(0).all()
        else:
            assert scores.eq(scores[0]).all()
    assert step_passes.scores_launches == before


def test_step_root_on_the_cpu_keeps_the_composed_path():
    """The compacting loop on a CPU tensor scores every step with the
    composed function: each ``order.scores`` span says
    ``path="composed"``, ``order.scores_kernel`` counts nothing, and the
    step's root is the argmax of ``step_scores``."""
    d = 6
    x = _x(500, d, seed=3)
    red = ordering.LocalReducer()
    before = step_passes.scores_launches
    obs.enable()
    order = ordering.masked_order_impl(x, red)
    st, root = ordering._step_root(x, None, red)
    spans = [sp for sp in _spans(obs.roots()) if sp.name == "order.scores"]
    counters = metrics.snapshot()["counters"]
    obs.disable()
    assert [sp.attrs.get("path") for sp in spans] == ["composed"] * d
    assert "order.scores_kernel" not in counters
    assert step_passes.scores_launches == before
    m1, m2 = red.moment_rows(st.x_std, st.c)
    want = ordering.step_scores(*red.col_moments(st.x_std), m1, m2,
                                torch.ones(d, dtype=torch.bool))
    assert int(root) == int(torch.argmax(want)) == int(order[0])


def test_scores_root_raises_on_a_device_it_does_not_take():
    """Off the CPU and the card the wrapper raises: no quiet fallback."""
    cm1, cm2, m1, m2 = (t.to("meta") for t in _tied_moments([(1, 2)], 4))
    with pytest.raises(ValueError, match="no score kernel for meta"):
        step_passes.scores_root(cm1, cm2, m1, m2)
