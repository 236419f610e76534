"""The ordering compacted at every step, on the CPU.

On the card both schedules run ``ordering.active_width_order_impl``: step
k at width d - k, the residual update leaving the root's column and label
out of the buffer it writes (``step_passes.residualize``). Here the same
loop runs its plain version (``ordering.compact_residualize``), so its
index arithmetic is checked against a plain Python list of labels, its
order against the masked scan's, and the ``order.pair_terms`` counter
against the pair count of each schedule: d^2 (d - 1) for the composed
masked scan, the stage widths' sum for the staged one, (d + 1) d (d - 1)
/ 3 for the loop compacted at every step.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import api, ordering
from repro_torch.data.simulate import simulate_lingam
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
    order, and the staged schedule's, at widths that reach 1."""
    x = _x(600, d, seed=40 + d) if d > 1 else torch.randn(600, 1)
    red = ordering.LocalReducer()
    masked = ordering.masked_order_impl(x, red)
    every = ordering.active_width_order_impl(x, red)
    assert every.dtype == torch.int64
    assert torch.equal(every, masked)
    assert torch.equal(every, ordering.compact_order_impl(x, red,
                                                          min_stage=2))
    assert sorted(every.tolist()) == list(range(d))


def test_active_width_order_batch_elements_pick_their_own_roots():
    """A batch whose elements pick different roots at the same step: each
    element's order is that of its own fit."""
    xs = torch.stack([_x(500, 7, seed=s) for s in range(4)])
    red = ordering.LocalReducer()
    every = ordering.active_width_order_impl(xs, red)
    singles = torch.stack([ordering.masked_order_impl(xk, red) for xk in xs])
    assert torch.equal(every, singles)
    assert len({tuple(o) for o in every[:, :2].tolist()}) > 1


def test_kernel_path_is_the_card_only():
    """The local plan takes the compacted loop for a CUDA tensor only; on
    the CPU it keeps the schedule it is given."""
    red = ordering.LocalReducer()
    assert red.kernel_path(torch.zeros(4, 3)) is False
    assert red.kernel_path(torch.zeros(2, 4, 3)) is False


def _staged_pairs(d, frac, min_stage):
    return sum(n * w * (w - 1)
               for w, n in ordering._stage_schedule(d, frac, min_stage))


@pytest.mark.parametrize("compaction", ["none", "staged"])
@pytest.mark.parametrize("batch", [None, 3])
def test_pair_terms_counter_on_the_composed_path(compaction, batch):
    """``order.pair_terms`` adds w (w - 1) per moment call, times the
    batch: d^2 (d - 1) for the masked scan, the stage widths' sum for the
    staged schedule; nothing with telemetry off."""
    d = 9
    cfg = api.FitConfig(compaction=compaction, min_stage=3)
    x = (_x(400, d, seed=5) if batch is None
         else torch.stack([_x(400, d, seed=s) for s in range(batch)]))
    api.fit_impl(x, cfg)
    assert _pair_terms() == 0.0
    obs.enable()
    api.fit_impl(x, cfg)
    want = (d * d * (d - 1) if compaction == "none"
            else _staged_pairs(d, cfg.compaction_frac, cfg.min_stage))
    assert _pair_terms() == want * (batch or 1)
    assert want > (d + 1) * d * (d - 1) // 3


@pytest.mark.parametrize("d", [2, 9, 40])
def test_pair_terms_counter_on_the_compacted_loop(d):
    """The loop compacted at every step counts (d + 1) d (d - 1) / 3 pair
    terms, the sum over widths w = d .. 2 of w (w - 1): the count the
    benchmark's roofline needs."""
    x = torch.randn(300, d)
    obs.enable()
    ordering.active_width_order_impl(x, ordering.LocalReducer())
    assert _pair_terms() == (d + 1) * d * (d - 1) // 3
    assert _pair_terms() == sum(w * (w - 1) for w in range(2, d + 1))
