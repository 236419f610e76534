"""Runs with the timed path broken underneath (the look for a card
skipped, the rest of a run driven on the CPU at a tiny size): each fault
the cell can have turns ``correct`` false. The cells run on one card, so
none has an exchange between cards to leave out."""

import pytest

from lingambench.tests import helpers

REVERSED_ORDER = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.causal_order_ = out.causal_order_[::-1].copy()
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""

ALTERED_ADJACENCY = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.adjacency_[3, 1] += 0.05
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""

# An ordering step that returns its state (data and active set) unchanged.
UNCHANGED_STEP = """
from repro_torch.core import ordering
def residualize(x, active, root, mu, var, reducer):
    return x, active
ordering.residualize = residualize
"""

# The ordering's answer altered where it is produced (reversed), the rest
# of the fit made consistent with it.
REVERSED_AT_THE_ORDERING = """
from repro_torch.core import ordering
_order = ordering.masked_order_impl
def masked_order_impl(x, reducer, *, d=None):
    return _order(x, reducer, d=d).flip(-1)
ordering.masked_order_impl = masked_order_impl
"""

ALTERED_VAR = """
from repro_torch.core import var_lingam
_fit = var_lingam.VarLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.var_coefs_ = out.var_coefs_ * 1.01
    return out
var_lingam.VarLiNGAM.fit = fit
"""

# A flush that, once the warm-up's slides are done, leaves every
# session's state as it was.
UNCHANGED_STATE = """
from repro_torch.serve import engine
_flush = engine.CausalDiscoveryEngine.flush_streams
_n = [0]
def flush_streams(self):
    _n[0] += 1
    return _flush(self) if _n[0] <= 12 else []
engine.CausalDiscoveryEngine.flush_streams = flush_streams
"""

# The first half of the batch fitted, its fits served for the rest too.
HALF_BATCH_STREAM = """
import torch
from repro_torch.core import batched
from repro_torch.serve import engine
_fit = batched.fit_many_from_stats
def fit_many_from_stats(xs, means, covs, config):
    h = max(1, xs.shape[0] // 2)
    r = _fit(xs[:h], means[:h], covs[:h], config)
    idx = torch.arange(xs.shape[0], device=xs.device) % h
    return type(r)(r.order[idx], r.adjacency[idx], r.resid_var[idx])
engine.lingam_batched.fit_many_from_stats = fit_many_from_stats
"""

HALF_BATCH_BOOTSTRAP = """
import torch
from repro_torch.core import batched
_fit = batched.bootstrap_fits
def bootstrap_fits(x, indices, config):
    h = max(1, indices.shape[0] // 2)
    r = _fit(x, indices[:h], config)
    idx = torch.arange(indices.shape[0], device=x.device) % h
    return type(r)(r.order[idx], r.adjacency[idx], r.resid_var[idx])
batched.bootstrap_fits = bootstrap_fits
"""


@pytest.mark.parametrize("cell, fault", [
    ("lingam-1m-100.fit", REVERSED_ORDER),
    ("lingam-1m-100.fit", ALTERED_ADJACENCY),
    ("lingam-1m-100.fit", UNCHANGED_STEP),
    ("lingam-1m-100.fit", REVERSED_AT_THE_ORDERING),
    ("varlingam-stocks-487.fit", UNCHANGED_STEP),
    ("varlingam-stocks-487.fit", REVERSED_ORDER.replace(
        "direct_lingam.DirectLiNGAM", "var_lingam.VarLiNGAM").replace(
        "import direct_lingam", "import var_lingam")),
    ("varlingam-stocks-487.fit", ALTERED_VAR),
    ("varlingam-stocks-487.stream", UNCHANGED_STATE),
    ("varlingam-stocks-487.stream", HALF_BATCH_STREAM),
    ("varlingam-stocks-487.bootstrap", HALF_BATCH_BOOTSTRAP),
], ids=["reversed-order", "altered-adjacency", "unchanged-step", "reversed-at-the-ordering",
        "var-unchanged-step", "var-reversed-order",
        "altered-var", "stream-unchanged", "stream-half-batch",
        "bootstrap-half-batch"])
def test_a_fault_is_not_correct(tmp_path, cell, fault):
    root = helpers.tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, cell, seconds=0.5,
                                          prelude=fault)
    assert rc == 0, err
    assert last["correct"] is False, last["checks"]


@pytest.mark.parametrize("cell", ["lingam-1m-100.fit",
                                  "varlingam-stocks-487.fit",
                                  "varlingam-stocks-487.stream",
                                  "varlingam-stocks-487.bootstrap"])
def test_the_sound_program_is_correct(tmp_path, cell):
    root = helpers.tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, cell, seconds=0.5)
    assert rc == 0, err
    assert last["correct"] is True, last["checks"]
