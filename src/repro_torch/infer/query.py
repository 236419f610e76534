"""Query engine: micro-batched causal queries over fitted graphs.

  * :class:`FittedGraph` -- a :class:`~repro_torch.core.api.FitResult`
    plus the observational context queries need (data mean,
    structural-noise moments), as tensors on the fit's device; buildable
    from a one-shot fit (:meth:`FittedGraph.from_result`) or a live
    streaming session (:meth:`FittedGraph.from_session`: moments from
    the session's incremental store, no rows re-read).
  * :class:`EffectQuery` / :class:`InterventionQuery` /
    :class:`RCAQuery` -- the three request kinds; answers come back as
    numpy arrays on the host.
  * :class:`QueryEngine` -- admits a mixed list of requests, groups them
    by (query kind, device, graph shape; RCA also by its row count), and
    answers each group of up to ``batch_size`` requests with one batched
    computation: the triangular solves and products over a leading batch
    axis of graphs, the reference's ``jit(vmap(...))`` written out.
    Unlike the reference, which pads every group to a power of two to
    bound its compiles, the port batches the real requests only.

Interventions use dense (d,) do-masks
(:func:`repro_torch.infer.intervene.do_arrays`), so requests targeting
*different* variables still share a group. The serving side
(:meth:`repro_torch.serve.engine.CausalDiscoveryEngine.query`) resolves
stream-session ids to :class:`FittedGraph`\\ s and delegates here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core import api

from . import effects as effects_lib
from . import intervene as intervene_lib
from . import rca as rca_lib


def _on(result: api.FitResult, device) -> api.FitResult:
    """``result`` with tensor fields on ``device`` (numpy fields, as the
    serving engine's fit results hold, are moved there)."""
    return api.FitResult(*(
        torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                        device=device)
        for v in (result.order, result.adjacency, result.resid_var)))


@dataclasses.dataclass
class FittedGraph:
    """A fitted graph plus the observational context queries consume, as
    tensors on one device."""

    result: api.FitResult
    mean: torch.Tensor        # (d,) observational mean of the fitted space
    noise_mean: torch.Tensor  # (d,) E[e] implied by the moments
    noise_var: torch.Tensor   # (d,) Var e (resid_var unless moments given)
    sid: Optional[str] = None  # originating stream session, if any: the
    #                            serving engine re-snapshots live sessions
    #                            on every query

    @property
    def d(self) -> int:
        return int(self.result.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.result.adjacency.device

    @classmethod
    def from_result(cls, result: api.FitResult, *, mean=None, cov=None,
                    device=None) -> "FittedGraph":
        """Wrap a one-shot fit. ``mean``/``cov`` are the training data's
        observational moments; omitted, the data is taken as centered and
        the noise variances fall back to ``resid_var``. ``device`` moves
        the fit there (default: where its tensors are; numpy fields need
        one)."""
        if device is not None or not torch.is_tensor(result.adjacency):
            result = _on(result, api.resolve_device(
                "cuda" if device is None else device))
        dev = result.adjacency.device
        d = int(result.order.shape[0])
        mu = (torch.zeros((d,), device=dev) if mean is None
              else torch.as_tensor(mean, dtype=torch.float32, device=dev))
        adj = result.adjacency.float()
        if cov is None:
            r = torch.eye(d, device=dev) - adj
            nm, nv = r @ mu, result.resid_var.float()
        else:
            nm, nv = intervene_lib.noise_stats(
                adj, mu, torch.as_tensor(cov, device=dev))
        return cls(result=result, mean=mu, noise_mean=nm, noise_var=nv)

    @classmethod
    def from_session(cls, session) -> "FittedGraph":
        """Wrap a streaming session's current estimate.

        The instantaneous graph ``B0`` comes from the session's last
        refit; the observational mean is the rolling window's (sliced
        from the lag-augmented moment store, no rows re-read), and the
        noise statistics are ``(I - B0) mu`` with the refit's residual
        variances: contemporaneous-equilibrium answers, not multi-step
        forecasts (:func:`repro_torch.infer.effects.var_irf` propagates
        lags).
        """
        if session.last_fit is None:
            raise ValueError(
                f"session {session.sid!r} has no estimate yet "
                "(window not full or no refit flushed)"
            )
        result = session.last_fit.result
        d = int(result.order.shape[0])
        mu = session.rolling.aug_state.mean[:d].float()
        r = (torch.eye(d, device=mu.device)
             - result.adjacency.float())
        return cls(
            result=result,
            mean=mu,
            noise_mean=r @ mu,
            noise_var=result.resid_var.float(),
            sid=session.sid,
        )


GraphRef = Union["FittedGraph", api.FitResult, str]


@dataclasses.dataclass
class EffectQuery:
    """Total-effect matrix of one graph. Answer: ``effects`` (d, d)."""

    graph: GraphRef
    effects: Optional[np.ndarray] = None


@dataclasses.dataclass
class InterventionQuery:
    """Post-intervention moments under ``do``. Answer: ``mean`` (d,),
    ``cov`` (d, d)."""

    graph: GraphRef
    do: Mapping[int, float] = dataclasses.field(default_factory=dict)
    mean: Optional[np.ndarray] = None
    cov: Optional[np.ndarray] = None


@dataclasses.dataclass
class RCAQuery:
    """Root-cause attribution of ``rows``. Answer: ``result``
    (:class:`repro_torch.infer.rca.RCAResult`)."""

    graph: GraphRef
    rows: np.ndarray = None
    target: Optional[int] = None
    result: Optional[rca_lib.RCAResult] = None


class QueryEngine:
    """Grouped, micro-batched execution of causal queries.

    Mixed request lists are grouped by (kind, device, d), RCA also by its
    row count, and each group runs in parts of at most ``batch_size``
    requests, each part one batched computation on the graphs' device.
    A bare :class:`FitResult` is wrapped with centered-data defaults on
    its own device, or on ``device`` when its fields are numpy arrays.
    """

    def __init__(self, *, batch_size: int = 8, device="cuda"):
        self.batch_size = batch_size
        self.device = device

    def _resolve(self, q) -> FittedGraph:
        if isinstance(q.graph, api.FitResult):
            q.graph = FittedGraph.from_result(
                q.graph, device=None if torch.is_tensor(q.graph.adjacency)
                else self.device)
        if not isinstance(q.graph, FittedGraph):
            raise TypeError(
                f"unresolved graph ref {type(q.graph).__name__}: string "
                "session ids are resolved by CausalDiscoveryEngine.query"
            )
        return q.graph

    def run(self, queries: List[object]) -> List[object]:
        groups: Dict[object, List[object]] = {}
        for q in queries:
            g = self._resolve(q)
            if isinstance(q, EffectQuery):
                key = ("effects", str(g.device), g.d)
            elif isinstance(q, InterventionQuery):
                key = ("intervention", str(g.device), g.d)
            elif isinstance(q, RCAQuery):
                rows = np.asarray(q.rows, np.float32)
                q.rows = rows[None, :] if rows.ndim == 1 else rows
                key = ("rca", str(g.device), g.d, q.rows.shape[0])
            else:
                raise TypeError(f"unknown query type {type(q).__name__}")
            groups.setdefault(key, []).append(q)
        for key, group in groups.items():
            runner = getattr(self, f"_run_{key[0]}")
            for start in range(0, len(group), self.batch_size):
                runner(group[start:start + self.batch_size])
        return queries

    @staticmethod
    def _stack_graphs(part):
        gs = [q.graph for q in part]
        adj = torch.stack([g.result.adjacency.float() for g in gs])
        order = torch.stack([g.result.order.long() for g in gs])
        return gs, adj, order

    def _run_effects(self, part):
        _, adj, order = self._stack_graphs(part)
        out = effects_lib.total_effects_impl(adj, order).cpu().numpy()
        for i, q in enumerate(part):
            q.effects = out[i]

    def _run_intervention(self, part):
        gs, adj, order = self._stack_graphs(part)
        dev = adj.device
        masks, values = zip(*(intervene_lib.do_arrays(gs[0].d, q.do)
                              for q in part))
        mask = torch.as_tensor(np.stack(masks), device=dev)
        mu = intervene_lib.interventional_mean_impl(
            adj, order, mask, torch.as_tensor(np.stack(values), device=dev),
            torch.stack([g.noise_mean for g in gs]))
        cov = intervene_lib.interventional_cov_impl(
            adj, order, mask, torch.stack([g.noise_var for g in gs]))
        mu, cov = mu.cpu().numpy(), cov.cpu().numpy()
        for i, q in enumerate(part):
            q.mean, q.cov = mu[i], cov[i]

    def _run_rca(self, part):
        gs, adj, order = self._stack_graphs(part)
        dev = adj.device
        rows = np.stack([q.rows for q in part])  # (b, n, d)
        slab = rca_lib._sample_slab(rows.shape[1])
        targets = torch.as_tensor(
            [0 if q.target is None else int(q.target) for q in part],
            device=dev)
        means = torch.stack([g.mean for g in gs])
        noise_var = torch.stack([g.noise_var for g in gs])
        scores_parts, contrib_parts = [], []
        for start in range(0, rows.shape[1], slab):
            block = rows[:, start:start + slab]
            k = block.shape[1]
            padded = torch.as_tensor(rca_lib._pad_rows(block, slab, axis=1),
                                     device=dev)
            s, c = rca_lib._rca(adj, order, padded, means, noise_var,
                                targets)
            scores_parts.append(s[:, :k].cpu().numpy())
            contrib_parts.append(c[:, :k].cpu().numpy())
        scores = np.concatenate(scores_parts, axis=1)
        contrib = np.concatenate(contrib_parts, axis=1)
        for i, q in enumerate(part):
            q.result = rca_lib.RCAResult(
                scores=scores[i],
                root=np.argmax(np.abs(scores[i]), axis=1),
                target=q.target,
                contributions=contrib[i] if q.target is not None else None,
            )
