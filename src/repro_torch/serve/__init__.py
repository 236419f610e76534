"""Serving: :class:`~repro_torch.serve.engine.CausalDiscoveryEngine`,
batched fit requests, streaming sessions with batched refits and drift
alerts, and causal queries, on the card."""

from .engine import CausalDiscoveryEngine, FitRequest, FlushError  # noqa: F401
