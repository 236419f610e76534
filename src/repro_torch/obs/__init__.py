"""Observability helpers shared by the serving layers."""
