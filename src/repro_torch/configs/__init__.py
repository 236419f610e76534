"""Workload configurations, kept as the port's own copy."""
