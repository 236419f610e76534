"""Variational inference (Stein variational gradient descent)."""
