"""Differentiable rendering and inverse rendering (the `fit` command)."""
