"""Optimizer, train step and training-loop helpers."""
