"""Synthetic data made from a seed."""
