"""Layers: dense MLPs and MADE."""
