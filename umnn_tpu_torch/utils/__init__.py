"""Logging helpers of the training drivers."""
