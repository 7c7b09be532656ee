"""Synthetic geometry generators."""
