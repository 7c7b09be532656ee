"""Synthetic geometry generators and the token pipeline."""
