"""Tensor ops of the port: distributions, discounting, baselines, K1."""
