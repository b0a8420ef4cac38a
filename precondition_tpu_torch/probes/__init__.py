"""Measurement probes of the port's kernels (not the optimizer's path)."""
