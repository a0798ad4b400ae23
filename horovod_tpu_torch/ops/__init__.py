"""Collectives and kernels of the port."""
