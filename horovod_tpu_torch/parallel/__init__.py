"""Parallelism strategies of the port."""

from .sp import ring_attention  # noqa: F401
