"""Parallelism strategies of the port."""

from .sp import (  # noqa: F401
    ring_attention,
    stripe_tokens,
    striped_ring_attention,
    ulysses_attention,
    unstripe_tokens,
)
