"""Platform policy: which of two equivalent formulations each site runs.

A stage with two exact engines whose choice depends on the device holds
that choice here as one field, keyed by JAX platform name; the site reads
``policy()`` at trace time instead of testing the platform itself. Both
engines of every field give identical results (tested), so a policy
changes only speed. An unknown platform raises rather than inheriting
another platform's choices. A field exists only while two platforms need
different values; a choice every platform shares is a constant at its
site.

Fields:
  dbscan_blocks     per-block DBSCAN: "cuda" (native/dbscan_blocks.cu) |
                    "jnp" (cluster.dbscan.dbscan_blocks)
"""
from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class PlatformPolicy:
    dbscan_blocks: str


POLICIES = {
    "cpu": PlatformPolicy(dbscan_blocks="jnp"),
    "gpu": PlatformPolicy(dbscan_blocks="cuda"),
}


def policy(platform: str | None = None) -> PlatformPolicy:
    """The policy of ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return POLICIES[platform]
    except KeyError:
        raise ValueError(f"no platform policy for {platform!r}; known: "
                         f"{sorted(POLICIES)}") from None
