"""PointBatch: struct-of-arrays point-cloud container (fixed capacity, masked).

Data-parallel replacement for the reference's ``Point3D``/``ClusObj`` object model
(reference DataModel.cs:14-160). Everything is a flat jax.Array so the whole
pipeline stays traceable/shardable; dynamic sizes become a ``valid`` mask over a
static capacity (SURVEY.md §7 hard part (e)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointBatch:
    """A padded batch of scanner points.

    Fields mirror reference Point3D (DataModel.cs:102-160):
      xyz    f[N,3]  Cartesian coords (Point3D.X/Y/Z)
      motor  f[N,2]  raw motor/encoder angles (Point3D.motor_x/motor_y)
      rng    f[N]    raw range reading (Point3D.Distance)
      label  i32[N]  cluster id, 0 = noise (Point3D.clusterId)
      mult   i32[N]  duplicate multiplicity (Point3D.ptsCount)
      valid  bool[N] padding mask (replaces dynamic List<> length)
      path_id i32[N] source-file index (Point3D.pathId; drives the per-file
                     visibility tree FrmMain.cs:2497-2609 and per-file range
                     filtering FrmMain.cs:1116-1130)
    """

    xyz: jax.Array
    motor: jax.Array
    rng: jax.Array
    label: jax.Array
    mult: jax.Array
    valid: jax.Array
    path_id: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def count(self) -> jax.Array:
        """Number of valid points (traced)."""
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    @staticmethod
    def empty(capacity: int, dtype=jnp.float32) -> "PointBatch":
        return PointBatch(
            xyz=jnp.zeros((capacity, 3), dtype),
            motor=jnp.zeros((capacity, 2), dtype),
            rng=jnp.zeros((capacity,), dtype),
            label=jnp.zeros((capacity,), jnp.int32),
            mult=jnp.ones((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool),
            path_id=jnp.zeros((capacity,), jnp.int32),
        )

    @staticmethod
    def from_arrays(
        xyz,
        motor=None,
        rng=None,
        label=None,
        mult=None,
        valid=None,
        path_id=None,
        capacity: Optional[int] = None,
        dtype=jnp.float32,
    ) -> "PointBatch":
        """Build a PointBatch from host arrays, padding to ``capacity``."""
        xyz = np.asarray(xyz)
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")

        def pad(a, fill, dt, shape_tail=()):
            a = np.asarray(a)
            out = np.full((cap,) + shape_tail, fill, dtype=dt)
            out[:n] = a
            return jnp.asarray(out)

        motor = np.zeros((n, 2)) if motor is None else motor
        rng_ = np.zeros((n,)) if rng is None else rng
        label = np.zeros((n,), np.int32) if label is None else label
        mult = np.ones((n,), np.int32) if mult is None else mult
        valid = np.ones((n,), bool) if valid is None else valid
        path_id = np.zeros((n,), np.int32) if path_id is None else path_id
        np_dt = np.dtype(jnp.dtype(dtype).name)
        return PointBatch(
            xyz=pad(xyz, 0.0, np_dt, (3,)),
            motor=pad(motor, 0.0, np_dt, (2,)),
            rng=pad(rng_, 0.0, np_dt),
            label=pad(label, 0, np.int32),
            mult=pad(mult, 1, np.int32),
            valid=pad(valid, False, bool),
            path_id=pad(path_id, 0, np.int32),
        )

    def with_labels(self, label: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, label=label)

    def with_valid(self, valid: jax.Array) -> "PointBatch":
        return dataclasses.replace(self, valid=valid)

    def to_numpy(self) -> dict:
        """Device -> host; strips padding."""
        v = np.asarray(self.valid)
        return {
            "xyz": np.asarray(self.xyz)[v],
            "motor": np.asarray(self.motor)[v],
            "rng": np.asarray(self.rng)[v],
            "label": np.asarray(self.label)[v],
            "mult": np.asarray(self.mult)[v],
            "path_id": np.asarray(self.path_id)[v],
        }


def concat(batches: list, capacity: Optional[int] = None) -> PointBatch:
    """Concatenate PointBatches (host-side helper)."""
    parts = [b.to_numpy() for b in batches]
    xyz = np.concatenate([p["xyz"] for p in parts])
    return PointBatch.from_arrays(
        xyz,
        motor=np.concatenate([p["motor"] for p in parts]),
        rng=np.concatenate([p["rng"] for p in parts]),
        label=np.concatenate([p["label"] for p in parts]),
        mult=np.concatenate([p["mult"] for p in parts]),
        path_id=np.concatenate([p["path_id"] for p in parts]),
        capacity=capacity,
    )
