"""Mesh construction helpers.

The reference is single-device (its only interconnect is the BRAM read bus,
SURVEY.md SS1); this design scales over a device mesh with two logical
axes:

- ``data``: independent byte streams (the generalization of the reference's
  dual-stream mode) / corpus shards,
- ``seq``: sequence parallelism — blocks of one stream spread over chips,
  with seam composition across devices (SURVEY.md SS5.7-5.8),
- ``model``: tensor parallelism — the STATE dimension of very large NFA
  tables sharded over chips (SURVEY.md SS2.2 "shard the S-dimension"),
  combined per step with a ``psum`` (``tp_scan.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_tp_mesh", "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def make_mesh(
    n_data: int | None = None,
    n_seq: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (data, seq) mesh.  Default: all devices on the data axis."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_seq
    if n_data * n_seq != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_seq} does not cover {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_data, n_seq)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS))


def make_tp_mesh(
    n_model: int | None = None,
    n_data: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (data, model) mesh for state-sharded (tensor-parallel) scans.

    Default: all devices on the model axis.  Lay the model axis innermost so
    the per-step ``psum`` of successor counts stays within a data row.
    """
    devices = devices if devices is not None else jax.devices()
    if n_model is None:
        n_model = len(devices) // n_data
    if n_data * n_model != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} does not cover {len(devices)} devices"
        )
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))
