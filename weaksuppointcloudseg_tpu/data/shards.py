"""Dataset shard files: ``.npz`` or the reference's ``.h5``, by extension.

The reference ships its ShapeNet and S3DIS blocks as HDF5 shards (fields
``data``/``label``/``pid`` and ``data``/``label``). The same arrays can be
kept in NumPy's ``.npz`` container, which needs no package beyond NumPy;
the synthetic writers produce that form. ``h5py`` is imported only to read
an ``.h5`` shard.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_shard(path: str) -> Dict[str, np.ndarray]:
    """Every array of one shard, keyed by field name."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs the 'h5py' package; install it or "
                "convert the shard to .npz with the same fields") from e
        with h5py.File(path, "r") as f:
            return {k: f[k][:] for k in f.keys()}
    raise ValueError(f"unknown shard type (want .npz or .h5): {path}")


def write_shard(path: str, **arrays: np.ndarray) -> None:
    """Write one ``.npz`` shard with the given fields."""
    if not path.endswith(".npz"):
        raise ValueError(f"shards are written as .npz, got {path}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
