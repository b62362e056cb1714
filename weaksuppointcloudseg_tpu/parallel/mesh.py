"""Device mesh + sharding helpers: data parallelism across devices and hosts.

The reference is strictly single-GPU (SURVEY.md §2.3: no NCCL/MPI/tf.distribute
anywhere; CUDA_VISIBLE_DEVICES selection at train_ShapeNet.py:41-42). This
framework supplies data parallelism as a first-class component:

- a 1-D ``jax.sharding.Mesh`` over devices with axis ``"data"`` — local
  devices in a single process, or ALL devices of a multi-host slice after
  ``init_distributed`` (``jax.devices()`` is global once the distributed
  runtime is up);
- batches sharded over the batch axis (``P("data")``), params/state
  replicated; in multi-process runs each host feeds only its local shard via
  ``jax.make_array_from_process_local_data`` (``shard_batch(...,
  process_local=True)``) — the per-host input pipeline of SURVEY.md §5;
- gradient all-reduce and cross-replica batch-norm moments fall out of XLA's
  partitioner: the loss / BN reductions span the sharded batch axis, so the
  compiler inserts the ``psum``s itself (annotate shardings, let XLA place
  collectives). Within a host they run over the device interconnect
  (NVLink between GPUs); only a cross-host hop touches the network.

Siamese pairs are interleaved along the batch axis; batch shards therefore
keep each (sample, augmented-sample) pair on one device as long as the
per-device batch is even — asserted in ``shard_batch``.

An explicit ``shard_map`` step (train/steps.py ``make_train_step(...,
mesh=...)``) is the alternative: every BN pmeans its moments over the mesh
axis and per-shard gradients reduce across shards. Validated leaf-for-leaf
against the single-device step by tests/test_shardmap_dp.py on the
8-virtual-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     **kwargs) -> None:
    """Bring up the multi-host runtime (``jax.distributed.initialize``).

    Call ONCE per process, before any other jax use. Pass the three
    arguments explicitly (coordinator = "host:port" of process 0) unless a
    cluster manager JAX knows sets them in the environment. After this, ``jax.devices()`` returns the global device
    list, ``make_mesh()`` builds a global mesh, and cross-host collectives
    run over the network (Gloo on CPU). No-op if already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices.

    Single-process: local devices. After ``init_distributed``: all devices
    of the job (``jax.devices()`` is global), so the same call builds the
    multi-host mesh.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


@functools.lru_cache(maxsize=None)
def cached_mesh(n_devices: Optional[int] = None) -> Mesh:
    """``make_mesh`` over the process's local devices, built once per size.

    For hot per-call paths (e.g. the sharded label-propagation solver looping
    over S3DIS rooms) where rebuilding the Mesh every invocation is pure
    overhead. The local device list is fixed for the life of the process, so
    caching on ``n_devices`` alone is sound.
    """
    return make_mesh(n_devices)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the mesh."""
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _mesh_process_count(mesh: Mesh) -> int:
    return len({d.process_index for d in mesh.devices.flat})


def shard_batch(batch: Any, mesh: Mesh, *, pair_interleaved: bool = False,
                process_local: bool = False) -> Any:
    """Device-put a pytree of [B, ...] arrays sharded over the batch axis.

    Args:
      pair_interleaved: set for Full-style Siamese batches ([2B] with pairs at
        even/odd positions) — checks pairs don't straddle a device boundary,
        which would break the in-step pair difference.
      process_local: multi-host per-host feeding — each process passes only
        ITS shard of the batch (rows for its own devices, in process order);
        the returned arrays are global ([B_local * num_processes, ...]),
        assembled via ``jax.make_array_from_process_local_data`` with no
        cross-host data movement. Arrays whose leading dim doesn't divide
        the mesh (and scalars) must be identical on every process and are
        replicated.
    """
    n = mesh.devices.size
    sharding = batch_sharding(mesh)
    n_proc = _mesh_process_count(mesh)
    multiproc = process_local and n_proc > 1

    def put(x):
        x = np.asarray(x)
        global_b = x.shape[0] * n_proc if (multiproc and x.ndim) else (
            x.shape[0] if x.ndim else None)
        if x.ndim == 0 or global_b % n != 0:
            if multiproc:
                return jax.make_array_from_process_local_data(
                    replicated_sharding(mesh), x, x.shape)
            return jax.device_put(x, replicated_sharding(mesh))
        if pair_interleaved and (global_b // n) % 2 != 0:
            raise ValueError(
                f"per-device batch {global_b}/{n} must be even to keep "
                "Siamese pairs device-local"
            )
        if multiproc:
            return jax.make_array_from_process_local_data(
                sharding, x, (global_b,) + x.shape[1:])
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (params / optimizer state) across the mesh.

    Multi-host: every process must hold an identical copy (same init seed /
    restored checkpoint); the global replicated arrays are assembled from
    the per-process copies without data movement.
    """
    sharding = replicated_sharding(mesh)
    if _mesh_process_count(mesh) > 1:
        return jax.tree_util.tree_map(
            lambda x: jax.make_array_from_process_local_data(
                sharding, np.asarray(x), np.shape(x)), tree)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
