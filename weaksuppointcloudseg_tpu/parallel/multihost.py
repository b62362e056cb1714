"""Multi-host (multi-process) data-parallel execution.

The reference has no distributed execution of any kind (SURVEY.md §2.3);
this module supplies the multi-host layer of the rebuild: bring up the
distributed runtime (``mesh.init_distributed``), build the global mesh, feed
each host only its local batch shard (``mesh.shard_batch(...,
process_local=True)``), and let XLA's partitioner place the cross-host
collectives (gradient psum + cross-replica BN).

``run_worker`` is a self-contained one-train-step worker used two ways:

- the CI test (tests/test_multihost.py) launches 2 subprocesses x 4 CPU
  devices on localhost and asserts the resulting loss equals the
  single-process 8-device run — the multi-host analog of the DP
  equivalence test;
- ``python -m weaksuppointcloudseg_tpu.parallel.multihost <pid> <nproc>
  <port> <devs_per_proc> <out_file>`` runs one worker by hand (also what
  ``__graft_entry__.dryrun_multichip`` uses for its multi-process mode).

On a real multi-host GPU cluster the same sequence applies with
``init_distributed(coordinator, num_processes, process_id)``, the real
per-host loaders, and the real config.
"""

from __future__ import annotations

import json
import os
import sys


def _tiny_config(num_points: int = 64, unique_bs: int = 8):
    import dataclasses

    from weaksuppointcloudseg_tpu import configs

    cfg = configs.shapenet_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=num_points, num_classes=6,
            num_categories=4),
        train=dataclasses.replace(cfg.train, batch_size=unique_bs,
                                  style="Full"),
    )


def make_global_batch(cfg, seed: int = 0):
    """Deterministic Full-style global batch — identical on every process."""
    import numpy as np

    from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

    rng = np.random.default_rng(seed)
    b = 2 * cfg.train.batch_size
    n = cfg.model.num_points
    k = cfg.model.num_classes
    seg = rng.integers(0, k, (b, n))
    return {
        "data": rng.standard_normal((b, n, 3)).astype(np.float32),
        "seg": seg.astype(np.int32),
        "seg_onehot": onehot_encode(seg, k),
        "mask": (rng.uniform(size=(b, n)) < 0.3).astype(np.float32),
        "cat_onehot": onehot_encode(
            rng.integers(0, cfg.model.num_categories, (b,)),
            cfg.model.num_categories),
        "valid": np.ones((b,), np.float32),
    }


def run_one_step(mesh, cfg, *, process_local: bool):
    """One Full-style train step on ``mesh``; returns the loss scalar.

    ``process_local=True``: each process feeds only its row block of the
    deterministic global batch (per-host feeding); False: the whole batch
    (single-process path).
    """
    import numpy as np
    import jax

    from weaksuppointcloudseg_tpu.parallel import mesh as pmesh
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import make_train_step

    batch = make_global_batch(cfg)
    if process_local:
        n_proc = jax.process_count()
        b = batch["data"].shape[0]
        assert b % n_proc == 0
        lo = jax.process_index() * (b // n_proc)
        hi = lo + b // n_proc
        batch = {k: v[lo:hi] for k, v in batch.items()}
    batch = pmesh.shard_batch(batch, mesh, pair_interleaved=True,
                              process_local=process_local)

    state = create_train_state(jax.random.PRNGKey(0), cfg)
    state = pmesh.replicate(state, mesh)
    train_step = make_train_step(cfg)
    # numpy gate/key: jit treats host-numpy inputs as process-replicated
    new_state, metrics = train_step(state, batch, np.float32(1.0),
                                    np.asarray(jax.random.PRNGKey(1)))
    return float(metrics["total"]), float(metrics["acc"])


def run_worker(process_id: int, num_processes: int, port: int,
               devices_per_proc: int, out_file: str) -> None:
    """Entry for one process of a localhost multi-process CPU run.

    MUST be called in a fresh interpreter before any jax backend use (the
    XLA flag below is read at backend init; the platform pin must go
    through jax.config — env vars can be captured too early when a
    sitecustomize pre-imports jax).
    """
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from weaksuppointcloudseg_tpu.parallel import mesh as pmesh

    pmesh.init_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=num_processes,
                           process_id=process_id)
    assert jax.process_count() == num_processes
    mesh = pmesh.make_mesh()  # global: all processes' devices
    loss, acc = run_one_step(mesh, _tiny_config(), process_local=True)
    if process_id == 0:
        with open(out_file, "w") as f:
            json.dump({"loss": loss, "acc": acc,
                       "devices": jax.device_count(),
                       "processes": jax.process_count()}, f)


if __name__ == "__main__":
    run_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               int(sys.argv[4]), sys.argv[5])
