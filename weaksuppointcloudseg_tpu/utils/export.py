"""Portable inference export (serving path).

Serializes the trained segmentation forward pass — population-BN eval
mode, weights embedded — to a self-contained StableHLO artifact via
``jax.export``, loadable in any matching-version JAX process WITHOUT this
package on the import path. This is a capability the reference has no
analog for (its deployment story is "re-run test_*.py against a TF1
checkpoint"); a production serving stack wants a frozen, compiler-portable
function.

Each platform's lowering is the one the CLIs run: for ``cuda`` the
artifact embeds the fused kNN Triton kernel (ops/neighbors.py), for every
other platform the plain XLA kNN.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

TRITON_CUSTOM_CALL = "__gpu$xla.gpu.triton"


def export_inference(
    cfg,                      # ExperimentConfig
    params,
    bn_state,
    path: str,
    *,
    batch_size: int,
    num_points: Optional[int] = None,
    platforms: Sequence[str] = ("cpu", "cuda"),
) -> str:
    """Serialize the eval forward to ``path`` (+ a .json shape sidecar).

    The exported callable maps ``x [batch_size, num_points, in_channels]``
    (and ``cat_onehot [batch_size, num_categories]`` when the model has a
    category branch) to class probabilities ``[B, N, num_classes]``.
    """
    from jax import export as jax_export

    from weaksuppointcloudseg_tpu.models.dgcnn import apply_dgcnn_seg

    model = dataclasses.replace(
        cfg.model, **({"num_points": num_points} if num_points else {}))
    n = model.num_points
    has_cat = model.num_categories > 0

    # Freeze weights as constants: the artifact is self-contained.
    params = jax.tree_util.tree_map(np.asarray, params)
    bn_state = jax.tree_util.tree_map(np.asarray, bn_state)

    if has_cat:
        def serve(x, cat_onehot):
            logits, _ = apply_dgcnn_seg(
                params, bn_state, x, cat_onehot, cfg=model, training=False,
                bn_decay=None, rng=jax.random.PRNGKey(0),
                head_bn_fixed_decay=model.head_bn_fixed_decay,
            )
            return jax.nn.softmax(logits, axis=-1)

        args = (
            jax.ShapeDtypeStruct((batch_size, n, model.in_channels),
                                 jnp.float32),
            jax.ShapeDtypeStruct((batch_size, model.num_categories),
                                 jnp.float32),
        )
    else:
        def serve(x):
            logits, _ = apply_dgcnn_seg(
                params, bn_state, x, None, cfg=model, training=False,
                bn_decay=None, rng=jax.random.PRNGKey(0),
                head_bn_fixed_decay=model.head_bn_fixed_decay,
            )
            return jax.nn.softmax(logits, axis=-1)

        args = (
            jax.ShapeDtypeStruct((batch_size, n, model.in_channels),
                                 jnp.float32),
        )

    # the Triton custom call is not on jax.export's list of targets with a
    # stability guarantee: the artifact must be loaded by the same JAX
    # version that wrote it (as the sidecar's loader already assumes)
    exp = jax_export.export(
        jax.jit(serve), platforms=list(platforms),
        disabled_checks=[jax_export.DisabledSafetyCheck.custom_call(
            TRITON_CUSTOM_CALL)],
    )(*args)
    with open(path, "wb") as f:
        f.write(exp.serialize())
    sidecar = {
        "batch_size": batch_size,
        "num_points": n,
        "in_channels": model.in_channels,
        "num_classes": model.num_classes,
        "num_categories": model.num_categories,
        "platforms": list(platforms),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    return path


def load_inference(path: str):
    """Deserialize an exported artifact. Returns (callable, sidecar dict):
    ``callable(x[, cat_onehot]) -> probabilities``."""
    from jax import export as jax_export

    with open(path, "rb") as f:
        exp = jax_export.deserialize(f.read())
    sidecar = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            sidecar = json.load(f)
    return exp.call, sidecar
