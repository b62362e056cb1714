"""Every parameter leaf of the train step gets a finite, non-zero gradient:
both presets (ShapeNet, S3DIS) at their full widths, in float32 and
bfloat16 compute, with the dynamic and the static kNN graph, for the Plain
and the Full loss. Identically-zero gradients upstream of a k-max are the
fault a backend once showed for bfloat16; this is the CPU guard, and
chip_smoke.py repeats the check on the card."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

N_POINTS = 32


def _params(cfg):
    params, bn_state = init_dgcnn_seg(jax.random.PRNGKey(0), cfg.model)
    if "transform_net" in params:
        # the reference zero-initialises the transform's output layer,
        # which blocks every gradient into the transform branch at step 0
        tn = dict(params["transform_net"])
        w = tn["transform_out"]["w"]
        tn["transform_out"] = dict(
            tn["transform_out"],
            w=0.01 * jax.random.normal(jax.random.PRNGKey(1), w.shape))
        params = dict(params, transform_net=tn)
    return params, bn_state


def _batch(cfg, rng):
    m = cfg.model
    b = 4                                     # two Siamese pairs
    seg = rng.integers(0, m.num_classes, (b, N_POINTS))
    pts = rng.standard_normal((b // 2, N_POINTS, m.in_channels))
    batch = {
        "data": (np.repeat(pts, 2, axis=0) + 0.01 * rng.standard_normal(
            (b, N_POINTS, m.in_channels))).astype(np.float32),
        "seg_onehot": onehot_encode(seg, m.num_classes),
        "mask": (rng.uniform(size=(b, N_POINTS)) < 0.3).astype(np.float32),
    }
    if m.num_categories:
        batch["cat_onehot"] = onehot_encode(
            np.repeat(rng.integers(0, m.num_categories, b // 2), 2),
            m.num_categories)
    return batch


@pytest.mark.parametrize("style", ["Plain", "Full"])
@pytest.mark.parametrize("static_graph", [False, True],
                         ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_every_leaf_gets_a_gradient(rng, preset, dtype, static_graph, style):
    cfg = getattr(configs, f"{preset}_config")()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_points=N_POINTS, compute_dtype=dtype,
        static_graph=static_graph))
    params, bn_state = _params(cfg)
    batch = _batch(cfg, rng)

    grads = jax.jit(jax.grad(lambda p: _loss_fn(
        p, bn_state, batch, cfg=cfg, style=style, bn_decay=0.5,
        gate=jnp.float32(1.0), rng=jax.random.PRNGKey(2))[0]))(params)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(jax.tree_util.tree_leaves(params))
    for path, g in leaves:
        g = np.asarray(g)
        name = jax.tree_util.keystr(path)
        assert g.dtype == np.float32, name
        assert np.isfinite(g).all(), f"{name} not finite"
        assert np.any(g != 0), f"{name} is identically zero"
