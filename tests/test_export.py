"""Serving export: serialized StableHLO artifact reproduces the live
forward pass."""

import dataclasses

import numpy as np
import jax
import pytest

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg, apply_dgcnn_seg
from weaksuppointcloudseg_tpu.utils.export import export_inference, load_inference


def tiny_cfg(categories: int):
    base = configs.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=64, num_classes=8, num_categories=categories,
        k=8, global_channels=64, edge_channels=((16, 16), (16,)),
        head_channels=(32, 16), head_keep_prob=(None, None),
        use_transform_net=categories > 0,
    )
    return dataclasses.replace(base, model=model)


@pytest.mark.parametrize("platforms", [("cpu",), ("cpu", "cuda")])
@pytest.mark.parametrize("categories", [4, 0])
def test_export_roundtrip_matches_forward(tmp_path, rng, categories,
                                          platforms):
    """The artifact runs here on the CPU; with ``cuda`` among its
    platforms it also carries the GPU lowering (kNN Triton kernel), which
    a CPU host can produce but not run."""
    cfg = tiny_cfg(categories)
    params, bn_state = init_dgcnn_seg(jax.random.PRNGKey(0), cfg.model)
    path = str(tmp_path / "m.stablehlo")
    export_inference(cfg, params, bn_state, path, batch_size=2,
                     platforms=platforms)
    fn, sidecar = load_inference(path)
    assert sidecar["num_points"] == 64 and sidecar["num_classes"] == 8
    assert tuple(sidecar["platforms"]) == platforms

    x = rng.standard_normal((2, 64, 3)).astype(np.float32)
    args = (x,)
    if categories:
        cat = np.zeros((2, categories), np.float32)
        cat[:, 1] = 1.0
        args = (x, cat)
    got = np.asarray(fn(*args))

    model = cfg.model
    logits, _ = apply_dgcnn_seg(
        params, bn_state, x, args[1] if categories else None,
        cfg=model, training=False, bn_decay=None,
        rng=jax.random.PRNGKey(0),
        head_bn_fixed_decay=model.head_bn_fixed_decay)
    want = np.asarray(jax.nn.softmax(logits, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got.shape == (2, 64, 8)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
