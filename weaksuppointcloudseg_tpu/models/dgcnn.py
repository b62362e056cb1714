"""DGCNN (EdgeConv) segmentation network.

One parameterized implementation covering both reference variants:

- ShapeNet part segmentation (ShapeNet/DGCNN_ShapeNet.py:15-113): k=20,
  EdgeConv spatial transform branch, 3 EdgeConv stages (64-64 / 64-64 / 64),
  1024-d global feature, 16-way category-label embedding concatenated, seg
  head 256/256/128/50 with dropout keep 0.6.
- S3DIS semantic segmentation (S3DIS/DGCNN_S3DIS.py:24-104): 9-channel input,
  kNN graph on normalized-XYZ channels 6:9, no transform net / category
  branch, head 512/256/13 with dropout keep 0.7. The reference's S3DIS head
  layers do not receive the scheduled bn_decay (DGCNN_S3DIS.py:95-101) and so
  fall back to a fixed 0.9 (tf_util.py:523) — reproduced via
  ``head_bn_fixed_decay``.

The graph is recomputed per stage in feature space (dynamic graph). All
EdgeConv "1x1 convs" are channel matmuls; the distance/top-k/gather ops
come from ops/neighbors.py (``nearest_neighbors`` picks the fused kNN
kernel on a GPU). ``ModelConfig.static_graph`` (opt-in, NOT reference
parity) builds the graph once on the input coordinates and reuses it
across stages — the reused stages' kNN selections disappear.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from weaksuppointcloudseg_tpu.configs import ModelConfig
from weaksuppointcloudseg_tpu.models import layers
from weaksuppointcloudseg_tpu.models.transform_net import (
    init_transform_net,
    apply_transform_net,
)
import weaksuppointcloudseg_tpu.ops.neighbors as knn_ops


def _knn_input(x: jax.Array, cfg: ModelConfig) -> jax.Array:
    if cfg.knn_channels is not None:
        lo, hi = cfg.knn_channels
        return x[..., lo:hi]
    return x


def init_dgcnn_seg(key, cfg: ModelConfig) -> Tuple[dict, dict]:
    """Initialize params + BN state pytrees for the segmentation net."""
    params, state = {}, {}
    n_edge_convs = sum(len(s) for s in cfg.edge_channels)
    n_keys = n_edge_convs + 8
    keys = list(jax.random.split(key, n_keys))

    knn_c = (cfg.knn_channels[1] - cfg.knn_channels[0]) if cfg.knn_channels else cfg.in_channels

    if cfg.use_transform_net:
        params["transform_net"], state["transform_net"] = init_transform_net(
            keys.pop(), in_c=2 * knn_c, K=knn_c
        )

    # EdgeConv stages. Stage 0 consumes edge features of the raw input
    # (2 * in_channels); later stages consume edge features of the previous
    # stage's k-max output.
    conv_i = 1
    in_c = cfg.in_channels
    stage_out = []
    for s_i, widths in enumerate(cfg.edge_channels):
        c = 2 * in_c
        for w in widths:
            name = f"adj_conv{conv_i}"
            params[name], state[name] = layers.init_conv(keys.pop(), c, w, bn=True)
            c = w
            conv_i += 1
        in_c = widths[-1]
        stage_out.append(in_c)

    # Global aggregation conv (adj_conv7 in the reference).
    params["agg_conv"], state["agg_conv"] = layers.init_conv(
        keys.pop(), sum(stage_out), cfg.global_channels, bn=True
    )

    global_c = cfg.global_channels
    if cfg.num_categories > 0:
        params["cat_embed"], state["cat_embed"] = layers.init_conv(
            keys.pop(), cfg.num_categories, cfg.category_embed_channels, bn=True
        )
        global_c += cfg.category_embed_channels

    # Segmentation head.
    c = global_c + sum(stage_out)
    for h_i, w in enumerate(cfg.head_channels):
        name = f"seg_conv{h_i + 1}"
        params[name], state[name] = layers.init_conv(keys.pop(), c, w, bn=True)
        c = w
    params["seg_out"], _ = layers.init_conv(keys.pop(), c, cfg.num_classes, bn=False)
    return params, state


def apply_dgcnn_seg(
    params: dict,
    state: dict,
    x: jax.Array,  # [B, N, in_channels]
    cat_onehot: Optional[jax.Array],  # [B, num_categories] or None
    *,
    cfg: ModelConfig,
    training: bool,
    bn_decay,
    rng: Optional[jax.Array] = None,
    head_bn_fixed_decay: Optional[float] = None,
    axis_name=None,
):
    """Forward pass. Returns (logits [B, N, num_classes], new BN state).

    ``axis_name``: shard_map data-parallel axis name. When set, every BN
    computes GLOBAL batch moments via pmean over the axis — the
    cross-replica-BN requirement of SURVEY.md §2.3 (train/steps.py builds
    the shard_map step).
    """
    new_state = dict(state)
    compute_dtype = jnp.dtype(cfg.compute_dtype)
    kw = dict(training=training, bn_decay=bn_decay, eps=cfg.bn_eps,
              axis_name=axis_name)
    head_kw = dict(kw)
    if head_bn_fixed_decay is not None:
        head_kw["bn_decay"] = head_bn_fixed_decay

    # static-graph mode (opt-in, NOT reference parity): one kNN graph on
    # the input coordinates, reused by every EdgeConv stage.
    # ``static_idx`` is that [B, N, k] graph.
    static_idx = None

    # --- Spatial transform branch (ShapeNet only) ---
    if cfg.use_transform_net:
        g = _knn_input(x, cfg)
        idx = knn_ops.nearest_neighbors(g, cfg.k)
        if cfg.static_graph:
            static_idx = idx
        transform, new_state["transform_net"] = apply_transform_net(
            params["transform_net"], state["transform_net"],
            knn_ops.edge_feature(g.astype(compute_dtype), idx),
            K=g.shape[-1], training=training, bn_decay=bn_decay,
            bn_eps=cfg.bn_eps, axis_name=axis_name,
        )
        x = jnp.einsum(
            "bnc,bcd->bnd", x, transform.astype(x.dtype),
            preferred_element_type=jnp.float32,
        ).astype(x.dtype)

    # --- EdgeConv stages (dynamic graph recomputed per stage; with
    # ``static_graph`` every stage reuses the one input-coordinate graph) ---
    feat = x.astype(compute_dtype)
    graph_feat = _knn_input(x, cfg).astype(compute_dtype) if not cfg.use_transform_net else feat
    if cfg.static_graph and static_idx is None:
        static_idx = knn_ops.nearest_neighbors(graph_feat, cfg.k)
    conv_i = 1
    stage_outputs = []
    for s_i, widths in enumerate(cfg.edge_channels):
        src = graph_feat if s_i == 0 else stage_outputs[-1]
        f_in = feat if s_i == 0 else stage_outputs[-1]
        idx = (static_idx if static_idx is not None
               else knn_ops.nearest_neighbors(src, cfg.k))
        name = f"adj_conv{conv_i}"
        h, new_state[name] = layers.apply_edge_conv(
            params[name], state[name], f_in,
            knn_ops.gather_neighbors(f_in, idx), **kw)
        conv_i += 1
        for w in widths[1:]:
            name = f"adj_conv{conv_i}"
            h, new_state[name] = layers.apply_conv(params[name], state[name], h, **kw)
            conv_i += 1
        stage_outputs.append(jnp.max(h, axis=2))  # k-max -> [B, N, C]

    # --- Global feature ---
    concat = jnp.concatenate(stage_outputs, axis=-1)  # [B, N, sum(C)]
    g, new_state["agg_conv"] = layers.apply_conv(
        params["agg_conv"], state["agg_conv"], concat, **kw
    )
    global_feat = jnp.max(g, axis=1)  # [B, global_channels]

    if cfg.num_categories > 0:
        assert cat_onehot is not None, "model was built with a category branch"
        cat, new_state["cat_embed"] = layers.apply_conv(
            params["cat_embed"], state["cat_embed"],
            cat_onehot.astype(compute_dtype), **kw,
        )
        global_feat = jnp.concatenate([global_feat, cat], axis=-1)

    # --- Segmentation head ---
    # First head conv: the global feature is constant over N, so its
    # matmul runs once per sample and broadcasts — the [B, N, global]
    # tile and the [B, N, global+sum(C)] concat never exist in HBM
    # (layers.apply_conv_bcast; reference tf.tile+concat semantics,
    # DGCNN_ShapeNet.py:87-100).
    if rng is None:
        rng = jax.random.PRNGKey(0)
    h, new_state["seg_conv1"] = layers.apply_conv_bcast(
        params["seg_conv1"], state["seg_conv1"],
        global_feat.astype(compute_dtype), concat, **head_kw)
    keep = cfg.head_keep_prob[0]
    if keep is not None:
        rng, sub = jax.random.split(rng)
        h = layers.dropout(h, sub, keep, training=training)
    for h_i, w in enumerate(cfg.head_channels[1:], start=1):
        name = f"seg_conv{h_i + 1}"
        h, new_state[name] = layers.apply_conv(params[name], state[name], h, **head_kw)
        keep = cfg.head_keep_prob[h_i]
        if keep is not None:
            rng, sub = jax.random.split(rng)
            h = layers.dropout(h, sub, keep, training=training)
    logits, _ = layers.apply_conv(
        params["seg_out"], {}, h, training=training, bn_decay=None, relu=False, bn=False
    )
    return logits.astype(jnp.float32), new_state
