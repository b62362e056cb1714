"""DGCNN point-cloud *classification* network.

The reference vendors Wang et al.'s classifier (Networks/dgcnn/models/
dgcnn.py:20-107: transform net, 4 single-conv EdgeConv stages 64/64/64/128,
1024-d aggregation, fc 512 -> 256 -> 40 with dropout 0.5, and a
label-smoothed softmax CE at :101-107). It is not on the segmentation
training path, but it completes the model family — rebuilt here on the same
functional layer/op library as the segmentation nets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from weaksuppointcloudseg_tpu.models import layers
from weaksuppointcloudseg_tpu.models.transform_net import (
    init_transform_net,
    apply_transform_net,
)
import weaksuppointcloudseg_tpu.ops.neighbors as knn_ops


@dataclasses.dataclass(frozen=True)
class ClsConfig:
    num_classes: int = 40
    k: int = 20
    edge_channels: Tuple[int, ...] = (64, 64, 64, 128)
    global_channels: int = 1024
    fc_channels: Tuple[int, ...] = (512, 256)
    keep_prob: float = 0.5
    label_smoothing: float = 0.2
    bn_eps: float = 1e-3
    # one input-coordinate kNN graph reused by every EdgeConv stage
    # (see ModelConfig.static_graph — opt-in speed/accuracy trade)
    static_graph: bool = False


def init_dgcnn_cls(key, cfg: ClsConfig = ClsConfig()) -> Tuple[dict, dict]:
    params, state = {}, {}
    keys = list(jax.random.split(key, len(cfg.edge_channels) + 5))
    params["transform_net"], state["transform_net"] = init_transform_net(
        keys.pop(), in_c=6, K=3
    )
    in_c = 3
    for i, w in enumerate(cfg.edge_channels):
        name = f"dgcnn{i + 1}"
        params[name], state[name] = layers.init_conv(keys.pop(), 2 * in_c, w, bn=True)
        in_c = w
    params["agg"], state["agg"] = layers.init_conv(
        keys.pop(), sum(cfg.edge_channels), cfg.global_channels, bn=True
    )
    c = cfg.global_channels
    for i, w in enumerate(cfg.fc_channels):
        name = f"fc{i + 1}"
        params[name], state[name] = layers.init_conv(keys.pop(), c, w, bn=True)
        c = w
    params["fc_out"], _ = layers.init_conv(keys.pop(), c, cfg.num_classes, bn=False)
    return params, state


def apply_dgcnn_cls(
    params: dict,
    state: dict,
    x: jax.Array,  # [B, N, 3]
    *,
    cfg: ClsConfig = ClsConfig(),
    training: bool,
    bn_decay,
    rng: Optional[jax.Array] = None,
    axis_name=None,  # shard_map DP axis: cross-replica BN (see dgcnn.py)
) -> Tuple[jax.Array, dict]:
    """Forward pass -> (logits [B, num_classes], new BN state)."""
    new_state = dict(state)
    kw = dict(training=training, bn_decay=bn_decay, eps=cfg.bn_eps,
              axis_name=axis_name)

    idx = knn_ops.nearest_neighbors(x, cfg.k)
    static_idx = idx if cfg.static_graph else None  # one graph for every stage
    transform, new_state["transform_net"] = apply_transform_net(
        params["transform_net"], state["transform_net"],
        knn_ops.edge_feature(x, idx),
        K=3, training=training, bn_decay=bn_decay, bn_eps=cfg.bn_eps,
        axis_name=axis_name,
    )
    x = jnp.einsum("bnc,bcd->bnd", x, transform.astype(x.dtype),
                   preferred_element_type=jnp.float32).astype(x.dtype)

    feat = x
    stage_outputs = []
    for i in range(len(cfg.edge_channels)):
        name = f"dgcnn{i + 1}"
        idx = (static_idx if static_idx is not None
               else knn_ops.nearest_neighbors(feat, cfg.k))
        h = knn_ops.edge_feature(feat, idx)
        h, new_state[name] = layers.apply_conv(params[name], state[name],
                                               h, **kw)
        feat = jnp.max(h, axis=2)  # [B, N, C]
        stage_outputs.append(feat)

    concat = jnp.concatenate(stage_outputs, -1)
    g, new_state["agg"] = layers.apply_conv(
        params["agg"], state["agg"], concat, **kw
    )
    h = jnp.max(g, axis=1)  # [B, global]

    if rng is None:
        rng = jax.random.PRNGKey(0)
    for i in range(len(cfg.fc_channels)):
        name = f"fc{i + 1}"
        h, new_state[name] = layers.apply_conv(params[name], state[name], h, **kw)
        rng, sub = jax.random.split(rng)
        h = layers.dropout(h, sub, cfg.keep_prob, training=training)
    logits, _ = layers.apply_conv(params["fc_out"], {}, h,
                                  training=training, bn_decay=None,
                                  relu=False, bn=False)
    return logits, new_state


def classification_loss(logits: jax.Array, labels: jax.Array,
                        label_smoothing: float = 0.2) -> jax.Array:
    """Label-smoothed softmax CE (dgcnn.py:101-107)."""
    k = logits.shape[-1]
    onehot = jax.nn.one_hot(labels, k)
    smoothed = onehot * (1.0 - label_smoothing) + label_smoothing / k
    log_p = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.sum(smoothed * log_p, axis=-1))
