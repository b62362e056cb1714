"""Input (XYZ) spatial transform net.

Reimplements Networks/dgcnn/models/transform_nets.py:10-56: edge features ->
conv 64 -> conv 128 -> max over k -> conv 1024 -> max over N -> fc 512 ->
fc 256 -> linear to K*K with zero-initialized weights and identity-initialized
bias, reshaped to a [K, K] transform. Only the ShapeNet model uses it
(ShapeNet/DGCNN_ShapeNet.py:27-29).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from weaksuppointcloudseg_tpu.models import layers


def init_transform_net(key, in_c: int, K: int = 3) -> Tuple[dict, dict]:
    keys = jax.random.split(key, 5)
    params, state = {}, {}
    for name, k_i, ci, co in (
        ("tconv1", keys[0], in_c, 64),
        ("tconv2", keys[1], 64, 128),
        ("tconv3", keys[2], 128, 1024),
        ("tfc1", keys[3], 1024, 512),
        ("tfc2", keys[4], 512, 256),
    ):
        params[name], state[name] = layers.init_conv(k_i, ci, co, bn=True)
    # transform_nets.py:42-51: zero weights, identity bias.
    params["transform_out"] = {
        "w": jnp.zeros((256, K * K), jnp.float32),
        "b": jnp.eye(K, dtype=jnp.float32).reshape(-1),
    }
    return params, state


def apply_transform_net(
    params: dict,
    state: dict,
    edge_feat: jax.Array,  # [B, N, k, 2*C]
    *,
    K: int = 3,
    training: bool,
    bn_decay,
    bn_eps: float = layers.BN_EPS,
    axis_name=None,  # shard_map DP axis: cross-replica BN moments
):
    """Returns (transform [B, K, K], new BN state)."""
    new_state = {}
    kw = dict(training=training, bn_decay=bn_decay, eps=bn_eps,
              axis_name=axis_name)
    net, new_state["tconv1"] = layers.apply_conv(
        params["tconv1"], state["tconv1"], edge_feat, **kw)
    net, new_state["tconv2"] = layers.apply_conv(
        params["tconv2"], state["tconv2"], net, **kw)
    net = jnp.max(net, axis=2)  # max over k -> [B, N, 128]
    net, new_state["tconv3"] = layers.apply_conv(
        params["tconv3"], state["tconv3"], net, **kw)
    net = jnp.max(net, axis=1)  # max over N -> [B, 1024]
    net, new_state["tfc1"] = layers.apply_conv(params["tfc1"], state["tfc1"], net, **kw)
    net, new_state["tfc2"] = layers.apply_conv(params["tfc2"], state["tfc2"], net, **kw)
    out = params["transform_out"]
    transform = net.astype(jnp.float32) @ out["w"] + out["b"]
    return transform.reshape(-1, K, K), new_state
