"""Train state: params + BN stats + Adam state + step counter, one pytree.

The reference keeps this spread over TF1 graph variables (model vars, the
Adam slots created by ``AdamOptimizer.minimize``, the ``batch`` step var —
ShapeNet/ShapeNet_DGCNN_trainer.py:36-44,105-106). Here it is one functional
pytree so a checkpoint is complete by construction and the whole step is a
pure jittable function.

The learning rate is injected per-step via ``optax.inject_hyperparams`` so
the staircase sample-count schedule (ops/schedules.py) stays exactly the
reference's (driven by step * batch_size, floor 1e-5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from weaksuppointcloudseg_tpu.configs import ExperimentConfig
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    bn_state: Any
    opt_state: Any
    step: jax.Array  # int32 scalar
    # static (part of the treedef, not a leaf): jit retraces if it changes
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True))

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)

    def apply_gradients(self, grads, learning_rate) -> "TrainState":
        # write the scheduled LR into the injected hyperparams
        opt_state = self.opt_state
        opt_state.hyperparams["learning_rate"] = learning_rate
        updates, new_opt_state = self.tx.update(grads, opt_state, self.params)
        return self.replace(
            params=optax.apply_updates(self.params, updates),
            opt_state=new_opt_state,
            step=self.step + 1,
        )


def make_optimizer() -> optax.GradientTransformation:
    """Adam with TF1 defaults (lr injected per step).

    tf.train.AdamOptimizer: beta1=0.9, beta2=0.999, eps=1e-8
    (ShapeNet_DGCNN_trainer.py:105 uses defaults apart from the schedule).
    """
    return optax.inject_hyperparams(optax.adam)(
        learning_rate=0.0, b1=0.9, b2=0.999, eps=1e-8
    )


def create_train_state(
    key: jax.Array, cfg: ExperimentConfig
) -> TrainState:
    params, bn_state = init_dgcnn_seg(key, cfg.model)
    tx = make_optimizer()
    return TrainState(
        params=params,
        bn_state=bn_state,
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
        tx=tx,
    )
