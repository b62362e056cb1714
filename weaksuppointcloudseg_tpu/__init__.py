"""weaksuppointcloudseg_tpu — weakly supervised point cloud segmentation in JAX.

A from-scratch JAX / XLA / Pallas framework with the capabilities of
alex-xun-xu/WeakSupPointCloudSeg (CVPR 2020, "Weakly Supervised Semantic Point
Cloud Segmentation: Towards 10x Fewer Labels"): DGCNN segmentation on ShapeNet
part segmentation and S3DIS semantic segmentation under incomplete supervision
(masked cross-entropy on a small labelled fraction), with Siamese augmentation
consistency, inexact/MIL category supervision, spatial smoothness Laplacian
regularization, and inference-time probabilistic label propagation.

Design: functional core (pure jitted step functions over params/state pytrees),
data-parallel sharding over a `jax.sharding.Mesh`, Pallas kernels for the
EdgeConv hot loop, host-side prefetching data pipelines.
"""

__version__ = "0.1.0"
