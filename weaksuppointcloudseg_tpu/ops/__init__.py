from weaksuppointcloudseg_tpu.ops.neighbors import (
    pairwise_sqdist,
    knn,
    gather_neighbors,
    edge_feature,
    knn_graph,
    nearest_neighbors,
)
from weaksuppointcloudseg_tpu.ops.schedules import (
    learning_rate_schedule,
    bn_decay_schedule,
)

__all__ = [
    "pairwise_sqdist",
    "knn",
    "gather_neighbors",
    "edge_feature",
    "knn_graph",
    "nearest_neighbors",
    "learning_rate_schedule",
    "bn_decay_schedule",
]
