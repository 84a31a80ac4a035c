from repro_torch.core.distances import (d1_pool_distance, d2_anchor_distance,
                                        log_scale, pairwise_distance)
from repro_torch.core.pool import ModelPool

__all__ = ["ModelPool", "d1_pool_distance", "d2_anchor_distance",
           "log_scale", "pairwise_distance"]
