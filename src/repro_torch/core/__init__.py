from repro_torch.core.distances import (d1_lowrank, d1_moment,
                                        d1_pool_distance, d2_anchor_distance,
                                        log_scale, lowrank_member_sq,
                                        lowrank_pairwise_sq,
                                        pairwise_distance)
from repro_torch.core.pool import (LeafDelta, LowRankDeltaPool, ModelPool,
                                   MomentPool, pool_nbytes)

__all__ = ["LeafDelta", "LowRankDeltaPool", "ModelPool", "MomentPool",
           "d1_lowrank", "d1_moment", "d1_pool_distance",
           "d2_anchor_distance", "log_scale", "lowrank_member_sq",
           "lowrank_pairwise_sq", "pairwise_distance", "pool_nbytes"]
