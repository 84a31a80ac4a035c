"""FedELMY's pools, distances and Eq. 9 objective (port of
``repro/core``). The ``run_*`` drivers are deprecated wrappers over
`repro_torch.api.launch`."""
from repro_torch.core.baselines import BASELINES
from repro_torch.core.distances import (d1_d2_pool_distance, d1_lowrank,
                                        d1_moment, d1_pool_distance,
                                        d2_anchor_distance,
                                        log_scale, lowrank_member_sq,
                                        lowrank_pairwise_sq,
                                        pairwise_distance)
from repro_torch.core.fedelmy import (fedelmy_loss, run_fedelmy,
                                      run_fedelmy_fewshot, run_fedelmy_pfl)
from repro_torch.core.pool import (LeafDelta, LowRankDeltaPool, ModelPool,
                                   MomentPool, pool_nbytes)

__all__ = ["BASELINES", "LeafDelta", "LowRankDeltaPool", "ModelPool",
           "MomentPool", "d1_d2_pool_distance", "d1_lowrank", "d1_moment",
           "d1_pool_distance", "d2_anchor_distance", "fedelmy_loss",
           "log_scale",
           "lowrank_member_sq", "lowrank_pairwise_sq", "pairwise_distance",
           "pool_nbytes", "run_fedelmy", "run_fedelmy_fewshot",
           "run_fedelmy_pfl"]
