from repro_torch.data.partition import (dirichlet_partition,
                                        domain_shift_partition,
                                        feature_shift_partition,
                                        mixed_skew_partition,
                                        quantity_skew_partition,
                                        severity_ladder, shard_partition,
                                        train_val_split)
from repro_torch.data.pipeline import batch_iterator, image_batch
from repro_torch.data.plan import (DataPlan, all_want_scan,
                                   stack_plan_arrays, stack_plan_indices,
                                   wants_scan)
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        SyntheticTextDataset, apply_domain,
                                        make_domain_datasets,
                                        make_fleet_client_dataset,
                                        make_image_dataset, make_lm_dataset)

__all__ = ["DataPlan", "SyntheticImageDataset", "SyntheticTextDataset",
           "all_want_scan",
           "apply_domain", "batch_iterator", "dirichlet_partition",
           "domain_shift_partition", "feature_shift_partition",
           "image_batch", "make_domain_datasets",
           "make_fleet_client_dataset", "make_image_dataset",
           "make_lm_dataset",
           "mixed_skew_partition", "quantity_skew_partition",
           "severity_ladder", "shard_partition", "stack_plan_arrays",
           "stack_plan_indices", "train_val_split", "wants_scan"]
