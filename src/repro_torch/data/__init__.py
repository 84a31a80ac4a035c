from repro_torch.data.partition import (dirichlet_partition,
                                        domain_shift_partition)
from repro_torch.data.pipeline import batch_iterator
from repro_torch.data.synthetic import (SyntheticImageDataset, apply_domain,
                                        make_domain_datasets,
                                        make_image_dataset)

__all__ = ["SyntheticImageDataset", "apply_domain", "batch_iterator",
           "dirichlet_partition", "domain_shift_partition",
           "make_domain_datasets", "make_image_dataset"]
