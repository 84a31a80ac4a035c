from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import batch_iterator
from repro_torch.data.synthetic import SyntheticImageDataset, make_image_dataset

__all__ = ["SyntheticImageDataset", "batch_iterator", "dirichlet_partition",
           "make_image_dataset"]
