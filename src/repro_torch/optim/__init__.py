from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          make_optimizer, momentum, sgd)
from repro_torch.optim.sam import sam_update

__all__ = ["Optimizer", "adam", "adamw", "make_optimizer", "momentum",
           "sam_update", "sgd"]
