from repro_torch.optim.optimizers import Optimizer, adam, adamw, make_optimizer

__all__ = ["Optimizer", "adam", "adamw", "make_optimizer"]
