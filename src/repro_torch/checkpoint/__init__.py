"""Checkpoints in the reference's npz format (port of
``repro/checkpoint``): params, pools and fleet round files."""
from repro_torch.checkpoint.checkpoint import (fleet_round_path,
                                               latest_fleet_round, load_pool,
                                               load_pytree, save_fleet_round,
                                               save_pool, save_pytree)

__all__ = ["save_pytree", "load_pytree", "save_pool", "load_pool",
           "save_fleet_round", "latest_fleet_round", "fleet_round_path"]
