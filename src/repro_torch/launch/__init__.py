"""Step functions of the port's launcher (`steps.make_step`); the training
CLI is `python -m repro_torch.launch.train`."""
from repro_torch.launch.steps import make_step, shape_supported

__all__ = ["make_step", "shape_supported"]
