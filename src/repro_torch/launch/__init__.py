"""Step functions of the port's launcher (`steps.make_step`)."""
from repro_torch.launch.steps import make_step, shape_supported

__all__ = ["make_step", "shape_supported"]
