"""Step functions of the port's launcher (`steps.make_step`, the dense
family's captured decode step `steps.CapturedDecode`); the training CLI is
`python -m repro_torch.launch.train`."""
from repro_torch.launch.steps import CapturedDecode, make_step, shape_supported

__all__ = ["CapturedDecode", "make_step", "shape_supported"]
