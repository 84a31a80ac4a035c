"""Step functions of the port's launcher (`steps.make_step`, the FedELMY
train step and its input specs `steps.input_specs`, the dense family's
captured decode step `steps.CapturedDecode`); the training CLI is
`python -m repro_torch.launch.train`."""
from repro_torch.launch.steps import (CapturedDecode, batch_specs_for,
                                      cache_specs_for, input_specs,
                                      make_step, param_specs_for,
                                      shape_supported)

__all__ = ["CapturedDecode", "batch_specs_for", "cache_specs_for",
           "input_specs", "make_step", "param_specs_for", "shape_supported"]
