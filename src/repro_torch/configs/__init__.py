"""Architecture configs (one per assigned arch) + input shapes (counterpart
of :mod:`repro.configs`)."""
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: F401
from repro_torch.configs.shapes import (SHAPES, Shape, applicable, input_specs,  # noqa: F401
                                        model_kind)
