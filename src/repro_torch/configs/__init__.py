"""Architecture configs (one per assigned arch) + input shapes (counterpart
of :mod:`repro.configs`; ``input_specs`` waits for the dry-run)."""
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: F401
from repro_torch.configs.shapes import SHAPES, Shape, applicable, model_kind  # noqa: F401
