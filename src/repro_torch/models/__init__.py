"""Model zoo (counterpart of :mod:`repro.models`): generic LM over
heterogeneous blocks + enc-dec + VLM wrappers."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig  # noqa: F401
from repro_torch.models.registry import (ModelFns, model_fns, params_from_reference,  # noqa: F401
                                         synthetic_batch)
