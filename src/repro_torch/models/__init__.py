"""Model zoo (counterpart of :mod:`repro.models`): the generic decoder LM
over ``"attn"`` blocks; the other block types and the enc-dec and VLM
wrappers are not ported yet."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig  # noqa: F401
from repro_torch.models.registry import ModelFns, model_fns, synthetic_batch  # noqa: F401
