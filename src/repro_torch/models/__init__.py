"""The paper's CNNs (``models.cnn``) and the LM model zoo: one generic
stack, six architecture families (the reference's exports that the port
has; the decode path waits for serving, ROADMAP.md item 8)."""
from repro_torch.models.common import (
    Annotated,
    LayerSpec,
    ModelConfig,
    ParamFactory,
    pad_vocab,
    rms_norm,
    rope,
    split_annotations,
    swiglu,
)
from repro_torch.models.transformer import forward, init_params, train_loss

__all__ = [
    "Annotated", "LayerSpec", "ModelConfig", "ParamFactory", "pad_vocab",
    "rms_norm", "rope", "split_annotations", "swiglu",
    "forward", "init_params", "train_loss",
]
