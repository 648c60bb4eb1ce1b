"""The paper's CNNs (``models.cnn``) and the LM model zoo: one generic
stack, six architecture families, with the reference's exports (training,
prefill and KV-cache / SSM-state decode)."""
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
from repro_torch.models.transformer import (
    DecodeState,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
    train_loss,
)

__all__ = [
    "Annotated", "LayerSpec", "ModelConfig", "ParamFactory", "pad_vocab",
    "rms_norm", "rope", "split_annotations", "swiglu",
    "DecodeState", "decode_step", "forward", "init_decode_state",
    "init_params", "prefill", "train_loss",
]
