"""OPT decoder (port of paddlemix_tpu/models/opt), BLIP-2's language model."""

from .configuration import OPT_LAYER_NORM_EPS, OPTConfig
from .modeling import OPTDecoder, OPTForCausalLM

__all__ = ["OPT_LAYER_NORM_EPS", "OPTConfig", "OPTDecoder", "OPTForCausalLM"]
