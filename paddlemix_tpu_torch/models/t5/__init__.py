"""T5 encoder (port of paddlemix_tpu/models/t5, encoder side)."""

from .modeling import T5Config, T5EncoderModel, T5LayerNorm, relative_position_bucket

__all__ = ["T5Config", "T5EncoderModel", "T5LayerNorm", "relative_position_bucket"]
