"""Evaluation metrics (port of paddlemix_tpu/metrics: the CLIP zero-shot
metric so far; caption, FID / CLIP score and keypoint metrics are not
ported, ROADMAP)."""

from .clip_zero_shot import DEFAULT_TEMPLATES, build_zero_shot_classifier, zero_shot_accuracy

__all__ = ["DEFAULT_TEMPLATES", "build_zero_shot_classifier", "zero_shot_accuracy"]
