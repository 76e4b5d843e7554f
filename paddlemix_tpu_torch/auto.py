"""Auto classes: a directory's config.json -> the port's config and model
class (port of paddlemix_tpu/auto.py's `AutoConfig`, `AutoModel` and
`AutoProcessor`, with registries of the port's own classes).

`model_type` picks the family; a config without a known one is matched by
its `architectures`, as in JAX, or by diffusers' `_class_name` (a `unet/`
or `vae/` directory of a diffusers pipeline). A `model_type` the JAX
registry knows but the port has not ported raises with its name.
"""

from __future__ import annotations

import importlib
import json
from typing import Optional

from .core.config import resolve_file

# model_type -> (module, config class, model class)
_MODEL_REGISTRY = {
    "llama": ("paddlemix_tpu_torch.models.llama", "LlamaConfig", "LlamaForCausalLM"),
    "qwen2": ("paddlemix_tpu_torch.models.llama", "LlamaConfig", "LlamaForCausalLM"),
    "llava": ("paddlemix_tpu_torch.models.llava", "LlavaConfig",
              "LlavaForConditionalGeneration"),
    "clip": ("paddlemix_tpu_torch.models.clip", "CLIPConfig", "CLIPModel"),
    "evaclip": ("paddlemix_tpu_torch.models.clip.eva", "EVACLIPConfig", "EVACLIP"),
    "opt": ("paddlemix_tpu_torch.models.opt", "OPTConfig", "OPTForCausalLM"),
    "blip-2": ("paddlemix_tpu_torch.models.blip2", "Blip2Config",
               "Blip2ForConditionalGeneration"),
    "blip2": ("paddlemix_tpu_torch.models.blip2", "Blip2Config",
              "Blip2ForConditionalGeneration"),
    "qwen2_vl": ("paddlemix_tpu_torch.models.qwen2_vl", "Qwen2VLConfig",
                 "Qwen2VLForConditionalGeneration"),
    "internvl_chat": ("paddlemix_tpu_torch.models.internvl2", "InternVLChatConfig",
                      "InternVLChatModel"),
    "qwen_vl": ("paddlemix_tpu_torch.models.qwen_vl", "QwenVLConfig",
                "QwenVLForConditionalGeneration"),
    "unet_2d_condition": ("paddlemix_tpu_torch.diffusers.models", "UNet2DConditionConfig",
                          "UNet2DConditionModel"),
    "autoencoder_kl": ("paddlemix_tpu_torch.diffusers.models", "AutoencoderKLConfig",
                       "AutoencoderKL"),
}
# model_type -> (module, processor class): the JAX registry's entries of the
# port's processors
_PROCESSOR_REGISTRY = {
    "clip": ("paddlemix_tpu_torch.processors.clip_processing", "CLIPProcessor"),
    "qwen2_vl": ("paddlemix_tpu_torch.processors.qwen2_vl_processing", "Qwen2VLProcessor"),
    "internvl_chat": ("paddlemix_tpu_torch.processors.internvl_processing",
                      "InternVLImageProcessor"),
    "blip-2": ("paddlemix_tpu_torch.processors.blip_processing", "Blip2Processor"),
    "qwen_vl": ("paddlemix_tpu_torch.processors.qwen_vl_processing", "QwenVLProcessor"),
}
# diffusers' config.json names the model class, not a model_type
_DIFFUSERS_CLASSES = {"UNet2DConditionModel": "unet_2d_condition",
                      "AutoencoderKL": "autoencoder_kl"}


def _read_model_type(path: str, subfolder: Optional[str] = None) -> str:
    with open(resolve_file(path, "config.json", subfolder)) as f:
        data = json.load(f)
    mt = data.get("model_type", "")
    if mt in _MODEL_REGISTRY:
        return mt
    if data.get("_class_name") in _DIFFUSERS_CLASSES:
        return _DIFFUSERS_CLASSES[data["_class_name"]]
    for arch in data.get("architectures", []) or []:
        for key, (_, _, cls) in _MODEL_REGISTRY.items():
            if cls.lower().startswith(arch.lower()[:8]):
                return key
    raise NotImplementedError(f"model_type {mt!r} at {path!r} is not ported; the port knows "
                              f"{sorted(_MODEL_REGISTRY)}")


def _load(entry, idx):
    return getattr(importlib.import_module(entry[0]), entry[idx])


class AutoConfig:
    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, **kwargs):
        mt = _read_model_type(path, subfolder)
        return _load(_MODEL_REGISTRY[mt], 1).from_pretrained(path, subfolder=subfolder, **kwargs)


class AutoModel:
    @classmethod
    def from_pretrained(cls, path: str, **kwargs):
        """`from_pretrained(path, **kwargs)` of the directory's model class
        (device, dtype: see each class; the Llama, LLaVA, Qwen2-VL, InternVL2,
        Qwen-VL, UNet and VAE take `dtype` as their parameters' dtype, the
        CLIP family and BLIP-2 as the compute dtype over fp32 parameters; the
        UNet and the VAE also take `subfolder`)."""
        mt = _read_model_type(path, kwargs.get("subfolder"))
        return _load(_MODEL_REGISTRY[mt], 2).from_pretrained(path, **kwargs)


class AutoProcessor:
    @classmethod
    def from_pretrained(cls, path: str, **kwargs):
        """The processor of the directory's model_type (CLIP's where the port
        has none of its own, as in JAX)."""
        mt = _read_model_type(path)
        key = mt if mt in _PROCESSOR_REGISTRY else "clip"
        return _load(_PROCESSOR_REGISTRY[key], 1).from_pretrained(path, **kwargs)
