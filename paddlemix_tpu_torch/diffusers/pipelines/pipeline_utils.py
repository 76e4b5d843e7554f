"""DiffusionPipeline base: the component registry and `model_index.json` IO
(port of paddlemix_tpu/diffusers/pipelines/pipeline_utils.py).

A pipeline directory holds `model_index.json` ({"_class_name": pipeline
class, component: [library, class name], ...}, as diffusers and the JAX
package write it) and one subfolder a component. `from_pretrained` follows
the JAX rules: the pipeline class is looked up by `_class_name` in
`PIPELINE_REGISTRY` when called on `DiffusionPipeline` itself; entries the
pipeline's `__init__` does not take are skipped (with a log line for the
optional ones: safety_checker, feature_extractor, image_encoder), a null
entry is None, and every other component is read by the port's class of
that name (`_COMPONENT_CLASSES`); any other class raises, naming the
component and the class ("no implementation for component tokenizer_3
(T5TokenizerFast)", as JAX's message reads), unless the component is given
as an override. SD3's published layout needs that for `tokenizer_3`: neither
package has a T5 tokenizer (`diffusers.sd3.seeded_t5_tokenizer` stands in).
A component with no `save_pretrained` (such a callable tokenizer) is
written as JAX writes it: its entry names its type, and no subfolder.
PixArt's directory needs its tokenizer as an override too. JAX's registry
has no `PixArtTransformer2DModel`, so JAX reads the transformer of a PixArt
directory only when it is given as an override (ROADMAP C.40); the port
registers it.
"""

from __future__ import annotations

import importlib
import inspect
import json
import logging
import os
from typing import Any, Dict, Type

import torch

from ...core.config import resolve_file
from ...utils.registry import Registry

PIPELINE_REGISTRY = Registry("pipelines")

MODEL_INDEX_NAME = "model_index.json"
LIBRARY_NAME = "paddlemix_tpu_torch"

logger = logging.getLogger(__name__)

# the class names of model_index.json the port reads -> its implementations
_COMPONENT_CLASSES: Dict[str, str] = {
    "CLIPTextModel": "paddlemix_tpu_torch.models.clip:CLIPTextModel",
    "CLIPTextModelWithProjection": "paddlemix_tpu_torch.models.clip:CLIPTextModelWithProjection",
    "CLIPTokenizer": "paddlemix_tpu_torch.models.clip:CLIPTokenizer",
    "AutoencoderKL": "paddlemix_tpu_torch.diffusers.models:AutoencoderKL",
    "UNet2DConditionModel": "paddlemix_tpu_torch.diffusers.models:UNet2DConditionModel",
    "DDIMScheduler": "paddlemix_tpu_torch.diffusers.schedulers:DDIMScheduler",
    "DDPMScheduler": "paddlemix_tpu_torch.diffusers.schedulers:DDPMScheduler",
    "PNDMScheduler": "paddlemix_tpu_torch.diffusers.schedulers:PNDMScheduler",
    "DPMSolverMultistepScheduler":
        "paddlemix_tpu_torch.diffusers.schedulers:DPMSolverMultistepScheduler",
    "EulerDiscreteScheduler": "paddlemix_tpu_torch.diffusers.schedulers:EulerDiscreteScheduler",
    "FlowMatchEulerDiscreteScheduler":
        "paddlemix_tpu_torch.diffusers.schedulers:FlowMatchEulerDiscreteScheduler",
    "UniPCMultistepScheduler": "paddlemix_tpu_torch.diffusers.schedulers:UniPCMultistepScheduler",
    "ControlNetModel": "paddlemix_tpu_torch.diffusers.models:ControlNetModel",
    "SD3Transformer2DModel": "paddlemix_tpu_torch.diffusers.models:SD3Transformer2DModel",
    "DiTModel": "paddlemix_tpu_torch.diffusers.models:DiTModel",
    "PixArtTransformer2DModel": "paddlemix_tpu_torch.diffusers.models:PixArtTransformer2DModel",
    "T5EncoderModel": "paddlemix_tpu_torch.models.t5:T5EncoderModel",
    "T2IAdapter": "paddlemix_tpu_torch.diffusers.models:T2IAdapter",
}


def resolve_component_class(class_name: str) -> type:
    """The port's class for a model_index.json class name; one the port has
    not ported raises NotImplementedError, naming it."""
    spec = _COMPONENT_CLASSES.get(class_name)
    if spec is None:
        raise NotImplementedError(f"component class {class_name!r} is not ported (the port "
                                  f"reads {sorted(_COMPONENT_CLASSES)})")
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr)


def make_scheduler_state(scheduler, num_inference_steps, sample_shape=None, **kwargs):
    """set_timesteps that forwards sample_shape only to schedulers that take it."""
    sig = inspect.signature(scheduler.set_timesteps)
    if sample_shape is not None and "sample_shape" in sig.parameters:
        return scheduler.set_timesteps(num_inference_steps, sample_shape=sample_shape, **kwargs)
    return scheduler.set_timesteps(num_inference_steps, **kwargs)


class DiffusionPipeline:
    """Component container. Subclasses declare components via __init__ args."""

    _optional_components = ("safety_checker", "feature_extractor", "image_encoder")

    def register_modules(self, **components):
        for name, module in components.items():
            setattr(self, name, module)
        self._components = dict(components)

    def save_pretrained(self, save_directory: str):
        """model_index.json and each component's `save_pretrained` into its
        subfolder (models: config.json and flax-keyed model.safetensors, as
        the JAX package writes them; the tokenizer's vocab.json and
        merges.txt; the scheduler's scheduler_config.json). A component
        without `save_pretrained` gets its type's name in model_index.json
        and no subfolder, as in JAX."""
        os.makedirs(save_directory, exist_ok=True)
        index: Dict[str, Any] = {"_class_name": type(self).__name__}
        for name, comp in self._components.items():
            if comp is None:
                index[name] = [None, None]
                continue
            index[name] = [LIBRARY_NAME, type(comp).__name__]
            if hasattr(comp, "save_pretrained"):
                comp.save_pretrained(os.path.join(save_directory, name))
        with open(os.path.join(save_directory, MODEL_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.float32, device="cuda",
                        **overrides):
        """The pipeline of directory `path`: each model component on `device`
        with its parameters in `dtype` (the JAX `from_pretrained(dtype=)`:
        the models compute in it). `overrides` replace components by name."""
        index_path = resolve_file(path, MODEL_INDEX_NAME)
        with open(index_path) as f:
            index = json.load(f)
        root = os.path.dirname(index_path)
        pipe_cls = cls
        if cls is DiffusionPipeline:
            name = index.get("_class_name", "")
            if name not in PIPELINE_REGISTRY:
                raise ValueError(f"unknown pipeline class {name!r} (the port registers "
                                 f"{sorted(PIPELINE_REGISTRY.keys())})")
            pipe_cls = PIPELINE_REGISTRY.get(name)

        wanted = [p for p in inspect.signature(pipe_cls.__init__).parameters if p != "self"]
        components: Dict[str, Any] = {}
        for name, entry in index.items():
            if name.startswith("_"):
                continue
            if name not in wanted:
                if name in cls._optional_components:
                    logger.warning("skipping optional component %s (%s)", name, entry)
                continue
            if name in overrides:
                components[name] = overrides.pop(name)
                continue
            if not isinstance(entry, (list, tuple)) or entry[1] is None:
                components[name] = None
                continue
            try:
                comp_cls = resolve_component_class(entry[1])
            except NotImplementedError as e:
                raise NotImplementedError(f"no implementation for component {name} "
                                          f"({entry[1]}): {e}; pass it as an override") from None
            kwargs = {k: v for k, v in (("device", device), ("dtype", dtype)) if k in
                      inspect.signature(comp_cls.from_pretrained).parameters}
            components[name] = comp_cls.from_pretrained(root, subfolder=name, **kwargs)
        for name in wanted:
            components.setdefault(name, overrides.pop(name, None))
        return pipe_cls(**components)


def register_pipeline(cls: Type) -> Type:
    PIPELINE_REGISTRY.add(cls.__name__, cls)
    return cls
