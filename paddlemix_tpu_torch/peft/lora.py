"""LoRA, merge-on-the-fly (port of paddlemix_tpu/peft/lora.py).

The JAX package keeps the factors in a pytree beside the frozen params and
forms W + scale * A @ B right before `apply`. The port keeps the same
arithmetic per Linear, inside the forward: each matched weight becomes a
`torch.nn.utils.parametrize` parametrization, so that reading
`module.weight` gives (W.float() + scale * (B^T A^T)).to(W.dtype), which
autograd differentiates into the factors only (`lora_loss_fn` freezes the
base, the JAX `stop_gradient`). Layouts: a torch weight is (out, in), so the
port's `lora_a` is the JAX a (in, r) transposed, (r, in), and `lora_b` the
JAX b (r, out) transposed, (out, r); `core.convert.lora_from_flax` carries
JAX factors across and `lora_to_flax` back.

Adapters are saved and read as the JAX package does: `adapter_model.safetensors`
in flax-path keys (`<kernel path>.lora_a`: a (in, r), `.lora_b`: b (r, out),
fp32), written by the port's `core.safetensors`, beside the `LoraConfig`'s
config.json, whose `target_modules` ends in JAX's kernel suffix (the port
matches weights). `merge_lora_into_model` folds W + s b a into the
base weights as JAX's `merge_params` does, and takes the parametrizations off.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..core import safetensors
from ..core.config import BaseConfig
from ..core.convert import LLAMA_KEY_MAP, KeyMap, lora_from_flax, torch_key_to_flax

# the JAX DEFAULT_TARGETS, over the port's parameter names (`.weight` for `.kernel`)
DEFAULT_TARGETS = (r".*(q_proj|k_proj|v_proj|o_proj|out_proj|gate_proj|up_proj|down_proj|"
                   r"to_q|to_k|to_v|to_out|qkv|fc1|fc2)\.weight$")


ADAPTER_NAME = "adapter_model.safetensors"
# the suffix of a target pattern: the port's (torch weights) and JAX's (flax kernels)
_PORT_SUFFIX, _JAX_SUFFIX = r"\.weight$", r"\.kernel$"


@dataclasses.dataclass
class LoraConfig(BaseConfig):
    model_type = "lora"
    r: int = 8
    lora_alpha: int = 16
    target_modules: str = DEFAULT_TARGETS
    lora_dropout: float = 0.0

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r


class LoraDelta(nn.Module):
    """The parametrization of one weight: W -> (W.float() + scale * b @ a).to(W.dtype),
    the JAX `merge_params` for one leaf. a: (r, in), b: (out, r), fp32."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scaling: float):
        super().__init__()
        self.lora_a = nn.Parameter(a)
        self.lora_b = nn.Parameter(b)
        self.scaling = scaling

    def forward(self, w):
        return (w.float() + (self.lora_b @ self.lora_a) * self.scaling).to(w.dtype)


def _targets(model: nn.Module, config: LoraConfig, key_map: Optional[KeyMap] = None):
    """The Linears LoRA adapts: `<name>.weight` matching the target pattern,
    or with `key_map` the flax path of the weight matching the pattern in
    JAX's form (ending in the kernel suffix), JAX's own test (a diffusers UNet's
    `to_out.0.weight` is JAX's `to_out.kernel`)."""
    jax_pattern = _to_jax_targets(config.target_modules)
    for name, module in model.named_modules():
        if not isinstance(module, nn.Linear):
            continue
        if key_map is None:
            hit = re.fullmatch(config.target_modules, f"{name}.weight")
        else:
            hit = re.fullmatch(jax_pattern, _flax_kernel(name, key_map))
        if hit:
            yield name, module


def lora_init(model: nn.Module, config: LoraConfig,
              generator: Optional[torch.Generator] = None,
              key_map: Optional[KeyMap] = None) -> Dict[str, torch.Tensor]:
    """Attach factors to every nn.Linear whose `<name>.weight` matches
    `config.target_modules` (with `key_map`: whose flax kernel path matches
    it, see `_targets`) (the JAX `lora_init` over 2-D kernels): a ~
    0.01 N(0, 1) drawn from `generator` (which lives on the weights' device;
    its stream is not JAX's, so the tests carry JAX's factors across), b = 0,
    both fp32 on the weight's device. Returns the factors by name
    (`<module>.lora_a`, `<module>.lora_b`), the trainable params."""
    found = list(_targets(model, config, key_map))
    if not found:
        raise ValueError(f"no params matched LoRA targets {config.target_modules!r}")
    for name, module in found:
        out_f, in_f = module.weight.shape
        dev = module.weight.device
        a = torch.randn((config.r, in_f), generator=generator, device=dev) * 0.01
        b = torch.zeros((out_f, config.r), device=dev)
        parametrize.register_parametrization(module, "weight", LoraDelta(a, b, config.scaling),
                                             unsafe=True)
    return lora_params(model)


def lora_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The LoRA factors of `model` by the name of the Linear they adapt
    (`<module>.lora_a`, `<module>.lora_b`), in module order."""
    return {f"{name.rsplit('.parametrizations.', 1)[0]}.{kind}": getattr(m, kind)
            for name, m in model.named_modules() if isinstance(m, LoraDelta)
            for kind in ("lora_a", "lora_b")}


def lora_loss_fn(base_loss_fn, model: nn.Module):
    """loss_fn(lora_params, batch, rng) with the base frozen (the JAX
    `stop_gradient`): every parameter of `model` but its LoRA factors stops
    requiring grad. The factors live in the model and `lora_params` holds
    them by reference, so the base loss reads them through the forward."""
    factors = {id(p) for p in lora_params(model).values()}
    for p in model.parameters():
        p.requires_grad_(id(p) in factors)
    return base_loss_fn


def save_lora(lora_params: Dict[str, torch.Tensor], config: LoraConfig, path: str,
              key_map: KeyMap = LLAMA_KEY_MAP) -> str:
    """Write the factors (`lora_params`, by the port's names as `lora_init`
    returns them) to `path/adapter_model.safetensors` in the JAX package's
    keys (`<flax kernel path>.lora_a` a = lora_a^T (in, r), `.lora_b` b =
    lora_b^T (r, out), through `key_map`, the Llama's by default) and the
    config, with JAX's target pattern, to `path/config.json`. Returns the
    file written."""
    os.makedirs(path, exist_ok=True)
    dataclasses.replace(config, target_modules=_to_jax_targets(config.target_modules)) \
        .save_pretrained(path)
    flat = {}
    for name, t in lora_params.items():
        owner, kind = name.rsplit(".", 1)
        if kind not in ("lora_a", "lora_b"):
            raise ValueError(f"save_lora: {name} is no LoRA factor")
        flat[f"{_flax_kernel(owner, key_map)}.{kind}"] = t.detach().T
    out = os.path.join(path, ADAPTER_NAME)
    safetensors.save_file(flat, out)
    return out


def load_lora(path: str) -> Tuple[Dict[tuple, Dict[str, torch.Tensor]], LoraConfig]:
    """(factors, config) of an adapter directory as the JAX package's
    `load_lora` returns them: {flax kernel path tuple: {"a": (in, r), "b":
    (r, out)}} (CPU tensors), the config with the port's target pattern."""
    config = LoraConfig.from_pretrained(path)
    config = dataclasses.replace(config, target_modules=_to_port_targets(config.target_modules))
    out: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for k, t in safetensors.load_file(os.path.join(path, ADAPTER_NAME)).items():
        base, kind = k.rsplit(".lora_", 1)
        out.setdefault(tuple(base.split(".")), {})["a" if kind == "a" else "b"] = t
    return out, config


def attach_lora(model: nn.Module, factors: Dict[tuple, Dict[str, torch.Tensor]],
                config: LoraConfig, key_map: Optional[KeyMap] = None) -> Dict[str, torch.Tensor]:
    """Attach factors in the JAX form (`load_lora`'s, or JAX's own) to the
    matching weights of `model` (`lora_init`, then `lora_from_flax` through
    `key_map`, the model's `flax_key_map` by default); every pair must find
    its weight. Returns the port's factors by name."""
    key_map = key_map if key_map is not None else model.flax_key_map
    lora_init(model, config, key_map=key_map)
    lora_from_flax(factors, model, key_map)
    return lora_params(model)


@torch.no_grad()
def merge_lora_into_model(model: nn.Module, lora_params=None, config: Optional[LoraConfig] = None,
                          key_map: Optional[KeyMap] = None) -> nn.Module:
    """Fold LoRA into the model for good (port of `merge_lora_into_model`,
    the reference's merge_lora_params.py): given factors in the JAX form and
    their config, attach them first (`attach_lora`); then every LoRA
    parametrization's weight becomes (W.float() + s b a).to(W.dtype), JAX's
    `merge_params`, and the parametrizations come off."""
    if lora_params is not None:
        attach_lora(model, lora_params, config, key_map)
    for module in list(model.modules()):
        if parametrize.is_parametrized(module, "weight") and any(
                isinstance(p, LoraDelta) for p in module.parametrizations.weight):
            parametrize.remove_parametrizations(module, "weight", leave_parametrized=True)
    return model


def _flax_kernel(owner: str, key_map: KeyMap) -> str:
    return torch_key_to_flax(f"{owner}.weight", key_map)


def _to_jax_targets(pattern: str) -> str:
    return pattern[:-len(_PORT_SUFFIX)] + _JAX_SUFFIX if pattern.endswith(_PORT_SUFFIX) \
        else pattern


def _to_port_targets(pattern: str) -> str:
    return pattern[:-len(_JAX_SUFFIX)] + _PORT_SUFFIX if pattern.endswith(_JAX_SUFFIX) \
        else pattern
