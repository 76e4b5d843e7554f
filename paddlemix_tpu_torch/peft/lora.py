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
JAX factors across.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

# the JAX DEFAULT_TARGETS, over the port's parameter names (`.weight` for `.kernel`)
DEFAULT_TARGETS = (r".*(q_proj|k_proj|v_proj|o_proj|out_proj|gate_proj|up_proj|down_proj|"
                   r"to_q|to_k|to_v|to_out|qkv|fc1|fc2)\.weight$")


@dataclasses.dataclass
class LoraConfig:
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


def _targets(model: nn.Module, config: LoraConfig):
    for name, module in model.named_modules():
        if isinstance(module, nn.Linear) and re.fullmatch(config.target_modules, f"{name}.weight"):
            yield name, module


def lora_init(model: nn.Module, config: LoraConfig,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Attach factors to every nn.Linear whose `<name>.weight` matches
    `config.target_modules` (the JAX `lora_init` over 2-D kernels): a ~
    0.01 N(0, 1) drawn from `generator` (which lives on the weights' device;
    its stream is not JAX's, so the tests carry JAX's factors across), b = 0,
    both fp32 on the weight's device. Returns the factors by name
    (`<module>.lora_a`, `<module>.lora_b`), the trainable params."""
    found = list(_targets(model, config))
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


def save_lora(lora_params: Dict[str, torch.Tensor], config: LoraConfig, path: str):
    """The JAX package writes safetensors, which the port's target machine
    does not have: not ported yet (ROADMAP)."""
    raise NotImplementedError("save_lora: safetensors output is not ported yet")
