"""Seeded random weights, made on the target device.

Real checkpoints are not used: weights are random and made from a seed. The
JAX bench fills every weight with 0.02; here dense and conv weights are
fan-in-scaled normals (std 1/sqrt(fan_in)) so that activations keep their
scale through many blocks, norms start at weight 1 / bias 0, biases at 0,
embedding tables and embedding vectors (CLIP's class embedding, EVA's
`cls_token` and `pos_embed`, BLIP-2's `query_tokens`) at std 1, EVA's layer-scale gammas at their
config's `init_values`, PixArt's `scale_shift_table`s at std 0.02 (flax's
init), and CLIP's logit scale at its config's initial value. A module with an
`init_params_(generator)` method draws its own direct parameters by it (the
JAX inits of InternViT's layer scales, Qwen-VL's Resampler and projection);
its submodules still take the rules here. A Linear or an
Embedding that carries an `init_std` is drawn at that std instead: T5's
attention has no 1/sqrt(d) scale, so its q and its relative-position table
carry transformers' T5 init, (d_model * d_kv) ** -0.5 and d_model ** -0.5
(at the fan-in draw the logits' std is sqrt(d_kv), and a rounding flips
which key a head attends to).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `module` in place from `generator`, which
    must live on the parameters' device."""
    for m in module.modules():
        own = getattr(m, "init_params_", None)
        if own is not None:
            own(generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.normal_(0.0, getattr(m, "init_std", m.weight[0].numel() ** -0.5),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, getattr(m, "init_std", 1.0), generator=generator)
        else:  # norms: weight 1, bias 0
            for name, p in m.named_parameters(recurse=False):
                if name == "weight":
                    p.fill_(1.0)
                elif name == "bias":
                    p.zero_()
                elif name.endswith("embedding") or name in ("cls_token", "pos_embed",
                                                               "query_tokens"):
                    p.normal_(0.0, 1.0, generator=generator)
                elif name == "scale_shift_table":  # PixArt's, flax's normal(0.02)
                    p.normal_(0.0, 0.02, generator=generator)
                elif name in ("gamma_1", "gamma_2"):  # EVABlock's layer scale
                    p.fill_(m.config.init_values)
                elif name == "logit_scale":  # CLIPModel's / EVACLIP's, as its config starts it
                    p.fill_(m.config.logit_scale_init_value)
                else:
                    raise ValueError(f"no init rule for parameter {name} of {type(m).__name__}")
    return module


def build_random(factory: Callable[[], nn.Module], *, device, dtype,
                 generator: torch.Generator, fp32_modules: Tuple[type, ...] = ()) -> nn.Module:
    """Construct `factory()` without allocating (meta device), materialise it on
    `device` in `dtype` (submodules of the `fp32_modules` types in fp32), and
    fill it by `init_weights_`. Nothing of the size of the model is made on
    the host."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device).to(dtype)
    for m in module.modules():
        if isinstance(m, fp32_modules):
            m.float()
    return init_weights_(module, generator).eval()
