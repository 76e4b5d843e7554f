"""SD3 MM-DiT, the dual-stream joint-attention diffusion transformer (port of
paddlemix_tpu/diffusers/models/transformer_sd3.py).

Module names are the JAX package's flax names, so the key map copied in
core/convert.py (`SD3_KEY_MAP`) only renumbers the blocks and renames
`.weight` to `.kernel`; image and context streams keep their fused q/k/v
projections (`attn_qkv`, `attn_add_qkv`).

The modulated norms run the adaLN kernels of ops/norms.py (B12
`adaptive_layer_norm`, B13 `fused_adaln_scale_residual`) on the model's own
dtype: the kernels widen to fp32 and round once, which is what the JAX model
computes by casting to fp32 around its Pallas calls. The joint attention
(context tokens first, then image tokens) is routed to flash or math by
`use_flash`; at SD3-medium's 1024 px it is flash over 4,250 tokens.

Mixed precision as flax's module `dtype=` gives it: with
`models.layers.set_compute_dtype(model, torch.bfloat16)` every Linear and
the patch conv cast their parameters (fp32 masters in training) and inputs
to bf16 at the call. With `gradient_checkpointing` each block is recomputed
in the backward (`torch.utils.checkpoint`, non-reentrant: JAX's per-block
`nn.remat`), so its kernels run twice a training step.

`from_pretrained` reads a `transformer/` directory: flax-keyed weights (the
JAX package's and the port's `save_pretrained`) or diffusers' own
(`diffusion_pytorch_model.safetensors`), whose separate `to_q/k/v` and
`add_{q,k,v}_proj` are fused as JAX's `convert_foreign_state_dict` fuses
them. Two departures from JAX's read, both needed for diffusers' file:
- `pos_embed.pos_embed`, diffusers' stored 192 x 192 sincos table, is
  dropped with a warning: the position table is computed for the grid, as in
  JAX, and so differs from diffusers' cropped one (ROADMAP C.25, kept);
- `time_text_embed.*` and `norm_out.linear.*` are renamed to the module's
  `timestep_embedder` / `text_embedder` / `norm_out_linear`. JAX's map leaves
  them as they are, so its non-strict read keeps those five Linears random
  (ROADMAP C.27); the port's strict read would refuse the file.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.config import BaseConfig
from ...core.convert import SD3_KEY_MAP, KeyMap
from ...models.layers import Linear
from ...ops.attention import scaled_dot_product_attention
from ...ops.norms import adaptive_layer_norm, fused_adaln_scale_residual
from .embeddings import PatchEmbed2D, TimestepEmbedding, Timesteps

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SD3TransformerConfig(BaseConfig):
    """Defaults are SD3-medium's published widths
    (stabilityai/stable-diffusion-3-medium-diffusers, transformer/config.json).
    `caption_projection_dim` and `pos_embed_max_size` are the JAX config's and
    are read but unused, as there: the context is projected to the hidden
    size (a checkpoint whose `context_embedder` is another width is refused by
    its shape) and the position table is computed for the grid (C.25).
    diffusers' SD3.5 options (`qk_norm`, `dual_attention_layers`) are not
    ported: a config that sets one raises, naming it."""

    model_type = "sd3_transformer"
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    out_channels: int = 16
    pos_embed_max_size: int = 192
    gradient_checkpointing: bool = False  # per-block recompute in the backward

    @classmethod
    def from_dict(cls, data, **overrides):
        data = dict(data, **overrides)
        unported = {k: data[k] for k in ("qk_norm", "dual_attention_layers") if data.get(k)}
        if unported:
            raise NotImplementedError(f"SD3TransformerConfig: options not ported: {unported}")
        return super().from_dict(data)

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# diffusers' names that JAX's map leaves unrenamed (C.27), renamed first
_DIFFUSERS_RENAMES = ((r"^time_text_embed\.", r""), (r"^norm_out\.linear\.", r"norm_out_linear."))
DIFFUSERS_SD3_KEY_MAP: KeyMap = _DIFFUSERS_RENAMES + tuple(SD3_KEY_MAP)
DIFFUSERS_POS_EMBED_KEY = "pos_embed.pos_embed"


def fuse_diffusers_qkv(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers' separate `attn.to_q/to_k/to_v` and `attn.add_{q,k,v}_proj`
    weights and biases concatenated (q, k, v along the output axis) into
    `attn_qkv` / `attn_add_qkv`, as JAX's `convert_foreign_state_dict` fuses
    them; every other key as it is."""
    fused, used = {}, set()
    for k in flat:
        for single, stem in (("to_q.", "qkv."), ("add_q_proj.", "add_qkv.")):
            if f".attn.{single}" not in k:
                continue
            for suffix in ("weight", "bias"):
                if not k.endswith(single + suffix):
                    continue
                base = k[: -len(single + suffix)]
                names = [base + single.replace("q", n, 1) + suffix for n in "qkv"]
                if all(n in flat for n in names):
                    fused[base.replace(".attn.", ".attn_") + stem + suffix] = torch.cat(
                        [torch.as_tensor(flat[n]) for n in names], dim=0)
                    used.update(names)
    out = {k: v for k, v in flat.items() if k not in used}
    out.update(fused)
    return out


def convert_diffusers_state_dict(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers' SD3 transformer keys -> flax keys: `pos_embed.pos_embed`
    dropped with a warning (C.25), q/k/v fused (`fuse_diffusers_qkv`), then
    `convert_torch_state_dict` through `DIFFUSERS_SD3_KEY_MAP` (C.27)."""
    from ...core.modeling import convert_torch_state_dict

    if DIFFUSERS_POS_EMBED_KEY in flat:
        logger.warning("SD3Transformer2DModel: dropping diffusers' %s %s: the position table is "
                       "computed for the grid, as the JAX package computes it, not cropped from "
                       "the stored one (ROADMAP C.25)", DIFFUSERS_POS_EMBED_KEY,
                       tuple(flat[DIFFUSERS_POS_EMBED_KEY].shape))
        flat = {k: v for k, v in flat.items() if k != DIFFUSERS_POS_EMBED_KEY}
    return convert_torch_state_dict(fuse_diffusers_qkv(flat), DIFFUSERS_SD3_KEY_MAP)


# the port's module names -> diffusers' (the fused q/k/v are split apart)
_TO_DIFFUSERS = ((r"^(timestep|text)_embedder\.", r"time_text_embed.\1_embedder."),
                 (r"^norm_out_linear\.", r"norm_out.linear."),
                 (r"\.norm1_linear\.", r".norm1.linear."),
                 (r"\.norm1_context_linear\.", r".norm1_context.linear."),
                 (r"\.attn_to_out\.", r".attn.to_out.0."),
                 (r"\.attn_to_add_out\.", r".attn.to_add_out."),
                 (r"\.ff_fc1\.", r".ff.net.0.proj."), (r"\.ff_fc2\.", r".ff.net.2."),
                 (r"\.ff_context_fc1\.", r".ff_context.net.0.proj."),
                 (r"\.ff_context_fc2\.", r".ff_context.net.2."))


def diffusers_state_dict(model: "SD3Transformer2DModel") -> Dict[str, torch.Tensor]:
    """`model`'s parameters under diffusers' names and layouts ((out, in)
    Linears, OIHW convs, the fused q/k/v split into `to_q/k/v` and
    `add_{q,k,v}_proj`), in their own dtypes, views where they can be: what
    `convert_diffusers_state_dict` reads back to the same tensors. diffusers'
    stored position table is not among them."""
    out = {}
    for k, v in model.state_dict().items():
        m = re.match(r"(.*)\.attn_(add_)?qkv\.(weight|bias)$", k)
        if m:
            names = [f"add_{n}_proj" for n in "qkv"] if m.group(2) else [f"to_{n}" for n in "qkv"]
            for name, part in zip(names, v.chunk(3, dim=0)):
                out[f"{m.group(1)}.attn.{name}.{m.group(3)}"] = part
            continue
        for pat, rep in _TO_DIFFUSERS:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


class JointTransformerBlock(nn.Module):
    """One MM-DiT block: separate image / context streams with adaLN-zero
    modulation (6 vectors each), joint attention over [context, image]. The
    last block is `context_pre_only`: its context stream has 2 modulation
    vectors (shift, scale), still feeds its keys and values to the joint
    attention, and returns no context."""

    def __init__(self, num_heads: int, head_dim: int, context_pre_only: bool = False):
        super().__init__()
        d = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.context_pre_only = context_pre_only
        self.norm1_linear = Linear(d, 6 * d)
        self.norm1_context_linear = Linear(d, (2 if context_pre_only else 6) * d)
        self.attn_qkv = Linear(d, 3 * d)
        self.attn_add_qkv = Linear(d, 3 * d)
        self.attn_to_out = Linear(d, d)
        self.ff_fc1 = Linear(d, 4 * d)
        self.ff_fc2 = Linear(4 * d, d)
        if not context_pre_only:
            self.attn_to_add_out = Linear(d, d)
            self.ff_context_fc1 = Linear(d, 4 * d)
            self.ff_context_fc2 = Linear(4 * d, d)

    def _qkv(self, proj, h):
        b, n, _ = h.shape
        return proj(h).view(b, n, 3 * self.num_heads, self.head_dim).split(self.num_heads, dim=2)

    def forward(self, x, context, temb):
        act = F.silu(temb)
        sx, scx, gx, sx2, scx2, gx2 = self.norm1_linear(act).chunk(6, dim=-1)
        mod_c = self.norm1_context_linear(act)
        if self.context_pre_only:
            sc, scc = mod_c.chunk(2, dim=-1)
        else:
            sc, scc, gc, sc2, scc2, gc2 = mod_c.chunk(6, dim=-1)

        hx = adaptive_layer_norm(x, scx, sx)
        hc = adaptive_layer_norm(context, scc, sc)
        qx, kx, vx = self._qkv(self.attn_qkv, hx)
        qc, kc, vc = self._qkv(self.attn_add_qkv, hc)
        nc = context.shape[1]
        attn = scaled_dot_product_attention(torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1),
                                            torch.cat([vc, vx], dim=1))
        attn = attn.flatten(2)
        attn_c, attn_x = attn[:, :nc], attn[:, nc:]

        attn_x = self.attn_to_out(attn_x)
        hx2, x = fused_adaln_scale_residual(x, attn_x, gx, scx2, sx2)
        h = F.gelu(self.ff_fc1(hx2), approximate="tanh")
        x = x + gx2[:, None, :] * self.ff_fc2(h)
        if self.context_pre_only:
            return x, None

        attn_c = self.attn_to_add_out(attn_c)
        hc2, context = fused_adaln_scale_residual(context, attn_c, gc, scc2, sc2)
        h = F.gelu(self.ff_context_fc1(hc2), approximate="tanh")
        context = context + gc2[:, None, :] * self.ff_context_fc2(h)
        return x, context


class SD3Transformer2DModel(nn.Module):
    """forward(latents (B, H, W, C) NHWC, timesteps (B,), encoder_hidden_states
    (B, L, joint_attention_dim), pooled_projections (B, pooled_projection_dim))
    -> (B, H, W, out_channels) in the model's dtype."""

    compute_dtype: Optional[torch.dtype] = None  # set_compute_dtype's; None: the parameters'
    flax_key_map = SD3_KEY_MAP  # its names -> the JAX SD3TransformerModule's

    def __init__(self, config: SD3TransformerConfig):
        super().__init__()
        self.config = cfg = config
        d = cfg.hidden_size
        self.pos_embed = PatchEmbed2D(cfg.patch_size, cfg.in_channels, d,
                                      base_size=cfg.sample_size // cfg.patch_size)
        self.time_proj = Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        self.timestep_embedder = TimestepEmbedding(256, d)
        self.text_embedder = TimestepEmbedding(cfg.pooled_projection_dim, d)
        self.context_embedder = Linear(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(cfg.num_attention_heads, cfg.attention_head_dim,
                                  context_pre_only=i == cfg.num_layers - 1)
            for i in range(cfg.num_layers)])
        self.norm_out_linear = Linear(d, 2 * d)
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the model computes in (flax's module dtype)."""
        return self.compute_dtype or self.proj_out.weight.dtype

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None, device="cuda",
                        dtype: torch.dtype = torch.float32) -> "SD3Transformer2DModel":
        """The transformer of directory `path` (or its `subfolder`, e.g.
        "transformer") on `device`, its parameters in `dtype` (the JAX
        `from_pretrained(dtype=)`: the model computes in it)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, SD3TransformerConfig, cls.flax_key_map, path, device=device,
                               build=cls, param_dtype=dtype, subfolder=subfolder,
                               convert=convert_diffusers_state_dict)

    def save_pretrained(self, directory: str, **kwargs):
        """config.json and flax-keyed safetensors (shards above 5 GiB), as the
        JAX package writes them."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    def forward(self, latents, timesteps, encoder_hidden_states, pooled_projections):
        cfg = self.config
        b, hgt, wid, _ = latents.shape
        p = cfg.patch_size
        gh, gw = hgt // p, wid // p
        dtype = self.dtype

        x = self.pos_embed(latents)
        temb = self.timestep_embedder(self.time_proj(timesteps).to(dtype))
        temb = temb + self.text_embedder(pooled_projections.to(dtype))
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        recompute = cfg.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.transformer_blocks:
            if recompute:
                x, context = checkpoint(blk, x, context, temb, use_reentrant=False)
            else:
                x, context = blk(x, context, temb)

        shift, scale = self.norm_out_linear(F.silu(temb)).chunk(2, dim=-1)
        x = self.proj_out(adaptive_layer_norm(x, scale, shift))
        x = x.view(b, gh, gw, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, cfg.out_channels)
