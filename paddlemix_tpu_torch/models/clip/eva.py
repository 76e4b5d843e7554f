"""EVA ViT and EVA-CLIP (port of paddlemix_tpu/models/clip/eva.py).

The EVA tower differs from the CLIP ViT in: separate q/k/v projections with a
BIAS-LESS k_proj; interleaved 2-D rotary embeddings on the patch tokens (the
CLS token left alone) with the pretraining grid's frequencies interpolated
(`pt_hw_seq_len`); sub-LN (`inner_attn_ln` before the attention's output
projection, `ffn_ln` inside the MLP); a SwiGLU MLP (w1, w2, w3) or an
exact-gelu fc1 / fc2 one; a post-norm block variant; layer-scale gammas;
pooling by the CLS token through `norm` or by the token mean through
`fc_norm`; a `head` projection.

Modules are named as EVA's torch checkpoints name them (blocks.N.attn.q_proj,
blocks.N.mlp.w1, patch_embed.proj, ...), so `EVA_VISION_KEY_MAP`
(core/convert.py, the JAX package's `_EVA_VISION_KEY_MAP`) carries them to
the flax names. Every LayerNorm runs on the B10 kernel (`FusedLayerNorm`);
the JAX tower uses flax nn.LayerNorm there, so that routing is the port's
own, as for the CLIP towers (models/layers.py). Attention goes through
`scaled_dot_product_attention` and its `use_flash` rule: at B/16's 197
tokens it is math. `EVACLIP(config, dtype=torch.bfloat16)` computes in bf16
over fp32 parameters, as the JAX module built with dtype=bf16 does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import EVA_CLIP_KEY_MAP
from ...ops import scaled_dot_product_attention
from ...ops.rope import apply_vision_rope, vision_rope_2d
from ..layers import FusedLayerNorm, Linear, PatchEmbed, set_compute_dtype
from .configuration import CLIPTextConfig
from .modeling import CLIPTextTransformer, clip_contrastive_loss


@dataclasses.dataclass
class EVAVisionConfig(BaseConfig):
    model_type = "evavision_transformer"
    image_size: int = 224
    patch_size: int = 14
    width: int = 768
    layers: int = 12
    head_width: int = 64
    mlp_ratio: float = 2.6667
    output_dim: int = 512
    qkv_bias: bool = True          # q and v biased; k never has a bias
    use_abs_pos_emb: bool = True
    rope: bool = True
    pt_hw_seq_len: int = 16
    intp_freq: bool = True
    naiveswiglu: bool = True
    subln: bool = True
    inner_attn_ln: bool = True
    postnorm: bool = False
    init_values: Optional[float] = None  # layer-scale gamma init
    use_mean_pooling: bool = False
    layer_norm_eps: float = 1e-6

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


class EVAAttention(nn.Module):
    def __init__(self, cfg: EVAVisionConfig):
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_width
        inner = cfg.num_heads * cfg.head_width
        self.q_proj = Linear(cfg.width, inner, bias=cfg.qkv_bias)
        self.k_proj = Linear(cfg.width, inner, bias=False)
        self.v_proj = Linear(cfg.width, inner, bias=cfg.qkv_bias)
        self.inner_attn_ln = FusedLayerNorm(inner, eps=cfg.layer_norm_eps) \
            if cfg.subln and cfg.inner_attn_ln else None
        self.proj = Linear(inner, cfg.width)

    def forward(self, x, cos=None, sin=None):
        b, n = x.shape[:2]
        q, k, v = (proj(x).view(b, n, self.num_heads, self.head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        if cos is not None:  # the patch tokens only; CLS (position 0) is not rotated
            q = torch.cat([q[:, :1], apply_vision_rope(q[:, 1:], cos, sin)], 1)
            k = torch.cat([k[:, :1], apply_vision_rope(k[:, 1:], cos, sin)], 1)
        out = scaled_dot_product_attention(q, k, v).reshape(b, n, -1)
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.proj(out)


class EVAMLP(nn.Module):
    """SwiGLU (w3(ffn_ln(silu(w1 x) * w2 x)), ffn_ln with sub-LN) or
    fc2(gelu(fc1 x)) with the exact gelu."""

    def __init__(self, cfg: EVAVisionConfig):
        super().__init__()
        hidden = cfg.mlp_hidden
        self.swiglu = cfg.naiveswiglu
        if self.swiglu:
            self.w1 = Linear(cfg.width, hidden)
            self.w2 = Linear(cfg.width, hidden)
            self.ffn_ln = FusedLayerNorm(hidden, eps=cfg.layer_norm_eps) if cfg.subln else None
            self.w3 = Linear(hidden, cfg.width)
        else:
            self.fc1 = Linear(cfg.width, hidden)
            self.fc2 = Linear(hidden, cfg.width)

    def forward(self, x):
        if not self.swiglu:
            return self.fc2(F.gelu(self.fc1(x)))
        h = F.silu(self.w1(x)) * self.w2(x)
        if self.ffn_ln is not None:
            h = self.ffn_ln(h)
        return self.w3(h)


class EVABlock(nn.Module):
    def __init__(self, cfg: EVAVisionConfig):
        super().__init__()
        self.config = cfg
        self.norm1 = FusedLayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.attn = EVAAttention(cfg)
        self.norm2 = FusedLayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.mlp = EVAMLP(cfg)
        if cfg.init_values is not None and cfg.init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((cfg.width,), float(cfg.init_values)))
            self.gamma_2 = nn.Parameter(torch.full((cfg.width,), float(cfg.init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, cos=None, sin=None):
        if self.config.postnorm:
            a = self.norm1(self.attn(x, cos, sin))
        else:
            a = self.attn(self.norm1(x), cos, sin)
        x = x + (a if self.gamma_1 is None else self.gamma_1.to(a.dtype) * a)
        m = self.norm2(self.mlp(x)) if self.config.postnorm else self.mlp(self.norm2(x))
        return x + (m if self.gamma_2 is None else self.gamma_2.to(m.dtype) * m)


class EVAPatchEmbed(nn.Module):
    """NHWC pixels -> patch tokens, through `proj` (EVA's checkpoint name)."""

    def __init__(self, patch_size: int, width: int):
        super().__init__()
        self.proj = PatchEmbed(patch_size, width)

    def forward(self, pixels):
        return self.proj(pixels)


class EVAVisionTransformer(nn.Module):
    """The EVA tower over NHWC pixels: the pooled, projected features (B,
    output_dim), or with `return_all_features` every token (B, N + 1, width)."""

    def __init__(self, config: EVAVisionConfig):
        super().__init__()
        self.config = cfg = config
        grid = cfg.image_size // cfg.patch_size
        self.patch_embed = EVAPatchEmbed(cfg.patch_size, cfg.width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.width)) \
            if cfg.use_abs_pos_emb else None
        self.blocks = nn.ModuleList([EVABlock(cfg) for _ in range(cfg.layers)])
        if cfg.use_mean_pooling:
            self.fc_norm = FusedLayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        else:
            self.norm = FusedLayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.head = Linear(cfg.width, cfg.output_dim) if cfg.output_dim > 0 else None
        self._rope: Dict[torch.device, tuple] = {}  # cos / sin tables by device

    def rope_tables(self, device):
        """(cos, sin) of the patch grid on `device`, made once a device (a
        host-to-device copy in every forward would wait for the stream), as
        normal tensors even under inference mode, so that training reuses them."""
        cfg = self.config
        if device not in self._rope:
            with torch.inference_mode(False):
                self._rope[device] = vision_rope_2d(cfg.image_size // cfg.patch_size,
                                                    cfg.head_width, cfg.pt_hw_seq_len,
                                                    cfg.intp_freq, device=device)
        return self._rope[device]

    def forward(self, pixel_values, return_all_features: bool = False):
        cfg = self.config
        x = self.patch_embed(pixel_values)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([cls, x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)
        cos, sin = self.rope_tables(x.device) if cfg.rope else (None, None)
        for block in self.blocks:
            x = block(x, cos, sin)
        if return_all_features:
            return x
        if cfg.use_mean_pooling:
            pooled = self.fc_norm(x.mean(dim=1))
        else:
            # LayerNorm is per row: normalising the CLS row alone gives the
            # JAX tower's norm(x)[:, 0]
            pooled = self.norm(x[:, 0])
        return pooled if self.head is None else self.head(pooled)


@dataclasses.dataclass
class EVACLIPConfig(BaseConfig):
    model_type = "evaclip"
    vision_cfg: Optional[Dict[str, Any]] = None
    text_cfg: Optional[Dict[str, Any]] = None
    embed_dim: int = 512
    logit_scale_init_value: float = 2.6592

    def __post_init__(self):
        self.vision_cfg = self.vision_cfg or {}
        self.text_cfg = self.text_cfg or {}

    @property
    def vision(self) -> EVAVisionConfig:
        return EVAVisionConfig.from_dict(dict(self.vision_cfg, output_dim=self.embed_dim))

    @property
    def text(self) -> CLIPTextConfig:
        return CLIPTextConfig.from_dict(dict(self.text_cfg, projection_dim=self.embed_dim))


class EVACLIP(nn.Module):
    """The EVA tower (`visual`) beside the CLIP text tower, a bias-free text
    projection and a 0-d `logit_scale`. `dtype` is the compute dtype (None:
    the parameters' dtype)."""

    flax_key_map = staticmethod(EVA_CLIP_KEY_MAP)  # its names -> the JAX EVACLIPModule's

    def __init__(self, config: EVACLIPConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        text = config.text
        self.visual = EVAVisionTransformer(config.vision)
        self.text_model = CLIPTextTransformer(text)
        self.text_projection = Linear(text.hidden_size, config.embed_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(float(config.logit_scale_init_value)))
        set_compute_dtype(self, dtype)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: Optional[torch.dtype] = None):
        """The model of directory `path` (config.json and flax- or torch-keyed
        weights, core/modeling.py) on `device`, computing in `dtype`."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, EVACLIPConfig, cls.flax_key_map, path, device=device,
                               dtype=dtype)

    def encode_image(self, pixel_values):
        """L2-normalised image features (B, embed_dim)."""
        feats = self.visual(pixel_values)
        return feats / feats.norm(dim=-1, keepdim=True)

    def encode_text(self, input_ids):
        """L2-normalised text features (B, embed_dim), pooled at the first eos."""
        feats = self.text_projection(self.text_model(input_ids)[1])
        return feats / feats.norm(dim=-1, keepdim=True)

    def forward(self, pixel_values, input_ids, axis_name: Optional[str] = None):
        """{"image_features", "text_features", "logit_scale" (exp of the
        parameter, fp32), "loss" (the contrastive loss over the batch)}."""
        img = self.encode_image(pixel_values)
        txt = self.encode_text(input_ids)
        scale = self.logit_scale.exp()
        return {"image_features": img, "text_features": txt, "logit_scale": scale,
                "loss": clip_contrastive_loss(img, txt, scale, axis_name=axis_name)}
