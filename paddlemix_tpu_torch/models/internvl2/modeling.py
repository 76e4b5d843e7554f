"""InternVL2 chat: InternViT, the pixel-unshuffle MLP projector, and the
language model as the port's Llama (InternLM2's grouped wqkv split into q /
k / v). Port of paddlemix_tpu/models/internvl2/modeling.py.

The processor (processors/internvl_processing.py) tiles an image into up to
12 tiles of 448 px and a thumbnail. Each tile's tower output drops its class
token, is pixel-unshuffled 2 x 2 (1,024 x 4 = 4,096 wide, 256 rows a tile)
and projected by `mlp1` (LayerNorm, Linear, exact GELU, Linear) to the
language model's width; `splice` gives the j-th image-context placeholder
of a row the j-th feature row of all tiles (JAX's cumsum scatter: every row
of a batch reads the one feature set).

The JAX processor pads every image's stack to 13 tiles, so that one compiled
program serves every image (a TPU static-shape workaround). The port runs
the tower on the real tiles alone: given the processor's `tile_mask`,
`extract_feature` takes the tiles it marks. The padded tiles' features come
after every real one and no placeholder reads them, so the spliced
embeddings are JAX's.

Kernels on this path, each launched for CUDA tensors (plain versions on the
CPU): the tower's (intern_vit.py: B10 at 1,024, B1 at 1,025 tokens, 16 heads
of 64), B10 at 4,096 for the projector's LayerNorm, RMSNorm (B11) for the
language model's norms and decode attention over the dense cache (B7, G 4
for InternLM2.5-7B's 32 heads on 8) for every single-token step. The
prefill over the cache runs math attention, as the JAX package's
`attention_xla`.

Parameter names follow the JAX module's under `vision_model`, `mlp1_*` and
HF's Llama under `language_model` (`core.convert.INTERNVL_KEY_MAP`);
`from_pretrained` also reads the published checkpoints' keys
(`convert_hf_state_dict`, the JAX `convert_foreign_state_dict`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import INTERNVL_HF_KEY_MAP, INTERNVL_KEY_MAP
from ..layers import FusedLayerNorm, device_tensor
from ..llama.configuration import LlamaConfig
from ..llama.modeling import KVCache, LlamaForCausalLM, RMSNorm, greedy_generate
from .intern_vit import InternVisionConfig, InternVisionModel


@dataclasses.dataclass
class InternVLChatConfig(BaseConfig):
    model_type = "internvl_chat"
    vision_config: Optional[Dict[str, Any]] = None
    llm_config: Optional[Dict[str, Any]] = None
    downsample_ratio: float = 0.5
    select_layer: int = -1
    # JAX's default lies past InternVL2-8B's vocab of 92,553 (ROADMAP C.42):
    # the published chat code sets it from the tokenizer's <IMG_CONTEXT>
    img_context_token_id: int = 151667
    ps_version: str = "v2"

    def __post_init__(self):
        self.vision_config = self.vision_config or {}
        self.llm_config = self.llm_config or {}
        if self.ps_version not in ("v1", "v2"):
            raise ValueError(f"InternVLChatConfig: ps_version {self.ps_version!r}")

    @property
    def vision(self) -> InternVisionConfig:
        return InternVisionConfig.from_dict(self.vision_config)

    @property
    def text(self) -> LlamaConfig:
        return LlamaConfig.from_dict(self.llm_config)

    @property
    def tokens_per_tile(self) -> int:
        v = self.vision
        grid = v.image_size // v.patch_size
        r = int(1 / self.downsample_ratio)
        return (grid // r) ** 2


def pixel_shuffle(x, scale_factor: float = 0.5, ps_version: str = "v2"):
    """(B, H, W, C) -> (B, H*s, W*s, C/s^2), s < 1 unshuffling (copy of the
    JAX function; v1 leaves the reference's transposes out)."""
    b, h, w, c = x.shape
    r = int(1 / scale_factor)
    x = x.reshape(b, h, w // r, c * r)
    if ps_version == "v2":
        x = x.permute(0, 2, 1, 3).reshape(b, w // r, h // r, c * r * r).permute(0, 2, 1, 3)
    else:
        x = x.reshape(b, h // r, w // r, c * r * r)
    return x


class InternVLChatModel(nn.Module):
    """InternVL2 with generation (port of the JAX InternVLChatModule and
    InternVLChatModel). Inputs may be tensors or numpy arrays; they go to the
    model's device."""

    flax_key_map = staticmethod(INTERNVL_KEY_MAP)  # its names -> the JAX module's

    def __init__(self, config: InternVLChatConfig):
        super().__init__()
        self.config = config
        v, t = config.vision, config.text
        self.vision_model = InternVisionModel(v)
        r = int(1 / config.downsample_ratio)
        in_dim = v.hidden_size * r * r
        self.mlp1_ln = FusedLayerNorm(in_dim, eps=1e-6)
        self.mlp1_fc1 = nn.Linear(in_dim, t.hidden_size)
        self.mlp1_fc2 = nn.Linear(t.hidden_size, t.hidden_size)
        self.language_model = LlamaForCausalLM(t)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: torch.dtype = torch.float32):
        """The model of directory `path` (config.json and flax-keyed weights,
        or the published checkpoint's through `convert_hf_state_dict`) on
        `device`, its parameters in `dtype` but the norms' (fp32)."""
        from ...core.modeling import from_pretrained

        config = InternVLChatConfig.from_pretrained(path)
        return from_pretrained(cls, InternVLChatConfig, INTERNVL_KEY_MAP, path, device=device,
                               build=cls, param_dtype=dtype,
                               fp32_modules=(RMSNorm, FusedLayerNorm),
                               convert=lambda flat: convert_hf_state_dict(flat, config),
                               unused=(r".*rotary_emb\.inv_freq$",))

    def save_pretrained(self, directory: str, **kwargs):
        """`core.modeling.save_pretrained`: config.json and flax-keyed
        safetensors (shards above 5 GiB), in the parameters' dtypes."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    @property
    def device(self):
        return self.language_model.device

    @staticmethod
    def real_tiles(pixel_values, tile_mask=None):
        """The tiles the tower runs: pixel_values (T, H, W, 3), or the
        processor's padded stack (B, T, H, W, 3) with its tile_mask (B, T),
        of which the marked tiles, in order."""
        if tile_mask is None:
            return pixel_values
        keep = device_tensor(tile_mask, pixel_values.device).bool()
        return pixel_values[keep] if pixel_values.ndim == 5 else pixel_values[keep.reshape(-1)]

    def extract_feature(self, pixel_values, tile_mask=None):
        """Tiles (T, H, W, 3) (or the padded stack and its mask) -> (T_real,
        tokens_per_tile, text hidden): the hidden state `select_layer` (only
        the layers it needs run), the class token dropped, unshuffled,
        `mlp1`."""
        cfg = self.config
        x = self.real_tiles(device_tensor(pixel_values, self.device), tile_mask)
        x = x.to(self.mlp1_fc1.weight.dtype)
        layers = cfg.select_layer % (cfg.vision.num_hidden_layers + 1)
        feats, _, _ = self.vision_model(x, layers=layers)
        feats = feats[:, 1:]
        t, n = feats.shape[:2]
        g = int(n ** 0.5)
        feats = pixel_shuffle(feats.reshape(t, g, g, -1), cfg.downsample_ratio, cfg.ps_version)
        feats = feats.reshape(t, -1, feats.shape[-1])
        h = self.mlp1_fc1(self.mlp1_ln(feats))
        return self.mlp1_fc2(F.gelu(h, approximate="none"))

    def splice(self, input_ids, tile_features):
        """Token embeddings with the j-th image-context placeholder of each row
        replaced by feature row j of `tile_features` (T, N, D) flattened."""
        is_img = input_ids == self.config.img_context_token_id
        token_embeds = self.language_model.embed(input_ids.masked_fill(is_img, 0))
        flat = tile_features.reshape(1, -1, tile_features.shape[-1])
        idx = (is_img.long().cumsum(dim=-1) - 1).clamp(0, flat.shape[1] - 1)
        gathered = flat.expand(input_ids.shape[0], -1, -1).gather(
            1, idx[:, :, None].expand(-1, -1, flat.shape[-1]))
        return torch.where(is_img[:, :, None], gathered.to(token_embeds.dtype), token_embeds)

    def _embeds(self, input_ids, pixel_values, tile_mask):
        if pixel_values is None:
            return None
        return self.splice(input_ids, self.extract_feature(pixel_values, tile_mask))

    def forward(self, input_ids, pixel_values=None, positions=None, *, segment_ids=None,
                cache: Optional[KVCache] = None, tile_mask=None):
        """-> (logits (B, S, vocab), cache). With tiles, their features are
        spliced in (the real ones alone, where `tile_mask` is given)."""
        input_ids = device_tensor(input_ids, self.device, torch.long)
        return self.language_model(input_ids, positions,
                                   inputs_embeds=self._embeds(input_ids, pixel_values, tile_mask),
                                   segment_ids=segment_ids, cache=cache)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The dense cache in `dtype` (the language model's by default), as
        the JAX model builds it."""
        lm = self.language_model
        return KVCache.create(lm.config, batch, max_len, dtype=dtype or lm.dtype, device=lm.device)

    @torch.inference_mode()
    def generate(self, input_ids, pixel_values=None, attention_mask=None, tile_mask=None,
                 max_new_tokens: int = 32, **kwargs):
        """Greedy or sampled generation with the tiles' features spliced into
        the prefill (kwargs as `greedy_generate`: eos_token_id, sampling,
        generator). -> (B, max_new_tokens) int32."""
        input_ids = device_tensor(input_ids, self.device, torch.long)
        b, s = input_ids.shape
        return greedy_generate(self.language_model, input_ids, attention_mask,
                               max_new_tokens=max_new_tokens,
                               inputs_embeds=self._embeds(input_ids, pixel_values, tile_mask),
                               cache=self.init_cache(b, s + max_new_tokens), **kwargs)


def convert_hf_state_dict(flat: Dict[str, torch.Tensor], config: InternVLChatConfig):
    """The published InternVL2 checkpoints' tensors (views of the mapped
    files) -> the JAX module's flax keys and layouts (the JAX
    `convert_foreign_state_dict`): InternLM2's fused `attention.wqkv` split
    into q / k / v (its rows grouped by KV head: the group's q heads, then k,
    then v), then `INTERNVL_HF_KEY_MAP`'s renames and the 2-D weights'
    transposes."""
    from ...core.modeling import convert_torch_state_dict

    t = config.text
    g, hd = t.num_attention_heads // t.kv_heads, t.head_dim_
    out = {}
    for k, v in flat.items():
        m = re.match(r"(.*)\.attention\.wqkv\.weight$", k)
        if m:
            w = v.reshape(t.kv_heads, g + 2, hd, v.shape[-1])
            out[m.group(1) + ".self_attn.q_proj.weight"] = w[:, :g].reshape(-1, v.shape[-1])
            out[m.group(1) + ".self_attn.k_proj.weight"] = w[:, g].reshape(-1, v.shape[-1])
            out[m.group(1) + ".self_attn.v_proj.weight"] = w[:, g + 1].reshape(-1, v.shape[-1])
        else:
            out[k.replace(".attention.q_proj", ".self_attn.q_proj")
                 .replace(".attention.k_proj", ".self_attn.k_proj")
                 .replace(".attention.v_proj", ".self_attn.v_proj")] = v
    return convert_torch_state_dict(out, INTERNVL_HF_KEY_MAP)
