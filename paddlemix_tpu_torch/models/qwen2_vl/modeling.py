"""Qwen2-VL: a dynamic-resolution vision tower over packed patches, and a
Qwen2 language model (the port's Llama with q / k / v biases) under M-RoPE.
Port of paddlemix_tpu/models/qwen2_vl/modeling.py.

The processor (processors/qwen2_vl_processing.py) packs a request's images
into one patch sequence, each image its own attention segment, padded with
segment 0. The tower attends within segments (B1, non-causal, through
`scaled_dot_product_attention`), rotates q / k by each patch's (h, w)
position, merges each 2 x 2 block of patches into one feature of the
language model's width, and `splice` gives the j-th image or video
placeholder of the prompt the j-th merged feature. The language model takes
precomputed M-RoPE tables (`mrope_cos_sin` over the host's `get_rope_index`
streams) in place of its positions' rope; its cache is written at the
positions. Decode steps have equal streams, so their M-RoPE is the plain rope
at the prompt's largest position + 1 onwards (ROADMAP C.17: the JAX
`generate` starts one later).

Kernels on this path, each launched for CUDA tensors (plain versions on the
CPU): LayerNorm (B10, `ops.norms.layer_norm`) for the tower's 2 a block and
the merger's; flash attention with segment ids (B1) in the tower; RMSNorm
(B11) for the language model's norms; decode attention over the dense cache
(B7, at GQA group 7 for Qwen2-VL-7B) for every single-token step. The
prefill over the cache runs math attention, as the JAX package's
`attention_xla`.

Parameter names follow the JAX module's (visual.blocks.N.{norm1, qkv, proj,
norm2, fc1, fc2}, visual.{patch_embed, merger_ln, merger_fc1, merger_fc2})
and HF's Qwen2 under `language_model` (`core.convert.QWEN2_VL_KEY_MAP`);
`from_pretrained` also reads HF's Qwen2-VL checkpoints (`convert_hf_state_dict`,
the JAX `convert_foreign_state_dict`).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.convert import (
    QWEN2_VL_HF_RENAMES,
    QWEN2_VL_HF_SHARED,
    QWEN2_VL_KEY_MAP,
    torch_key_to_flax,
)
from ...ops.attention import SegmentIds, scaled_dot_product_attention
from ...ops.rope import apply_rope, mrope_cos_sin, rope_cos_sin_hw
from ..layers import FusedLayerNorm, device_tensor
from ..llama.modeling import KVCache, LlamaForCausalLM, RMSNorm, SamplingConfig, greedy_generate
from .configuration import Qwen2VLConfig, Qwen2VLVisionConfig


class VisionBlock(nn.Module):
    """Pre-LN block: LayerNorm (eps 1e-6), fused qkv with bias, the (h, w)
    rope on q and k, attention within segments, proj; LayerNorm, fc1, exact
    GELU (the JAX block's; the published model's is quick_gelu, ROADMAP
    C.16), fc2."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = FusedLayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = FusedLayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, cos, sin, segment_ids: SegmentIds):
        b, s, d = x.shape
        qkv = self.qkv(self.norm1(x)).view(b, s, 3 * self.num_heads, d // self.num_heads)
        q, k, v = qkv.split(self.num_heads, dim=2)
        q, k = apply_rope(q, k, cos, sin)
        attn = scaled_dot_product_attention(q, k, v, segment_ids=segment_ids)
        x = x + self.proj(attn.reshape(b, s, d))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))


class Qwen2VisionTransformer(nn.Module):
    """The packed-patch tower: patches (1, P, C * tp * ps * ps), their (h, w)
    positions (1, P, 2) and segment ids (1, P), as the processor makes them
    -> merged features (1, P / merge^2, hidden_size)."""

    def __init__(self, cfg: Qwen2VLVisionConfig):
        super().__init__()
        self.config = cfg
        self.patch_embed = nn.Linear(cfg.patch_dim, cfg.embed_dim, bias=False)
        self.blocks = nn.ModuleList(VisionBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio)
                                    for _ in range(cfg.depth))
        m = cfg.spatial_merge_size ** 2
        self.merger_ln = FusedLayerNorm(cfg.embed_dim, eps=1e-6)
        self.merger_fc1 = nn.Linear(m * cfg.embed_dim, m * cfg.embed_dim)
        self.merger_fc2 = nn.Linear(m * cfg.embed_dim, cfg.hidden_size)

    def forward(self, patches, pos_hw, segment_ids):
        cfg = self.config
        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype))
        cos, sin = rope_cos_sin_hw(pos_hw, cfg.embed_dim // cfg.num_heads)
        seg = SegmentIds(segment_ids, segment_ids)
        for block in self.blocks:
            x = block(x, cos, sin, seg)
        # the PatchMerger: each 2 x 2 block of patches is consecutive
        b, p, d = x.shape
        m = cfg.spatial_merge_size ** 2
        x = self.merger_ln(x).reshape(b, p // m, m * d)
        return self.merger_fc2(F.gelu(self.merger_fc1(x), approximate="none"))


def get_rope_index(input_ids: np.ndarray, grid_thw: Optional[np.ndarray], image_token_id: int,
                   video_token_id: int, spatial_merge_size: int = 2,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(3, B, S) int64 t / h / w position streams, on the host (the JAX
    package's port of the upstream `get_rope_index`): text advances all
    three by one; the placeholders of each image or video (grid t x h x w,
    in `grid_thw` order) take its merged grid's (t, h, w) offsets from the
    next position, after which text resumes at their largest + 1; padding
    (attention_mask 0) is 1."""
    ids = np.asarray(input_ids)
    b, s = ids.shape
    out = np.zeros((3, b, s), dtype=np.int64)
    for bi in range(b):
        row = ids[bi]
        mask = np.ones(s, bool) if attention_mask is None else attention_mask[bi].astype(bool)
        pos, img_i, j = 0, 0, 0
        t_stream, h_stream, w_stream = out[0, bi], out[1, bi], out[2, bi]
        while j < s:
            if not mask[j]:
                t_stream[j] = h_stream[j] = w_stream[j] = 1
                j += 1
                continue
            if row[j] in (image_token_id, video_token_id) and grid_thw is not None:
                t, h, w = grid_thw[img_i]
                hh, ww = h // spatial_merge_size, w // spatial_merge_size
                n = int(t * hh * ww)
                tt = np.repeat(np.arange(t), hh * ww) + pos
                hh_idx = np.tile(np.repeat(np.arange(hh), ww), t) + pos
                ww_idx = np.tile(np.arange(ww), t * hh) + pos
                t_stream[j: j + n] = tt
                h_stream[j: j + n] = hh_idx
                w_stream[j: j + n] = ww_idx
                pos = int(max(tt.max(), hh_idx.max(), ww_idx.max())) + 1
                img_i += 1
                j += n
            else:
                t_stream[j] = h_stream[j] = w_stream[j] = pos
                pos += 1
                j += 1
    return out


class Qwen2VLForConditionalGeneration(nn.Module):
    """Qwen2-VL with generation (port of the JAX Qwen2VLModule and
    Qwen2VLForConditionalGeneration). Inputs may be tensors or the
    processor's numpy arrays; they go to the model's device."""

    flax_key_map = staticmethod(QWEN2_VL_KEY_MAP)  # its names -> the JAX Qwen2VLModule's

    def __init__(self, config: Qwen2VLConfig):
        super().__init__()
        self.config = config
        self.visual = Qwen2VisionTransformer(config.vision)
        self.language_model = LlamaForCausalLM(config.text)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: torch.dtype = torch.float32):
        """The model of directory `path` (config.json and flax-keyed weights,
        or HF's Qwen2-VL weights through `convert_hf_state_dict`, sharded or
        not) on `device`, its parameters in `dtype` but the norms' (RMSNorm
        scales, LayerNorm weights and biases), which stay fp32. Each tensor
        goes to the device as stored and is laid out and cast there."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, Qwen2VLConfig, QWEN2_VL_KEY_MAP, path, device=device,
                               build=cls, param_dtype=dtype,
                               fp32_modules=(RMSNorm, FusedLayerNorm),
                               convert=convert_hf_state_dict,
                               unused=(r".*rotary_emb\.inv_freq$",))

    def save_pretrained(self, directory: str, **kwargs):
        """`core.modeling.save_pretrained`: config.json and flax-keyed
        safetensors (shards above 5 GiB), in the parameters' dtypes."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    @property
    def device(self):
        return self.language_model.device

    def encode_images(self, pixel_patches, patch_pos_hw, patch_segments):
        """The tower over the packed patches: (1, P / 4, text hidden)."""
        dev = self.device
        return self.visual(device_tensor(pixel_patches, dev),
                           device_tensor(patch_pos_hw, dev, torch.int32),
                           device_tensor(patch_segments, dev, torch.int32))

    def splice(self, input_ids, image_features):
        """Token embeddings with the j-th image or video placeholder of each
        row replaced by merged feature row j of `image_features` (1, M, D),
        pads included."""
        cfg = self.config
        token_embeds = self.language_model.embed(input_ids)
        is_img = (input_ids == cfg.image_token_id) | (input_ids == cfg.video_token_id)
        feat_idx = (is_img.long().cumsum(dim=-1) - 1).clamp(0, image_features.shape[1] - 1)
        feats = image_features.expand(input_ids.shape[0], -1, -1)
        gathered = feats.gather(1, feat_idx[:, :, None].expand(-1, -1, feats.shape[-1]))
        return torch.where(is_img[:, :, None], gathered.to(token_embeds.dtype), token_embeds)

    def mrope(self, position_ids):
        """(cos, sin) (B, S, head_dim) of the (3, B, S) M-RoPE streams."""
        text = self.config.text
        return mrope_cos_sin(device_tensor(position_ids, self.device), text.head_dim_,
                             self.config.mrope_section, self.config.rope_theta)

    def forward(self, input_ids, position_ids=None, pixel_patches=None, patch_pos_hw=None,
                patch_segments=None, *, segment_ids=None, cache: Optional[KVCache] = None,
                positions=None):
        """-> (logits (B, S, vocab), cache). With patches, the tower's merged
        features are spliced in; with position_ids (3, B, S), M-RoPE replaces
        the rope of `positions` (which still place the cache's writes)."""
        input_ids = device_tensor(input_ids, self.device, torch.long)
        inputs_embeds = None
        if pixel_patches is not None:
            inputs_embeds = self.splice(input_ids, self.encode_images(
                pixel_patches, patch_pos_hw, patch_segments))
        rope = None if position_ids is None else self.mrope(position_ids)
        return self.language_model(input_ids, positions, inputs_embeds=inputs_embeds,
                                   segment_ids=segment_ids, cache=cache, rope=rope)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The dense cache in `dtype` (the language model's by default), as
        the JAX model builds it."""
        lm = self.language_model
        return KVCache.create(lm.config, batch, max_len, dtype=dtype or lm.dtype, device=lm.device)

    @torch.inference_mode()
    def generate(self, input_ids, position_ids=None, pixel_patches=None, patch_pos_hw=None,
                 patch_segments=None, attention_mask=None, max_new_tokens: int = 32,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Optional[torch.Generator] = None,
                 eos_token_id: Optional[int] = None):
        """Greedy or sampled generation (`greedy_generate` over the language
        model and the dense cache): the prefill with the images spliced in
        under M-RoPE, written to the cache at cumsum(mask) - 1; each decode
        step at the rope position max(position_ids) + 1 + its index
        (ROADMAP C.17). Sampling draws from `generator`. -> (B,
        max_new_tokens) int32."""
        dev = self.device
        input_ids = device_tensor(input_ids, dev, torch.long)
        b, s = input_ids.shape
        mask = torch.ones((b, s), dtype=torch.int32, device=dev) if attention_mask is None \
            else device_tensor(attention_mask, dev, torch.int32)
        position_ids = torch.arange(s, device=dev).expand(3, b, s) if position_ids is None \
            else device_tensor(position_ids, dev, torch.long)
        inputs_embeds = None
        if pixel_patches is not None:
            inputs_embeds = self.splice(input_ids, self.encode_images(
                pixel_patches, patch_pos_hw, patch_segments))
        rope_delta = position_ids.amax(dim=(0, 2)) + 1 - mask.sum(dim=-1)
        return greedy_generate(self.language_model, input_ids, mask,
                               max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                               sampling=sampling, generator=generator,
                               inputs_embeds=inputs_embeds,
                               cache=self.init_cache(b, s + max_new_tokens),
                               rope=self.mrope(position_ids), rope_delta=rope_delta)


def convert_hf_state_dict(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF Qwen2-VL weights (tensors, views of the mapped files) -> the JAX
    Qwen2VLModule's flax keys and layouts: the JAX package's renames
    (`QWEN2_VL_HF_RENAMES`), the conv3d patch embedding (D, C, T, ps, ps)
    flattened to a Dense kernel (C * T * ps * ps, D), then
    `convert_torch_state_dict`'s layouts (views: nothing is copied on the
    host)."""
    from ...core.modeling import convert_torch_state_dict

    out = {torch_key_to_flax(k, QWEN2_VL_HF_RENAMES): v for k, v in flat.items()}
    w = out.get("visual.patch_embed.weight")
    if w is not None and w.ndim == 5:
        out["visual.patch_embed.weight"] = w.reshape(w.shape[0], -1)
    return convert_torch_state_dict(out, QWEN2_VL_HF_SHARED)


_TO_HF = ((r"^language_model\.", ""),
          (r"^visual\.patch_embed\.weight$", "visual.patch_embed.proj.weight"),
          (r"^(visual\.blocks\.\d+)\.(qkv|proj)\.", r"\1.attn.\2."),
          (r"^(visual\.blocks\.\d+)\.(fc1|fc2)\.", r"\1.mlp.\2."),
          (r"^visual\.merger_ln\.", "visual.merger.ln_q."),
          (r"^visual\.merger_fc1\.", "visual.merger.mlp.0."),
          (r"^visual\.merger_fc2\.", "visual.merger.mlp.2."))


def hf_state_dict(model: Qwen2VLForConditionalGeneration) -> Dict[str, torch.Tensor]:
    """`model`'s tensors under the published checkpoint's names and layouts
    (`model.*`, `lm_head.*`, `visual.*`; the patch embedding as the conv3d
    weight (D, C, T, ps, ps)): views of the model's tensors, the inverse of
    `convert_hf_state_dict`."""
    v = model.config.vision
    out = {}
    for key, t in model.state_dict().items():
        for pat, rep in _TO_HF:
            key = re.sub(pat, rep, key)
        if key == "visual.patch_embed.proj.weight":
            t = t.view(t.shape[0], v.in_channels, v.temporal_patch_size, v.patch_size,
                       v.patch_size)
        out[key] = t
    return out
