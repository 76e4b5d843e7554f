"""BLIP-2 captioning: the ViT tower, 32 learned queries through the
Q-Former, a projection and the frozen OPT (port of
paddlemix_tpu/models/blip2/modeling.py: _QAttention, QFormerLayer, QFormer,
Blip2Module / Blip2ForConditionalGeneration, its OPT branch with the
HF-format CLIP tower).

The vision tower is the port's `CLIPVisionTransformer` in BLIP-2's form (no
pre-LN, the post-LN over every token; `Blip2Config.vision`). The Q-Former is
post-LN, BERT's convention: self-attention over the queries, cross-attention
to the image tokens every `cross_attention_frequency` layers, an exact-gelu
FFN. `generate` splices the projected queries before the prompt's embeddings
and decodes greedily through the Llama's `greedy_generate` over the dense
cache (`OPTForCausalLM` has the call surface that the JAX package's
`_OPTView` gives the JAX one). Kernels on this path, each launched for CUDA
tensors (plain versions on the CPU): every LayerNorm of the tower, the
Q-Former and OPT on B10 (`ops.norms.layer_norm`), and OPT's decode steps on
B7 (`ops.decode_attention.decode_attention`). The attention of the tower
(257 tokens), the Q-Former (32 queries) and OPT's prefill goes to math by
the JAX package's shape rule (`use_flash`).

Module names: the tower's are the port's CLIP tower's (HF CLIP names), the
Q-Former's the JAX module's (layers a ModuleList), the language model's HF
OPT's; `core.convert.blip2_key_to_flax` maps them to the JAX names.
`from_pretrained` also reads HF's Blip2 checkpoints through a copy of the
JAX package's `convert_foreign_state_dict` (`convert_hf_state_dict`).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.convert import BLIP2_KEY_MAP
from ...ops.attention import scaled_dot_product_attention
from ..clip.modeling import CLIPVisionTransformer
from ..layers import FusedLayerNorm, Linear, set_compute_dtype
from ..llama.modeling import KVCache, greedy_generate
from ..opt.modeling import OPTForCausalLM
from .configuration import Blip2Config, QFormerConfig


class QAttention(nn.Module):
    """Multi-head attention of the Q-Former (port of `_QAttention`): queries
    from `hidden`, keys and values from `context` (`hidden` itself when None,
    of width `context_dim`)."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        context_dim = context_dim or dim
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(context_dim, dim)
        self.v_proj = Linear(context_dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, hidden, context=None):
        context = hidden if context is None else context
        b, sq, d = hidden.shape
        hd, sk = d // self.num_heads, context.shape[1]
        q = self.q_proj(hidden).view(b, sq, self.num_heads, hd)
        k = self.k_proj(context).view(b, sk, self.num_heads, hd)
        v = self.v_proj(context).view(b, sk, self.num_heads, hd)
        return self.out_proj(scaled_dot_product_attention(q, k, v).reshape(b, sq, d))


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = QAttention(d, cfg.num_attention_heads)
        self.self_attn_norm = FusedLayerNorm(d, eps=eps)
        if has_cross:
            self.cross_attn = QAttention(d, cfg.num_attention_heads, cfg.encoder_hidden_size)
            self.cross_attn_norm = FusedLayerNorm(d, eps=eps)
        self.has_cross = has_cross
        self.fc1 = Linear(d, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, d)
        self.mlp_norm = FusedLayerNorm(d, eps=eps)

    def forward(self, x, image_embeds):
        x = self.self_attn_norm(x + self.self_attn(x))
        if self.has_cross:
            x = self.cross_attn_norm(x + self.cross_attn(x, image_embeds))
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))  # exact at every dtype, as JAX's
        return self.mlp_norm(x + h)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.layernorm = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, has_cross=i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.num_hidden_layers))

    def forward(self, query_embeds, image_embeds):
        x = self.layernorm(query_embeds)
        for layer in self.layers:
            x = layer(x, image_embeds)
        return x


class Blip2ForConditionalGeneration(nn.Module):
    """BLIP-2 with OPT (port of `Blip2ForConditionalGeneration`). `dtype` is
    the compute dtype (flax's module `dtype`): None computes in the
    parameters' dtype."""

    flax_key_map = BLIP2_KEY_MAP  # its names -> the JAX Blip2Module's

    def __init__(self, config: Blip2Config, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        qcfg, text = config.qformer, config.text
        self.vision_model = CLIPVisionTransformer(config.vision)
        self.query_tokens = nn.Parameter(torch.empty(1, config.num_query_tokens,
                                                     qcfg.hidden_size))
        self.qformer = QFormer(qcfg)
        self.language_projection = Linear(qcfg.hidden_size, text.hidden_size)
        self.language_model = OPTForCausalLM(text)
        set_compute_dtype(self, dtype)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: Optional[torch.dtype] = None):
        """The model of directory `path` (config.json and flax-keyed weights,
        or HF's Blip2 torch weights through `convert_hf_state_dict`) on
        `device`, computing in `dtype`."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, Blip2Config, cls.flax_key_map, path, device=device,
                               dtype=dtype, convert=convert_hf_state_dict, unused=_HF_UNUSED)

    @property
    def device(self):
        return self.query_tokens.device

    def encode_image(self, pixel_values):
        """(B, H, W, 3) NHWC pixels -> (B, num_query_tokens, text hidden): the
        queries through the Q-Former over the tower's normalised tokens,
        projected."""
        image_embeds, _ = self.vision_model(pixel_values)
        queries = self.query_tokens.to(image_embeds.dtype).expand(pixel_values.shape[0], -1, -1)
        return self.language_projection(self.qformer(queries, image_embeds))

    def _splice(self, pixel_values, input_ids):
        """[projected queries; the prompt's token embeddings] (B, Q + S, D)."""
        text_embeds = self.language_model.embed(input_ids)
        feats = self.encode_image(pixel_values)
        return torch.cat([feats.to(text_embeds.dtype), text_embeds], dim=1)

    def forward(self, pixel_values, input_ids, positions=None, *, segment_ids=None,
                cache: Optional[KVCache] = None):
        """Stage-2 captioning: [query features; text] through the language
        model. -> (logits (B, Q + S, vocab), cache)."""
        inputs_embeds = self._splice(pixel_values, input_ids)
        b, s = inputs_embeds.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=inputs_embeds.device).expand(b, s)
        return self.language_model(None, positions, inputs_embeds=inputs_embeds,
                                   segment_ids=segment_ids, cache=cache)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The language model's dense cache, in `dtype` (its compute dtype by
        default)."""
        return self.language_model.init_cache(batch, max_len, dtype)

    @torch.inference_mode()
    def generate(self, pixel_values, input_ids, attention_mask=None, max_new_tokens: int = 32,
                 **kwargs):
        """Greedy or sampled captions (kwargs as `greedy_generate`:
        eos_token_id, sampling, generator): the queries' features take
        positions 0 .. Q - 1, always attended, then the prompt (right-padded,
        `attention_mask` 0 on padding). -> (B, max_new_tokens) int32."""
        dev = self.device
        input_ids = input_ids.to(dev)
        inputs_embeds = self._splice(pixel_values.to(dev), input_ids)
        b, nq = input_ids.shape[0], self.config.num_query_tokens
        mask = (torch.ones(input_ids.shape, dtype=torch.int32, device=dev)
                if attention_mask is None else attention_mask.to(dev).int())
        full_mask = torch.cat([torch.ones((b, nq), dtype=torch.int32, device=dev), mask], dim=1)
        full_ids = torch.cat([torch.zeros((b, nq), dtype=input_ids.dtype, device=dev),
                              input_ids], dim=1)
        return greedy_generate(self.language_model, full_ids, full_mask,
                               max_new_tokens=max_new_tokens, inputs_embeds=inputs_embeds,
                               cache=self.init_cache(b, full_ids.shape[1] + max_new_tokens),
                               **kwargs)


# HF's Blip2 names -> the JAX Blip2Module's, in order (a copy of the renames of
# the JAX package's `convert_foreign_state_dict`)
_HF_RENAMES = (
    (r"vision_model\.embeddings\.patch_embedding\.", "vision_model.patch_embed.proj."),
    (r"vision_model\.embeddings\.class_embedding$", "vision_model.class_embedding"),
    (r"vision_model\.embeddings\.position_embedding$", "vision_model.position_embedding"),
    (r"vision_model\.encoder\.layers\.(\d+)\.", r"vision_model.layers_\1."),
    (r"\.layer_norm1\.", ".norm1."),
    (r"\.layer_norm2\.", ".norm2."),
    (r"^qformer\.encoder\.layer\.(\d+)\.", r"qformer.layers_\1."),
    (r"\.attention\.attention\.query\.", ".self_attn.q_proj."),
    (r"\.attention\.attention\.key\.", ".self_attn.k_proj."),
    (r"\.attention\.attention\.value\.", ".self_attn.v_proj."),
    (r"\.attention\.output\.dense\.", ".self_attn.out_proj."),
    (r"\.attention\.output\.LayerNorm\.", ".self_attn_norm."),
    (r"\.crossattention\.attention\.query\.", ".cross_attn.q_proj."),
    (r"\.crossattention\.attention\.key\.", ".cross_attn.k_proj."),
    (r"\.crossattention\.attention\.value\.", ".cross_attn.v_proj."),
    (r"\.crossattention\.output\.dense\.", ".cross_attn.out_proj."),
    (r"\.crossattention\.output\.LayerNorm\.", ".cross_attn_norm."),
    (r"\.intermediate_query\.dense\.", ".fc1."),
    (r"\.output_query\.dense\.", ".fc2."),
    (r"\.output_query\.LayerNorm\.", ".mlp_norm."),
    (r"^language_model\.model\.decoder\.", "language_model."),
    (r"language_model\.embed_tokens\.weight$", "language_model.embed_tokens.embedding"),
    (r"language_model\.embed_positions\.weight$", "language_model.embed_positions.embedding"),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
)
# then, as the JAX package hands them to `convert_torch_state_dict`
_HF_SHARED = ((r"(LayerNorm|layer_norm|layernorm|_norm|norm\d?)\.weight$", r"\1.scale"),
              (r"\.weight$", r".kernel"))
# HF keys the JAX model has no parameter for, which its loader drops with a
# warning (and `from_pretrained` drops before `convert_hf_state_dict`): the
# tied lm_head, and the Q-Former's text branch and embeddings (BLIP-2
# captioning feeds it no text)
_HF_UNUSED = (r"^language_model\.lm_head\.", r"^qformer\.embeddings\.",
               r"^qformer\.encoder\.layer\.\d+\.(intermediate|output)\.")


def convert_hf_state_dict(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF Blip2 (OPT) torch weights -> the JAX Blip2Module's flax keys and
    layouts: the tower's fused `qkv` weight and bias split into q / k / v,
    its `projection` renamed `out_proj`, the renames of the JAX package's
    `convert_foreign_state_dict`, then `convert_torch_state_dict`'s layouts.
    Keys `_HF_UNUSED` names must be gone already. The tower's class and
    position embeddings, (1, 1, D) and (1, S, D) in HF's, take the JAX shapes
    (D,) and (S, D)."""
    from ...core.modeling import convert_torch_state_dict

    for k in list(flat):
        m = re.match(r"^(vision_model\.encoder\.layers\.\d+\.self_attn\.)qkv\.(weight|bias)$", k)
        if m:
            for name, part in zip(("q_proj", "k_proj", "v_proj"), flat.pop(k).chunk(3, dim=0)):
                flat[f"{m.group(1)}{name}.{m.group(2)}"] = part
        elif k.startswith("vision_model") and ".self_attn.projection." in k:
            flat[k.replace(".projection.", ".out_proj.")] = flat.pop(k)
    out = {}
    for k, v in flat.items():
        for pat, rep in _HF_RENAMES:
            k = re.sub(pat, rep, k)
        if k.startswith("vision_model"):
            k = re.sub(r"\.self_attn\.", ".attn.", k)
        out[k] = v
    out = convert_torch_state_dict(out, _HF_SHARED)
    if "vision_model.class_embedding" in out:
        out["vision_model.class_embedding"] = out["vision_model.class_embedding"].reshape(-1)
    pos = out.get("vision_model.position_embedding")
    if pos is not None:
        out["vision_model.position_embedding"] = pos.reshape(pos.shape[-2:])
    return out
