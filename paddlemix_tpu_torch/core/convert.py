"""Carry the JAX package's parameters over to the port's modules.

`flax_to_torch_state_dict` works forward: for each key of the torch module's
state_dict it applies the JAX package's torch->flax key map (the same regex
renames `core/modeling.py convert_torch_state_dict` applies), takes that flax
array and undoes its layout. Inverting the regexes instead does not work:
`\\.(\\d+)\\.` -> `_\\1.` has no unique inverse (`time_embedding.linear_1` is a
real name, not `linear.1`). The other direction, for `save_pretrained`, needs
no inverse either: `torch_to_flax_state_dict` maps each torch key forward
through the same map and lays the tensor out as flax does.

Pure numpy + torch: the key maps below are copies of the JAX package's
tuples, so this module never imports it.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# regex renames applied in order, or a function of the torch key
KeyMap = Union[Sequence[Tuple[str, str]], Callable[[str], str]]

# paddlemix_tpu/diffusers/models/unet_2d_condition.py _UNET_KEY_MAP
UNET_KEY_MAP: KeyMap = (
    (r"\.to_out\.0\.", r".to_out."),
    (r"\.net\.0\.", r".net_0."),
    (r"\.net\.2\.", r".net_2."),
    (r"\.(\d+)\.", r"_\1."),
    (r"(^|\.)((conv_)?norm[^.]*|group_norm)\.weight$", r"\1\2.scale"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/diffusers/models/controlnet.py _CONTROLNET_KEY_MAP: the
# ControlNet's own modules, then the UNet's renames for its encoder half
CONTROLNET_KEY_MAP: KeyMap = (
    (r"\.controlnet_down_blocks\.(\d+)\.", r".controlnet_down_blocks_\1."),
    (r"^controlnet_down_blocks\.(\d+)\.", r"controlnet_down_blocks_\1."),
    (r"\.conditioning_embedding\.", r".controlnet_cond_embedding."),
) + tuple(UNET_KEY_MAP)

# paddlemix_tpu/diffusers/models/adapter.py: the JAX T2IAdapter has no torch
# key map; the port's names (diffusers' FullAdapter's, without its `adapter.`
# prefix) -> the flax T2IAdapterModule's (`body_0.resnets_1.block2.kernel`)
T2I_ADAPTER_KEY_MAP: KeyMap = (
    (r"\.(\d+)\.", r"_\1."),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/diffusers/models/autoencoder_kl.py _VAE_KEY_MAP
VAE_KEY_MAP: KeyMap = (
    (r"\.to_out\.0\.", r".to_out."),
    (r"\.(\d+)\.", r"_\1."),
    (r"(^|\.)((conv_)?norm[^.]*|group_norm)\.weight$", r"\1\2.scale"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/models/clip/modeling.py _CLIP_KEY_MAP. It serves the towers
# alone and the dual tower (`CLIPModel`): its `visual_projection.weight` and
# `text_projection.weight` become the flax Dense kernels (transposed by
# `_to_torch_layout`), and the 0-d `logit_scale` keeps its name
CLIP_KEY_MAP: KeyMap = (
    (r"^text_model\.embeddings\.token_embedding\.weight$", r"text_model.token_embedding.embedding"),
    (r"^text_model\.embeddings\.position_embedding\.weight$", r"text_model.position_embedding"),
    (r"^vision_model\.embeddings\.patch_embedding\.weight$", r"vision_model.patch_embed.proj.kernel"),
    (r"^vision_model\.embeddings\.class_embedding$", r"vision_model.class_embedding"),
    (r"^vision_model\.embeddings\.position_embedding\.weight$", r"vision_model.position_embedding"),
    (r"\.encoder\.layers\.(\d+)\.", r".layers_\1."),
    (r"\.self_attn\.", r".attn."),
    (r"\.layer_norm1\.", r".norm1."),
    (r"\.layer_norm2\.", r".norm2."),
    (r"\.pre_layrnorm\.", r".pre_layernorm."),
    (r"\.post_layernorm\.", r".post_layernorm."),
    (r"\.final_layer_norm\.", r".final_layer_norm."),
    (r"(norm[^.]*|norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/models/clip/eva.py _EVA_VISION_KEY_MAP: EVA's torch checkpoint
# names (the port's EVAVisionTransformer's) -> the flax EVA tower's
EVA_VISION_KEY_MAP: KeyMap = (
    (r"^visual\.", r""),
    (r"^blocks\.(\d+)\.", r"blocks_\1."),
    (r"\.attn\.", r"."),
    (r"\.mlp\.", r"."),
    (r"(norm[^.]*|ffn_ln|inner_attn_ln|fc_norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


def eva_clip_key_to_flax(key: str) -> str:
    """An `EVACLIP` key -> the JAX EVACLIPModule's flax key: `visual.*`
    through the EVA tower's map under `visual.`, the text tower, its
    projection and `logit_scale` through the CLIP map (the JAX module holds
    the CLIP text tower under `text_model`)."""
    if key.startswith("visual."):
        return "visual." + torch_key_to_flax(key, EVA_VISION_KEY_MAP)
    return torch_key_to_flax(key, CLIP_KEY_MAP)


EVA_CLIP_KEY_MAP: KeyMap = eva_clip_key_to_flax

# paddlemix_tpu/diffusers/models/transformer_sd3.py _SD3_KEY_MAP (the port's
# module names are the flax names, so only the block index and `.kernel` move;
# the JAX package fuses diffusers' to_q/to_k/to_v before this map, and the
# port's `attn_qkv` / `attn_add_qkv` are fused already)
SD3_KEY_MAP: KeyMap = (
    (r"\.transformer_blocks\.(\d+)\.", r".transformer_blocks_\1."),
    (r"^transformer_blocks\.(\d+)\.", r"transformer_blocks_\1."),
    (r"\.norm1\.linear\.", r".norm1_linear."),
    (r"\.norm1_context\.linear\.", r".norm1_context_linear."),
    (r"\.norm_out\.linear\.", r".norm_out_linear."),
    (r"\.ff\.net\.0\.proj\.", r".ff_fc1."),
    (r"\.ff\.net\.2\.", r".ff_fc2."),
    (r"\.ff_context\.net\.0\.proj\.", r".ff_context_fc1."),
    (r"\.ff_context\.net\.2\.", r".ff_context_fc2."),
    (r"\.attn\.to_out\.0\.", r".attn_to_out."),
    (r"\.attn\.to_add_out\.", r".attn_to_add_out."),
    (r"\.pos_embed\.proj\.", r".pos_embed.proj."),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/diffusers/models/dit.py has no torch key map: the port's
# module names are the flax DiTModule's, so the blocks are renumbered, the
# label table is nn.Embed's `embedding` and the rest `.kernel`
DIT_KEY_MAP: KeyMap = (
    (r"^blocks\.(\d+)\.", r"blocks_\1."),
    (r"\.embedding_table\.weight$", r".embedding_table.embedding"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/diffusers/models/pixart.py likewise: the port's names are the
# flax PixArtModule's, the blocks' attention and GEGLU feed-forward named as
# the UNet's (`to_out.0`, `net.0`, `net.2` -> `to_out`, `net_0`, `net_2`);
# the per-block and final `scale_shift_table`s keep their names
PIXART_KEY_MAP: KeyMap = (
    (r"^blocks\.(\d+)\.", r"blocks_\1."),
    (r"\.to_out\.0\.", r".to_out."),
    (r"\.net\.0\.", r".net_0."),
    (r"\.net\.2\.", r".net_2."),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/models/t5/modeling.py _T5_KEY_MAP. The port's T5 holds one
# table, `shared`; HF's `encoder.embed_tokens.weight` (the same tensor) maps
# to the same flax key, so a module that held both would claim it twice.
T5_KEY_MAP: KeyMap = (
    (r"^encoder\.embed_tokens\.weight$", r"shared.embedding"),
    (r"^shared\.weight$", r"shared.embedding"),
    (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.", r"block_\1.attention."),
    (r"^encoder\.block\.(\d+)\.layer\.0\.layer_norm\.", r"block_\1.attn_norm."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.", r"block_\1."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.layer_norm\.", r"block_\1.mlp_norm."),
    (r"^encoder\.final_layer_norm\.", r"final_layer_norm."),
    (r"relative_attention_bias\.weight$", r"relative_attention_bias.embedding"),
    (r"(_norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


# paddlemix_tpu/models/llama/modeling.py _LLAMA_KEY_MAP
LLAMA_KEY_MAP: KeyMap = (
    (r"^model\.", r""),
    (r"embed_tokens\.weight$", r"embed_tokens.embedding"),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"^layers\.(\d+)\.", r"layers_\1."),
    (r"(layernorm|norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/models/opt/modeling.py _OPT_KEY_MAP: HF's OPT names (the
# port's) -> the JAX OPTModule's
OPT_KEY_MAP: KeyMap = (
    (r"^model\.decoder\.", r""),
    (r"^decoder\.", r""),
    (r"embed_tokens\.weight$", r"embed_tokens.embedding"),
    (r"embed_positions\.weight$", r"embed_positions.embedding"),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"^layers\.(\d+)\.", r"layers_\1."),
    (r"(_layer_norm|layer_norm)\.weight$", r"\1.scale"),
    (r"^final_layer_norm\.weight$", r"final_layer_norm.scale"),
    (r"\.weight$", r".kernel"),
)

# The port's BLIP-2 Q-Former (`models/blip2/modeling.py`) names its modules as
# the JAX QFormer does, its layers a ModuleList: only the layer index, the
# norms' scale and the Dense kernels move
QFORMER_KEY_MAP: KeyMap = (
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"(norm|layernorm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


# the CLIP map, and BLIP-2's patch-embedding bias (CLIP's patch conv has none)
_BLIP2_VISION_KEY_MAP: KeyMap = ((r"^vision_model\.embeddings\.patch_embedding\.bias$",
                                  r"vision_model.patch_embed.proj.bias"),) + tuple(CLIP_KEY_MAP)


def blip2_key_to_flax(key: str) -> str:
    """A `Blip2ForConditionalGeneration` key -> the JAX Blip2Module's flax
    key: the vision tower (`vision_model.*`, the port's CLIP tower) through
    the CLIP map (and its patch bias), the Q-Former and the projection through QFORMER_KEY_MAP, the
    language model (`language_model.model.decoder.*`, HF's OPT names) through
    OPT_KEY_MAP under `language_model.`; `query_tokens` keeps its name."""
    if key.startswith("vision_model."):
        return torch_key_to_flax(key, _BLIP2_VISION_KEY_MAP)
    if key.startswith("language_model."):
        return "language_model." + torch_key_to_flax(key[len("language_model."):], OPT_KEY_MAP)
    return torch_key_to_flax(key, QFORMER_KEY_MAP)


BLIP2_KEY_MAP: KeyMap = blip2_key_to_flax

# paddlemix_tpu/models/llava/modeling.py LlavaForConditionalGeneration
# .convert_foreign_state_dict: prefix renames, then the vision tower's or the
# language model's, then the shared pass it hands convert_torch_state_dict
_LLAVA_PREFIX_RENAMES = (
    (r"^language_model\.model\.", "language_model."),
    (r"^vision_tower\.vision_model\.", "vision_tower."),
    (r"^model\.mm_projector\.0\.", "multi_modal_projector.linear_0."),
    (r"^model\.mm_projector\.2\.", "multi_modal_projector.linear_1."),
    (r"^(model\.)?image_newline$", "image_newline"),
    (r"^model\.", "language_model."),
    (r"^lm_head\.", "language_model.lm_head."),
    (r"^multi_modal_projector\.linear_1\.", "multi_modal_projector.linear_0."),
    (r"^multi_modal_projector\.linear_2\.", "multi_modal_projector.linear_1."),
)
_LLAVA_VISION_RENAMES = (
    (r"\.encoder\.layers\.(\d+)\.", r".layers_\1."),
    (r"\.self_attn\.", r".attn."),
    (r"\.layer_norm1\.", r".norm1."),
    (r"\.layer_norm2\.", r".norm2."),
    (r"\.pre_layrnorm\.", r".pre_layernorm."),
    (r"\.embeddings\.patch_embedding\.", r".patch_embed.proj."),
    (r"\.embeddings\.class_embedding$", r".class_embedding"),
    (r"\.embeddings\.position_embedding\.weight$", r".position_embedding"),
)
_LLAVA_TEXT_RENAMES = (
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"embed_tokens\.weight$", "embed_tokens.embedding"),
)
_LLAVA_SHARED = (
    (r"(layernorm|norm[0-9]?|norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


def llava_key_to_flax(key: str) -> str:
    """A llava-hf torch key -> the JAX LLaVA's flax key."""
    key = torch_key_to_flax(key, _LLAVA_PREFIX_RENAMES)
    key = torch_key_to_flax(key, _LLAVA_VISION_RENAMES if key.startswith("vision_tower.")
                            else _LLAVA_TEXT_RENAMES)
    return torch_key_to_flax(key, _LLAVA_SHARED)


LLAVA_KEY_MAP: KeyMap = llava_key_to_flax


# paddlemix_tpu/models/qwen2_vl/modeling.py: the port's Qwen2-VL names its
# vision tower's modules as the JAX Qwen2VisionTransformer does (blocks a
# ModuleList, `patch_embed` a bias-less Dense of the flattened patch), and
# holds its language model as a LlamaForCausalLM (HF's Qwen2 names)
_QWEN2_VL_VISION_KEY_MAP: KeyMap = (
    (r"\.blocks\.(\d+)\.", r".blocks_\1."),
    (r"(norm\d|merger_ln)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


def qwen2_vl_key_to_flax(key: str) -> str:
    """A `Qwen2VLForConditionalGeneration` key -> the JAX Qwen2VLModule's flax
    key: the tower (`visual.*`) by its own map, the language model
    (`language_model.model.*`, `language_model.lm_head.*`) through
    LLAMA_KEY_MAP under `language_model.`."""
    if key.startswith("language_model."):
        return "language_model." + torch_key_to_flax(key[len("language_model."):],
                                                     LLAMA_KEY_MAP)
    return torch_key_to_flax(key, _QWEN2_VL_VISION_KEY_MAP)


QWEN2_VL_KEY_MAP: KeyMap = qwen2_vl_key_to_flax

# paddlemix_tpu/models/qwen2_vl/modeling.py Qwen2VLForConditionalGeneration
# .convert_foreign_state_dict: HF's Qwen2-VL keys (the published checkpoints'
# `model.*`, `lm_head.*`, `visual.*`) -> the JAX module's, before the shared
# pass it hands convert_torch_state_dict
QWEN2_VL_HF_RENAMES: KeyMap = (
    (r"^model\.", "language_model."),
    (r"^lm_head\.", "language_model.lm_head."),
    (r"^language_model\.language_model\.", "language_model."),
    (r"language_model\.embed_tokens\.weight$", "language_model.embed_tokens.embedding"),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"^visual\.patch_embed\.proj\.weight$", "visual.patch_embed.weight"),
    (r"^visual\.blocks\.(\d+)\.", r"visual.blocks_\1."),
    (r"\.attn\.qkv\.", ".qkv."),
    (r"\.attn\.proj\.", ".proj."),
    (r"\.mlp\.fc1\.", ".fc1."),
    (r"\.mlp\.fc2\.", ".fc2."),
    (r"^visual\.merger\.ln_q\.", "visual.merger_ln."),
    (r"^visual\.merger\.mlp\.0\.", "visual.merger_fc1."),
    (r"^visual\.merger\.mlp\.2\.", "visual.merger_fc2."),
)
QWEN2_VL_HF_SHARED: KeyMap = (
    (r"(layernorm|_ln|ln_q|norm\d?|norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


# paddlemix_tpu/models/internvl2/modeling.py: the port's InternVL2 names its
# tower's modules as the JAX InternVisionModel does (layers a ModuleList),
# the projector `mlp1_ln` / `mlp1_fc1` / `mlp1_fc2`, and holds its language
# model as a LlamaForCausalLM (HF's Llama names)
_INTERNVL_VISION_KEY_MAP: KeyMap = (
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"(norm1|norm2|q_norm|k_norm|mlp1_ln)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


def internvl_key_to_flax(key: str) -> str:
    """An `InternVLChatModel` key -> the JAX InternVLChatModule's flax key:
    the tower and the projector by their own map, the language model
    (`language_model.model.*`, `language_model.lm_head.*`) through
    LLAMA_KEY_MAP under `language_model.`."""
    if key.startswith("language_model."):
        return "language_model." + torch_key_to_flax(key[len("language_model."):],
                                                     LLAMA_KEY_MAP)
    return torch_key_to_flax(key, _INTERNVL_VISION_KEY_MAP)


INTERNVL_KEY_MAP: KeyMap = internvl_key_to_flax

# paddlemix_tpu/models/internvl2/modeling.py _INTERNVL_KEY_MAP: the published
# InternVL2 checkpoints' keys -> the JAX module's, after the grouped `wqkv`
# split; the one change: InternLM2's `output` (the lm_head), which JAX maps
# to a key no parameter has, is read as the lm_head (ROADMAP C.42)
INTERNVL_HF_KEY_MAP: KeyMap = (
    (r"^vision_model\.embeddings\.", r"vision_model."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.", r"vision_model.layers_\1."),
    (r"\.mlp\.fc1\.", r".fc1."),
    (r"\.mlp\.fc2\.", r".fc2."),
    (r"(q_norm|k_norm|norm1|norm2)\.weight$", r"\1.scale"),
    (r"^mlp1\.0\.weight$", r"mlp1_ln.scale"),
    (r"^mlp1\.0\.bias$", r"mlp1_ln.bias"),
    (r"^mlp1\.1\.", r"mlp1_fc1."),
    (r"^mlp1\.3\.", r"mlp1_fc2."),
    (r"^language_model\.model\.", r"language_model."),
    (r"language_model\.embed_tokens\.weight$", r"language_model.embed_tokens.embedding"),
    (r"language_model\.tok_embeddings\.weight$", r"language_model.embed_tokens.embedding"),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"\.attention\.wo\.", r".self_attn.o_proj."),
    (r"\.feed_forward\.w1\.", r".mlp.gate_proj."),
    (r"\.feed_forward\.w3\.", r".mlp.up_proj."),
    (r"\.feed_forward\.w2\.", r".mlp.down_proj."),
    (r"\.attention_norm\.", r".input_layernorm."),
    (r"\.ffn_norm\.", r".post_attention_layernorm."),
    (r"^language_model\.output\.weight$", r"language_model.lm_head.weight"),
    (r"(layernorm|norm)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)

# paddlemix_tpu/models/qwen_vl/modeling.py: the port's Qwen-VL names its
# tower's modules as the JAX QwenVisionTransformer does (resblocks a
# ModuleList) and holds its language model as a LlamaForCausalLM
_QWEN_VL_VISION_KEY_MAP: KeyMap = (
    (r"\.resblocks\.(\d+)\.", r".resblocks_\1."),
    (r"(ln_q|ln_kv|ln_post|ln_pre|ln_1|ln_2)\.weight$", r"\1.scale"),
    (r"\.weight$", r".kernel"),
)


def qwen_vl_key_to_flax(key: str) -> str:
    """A `QwenVLForConditionalGeneration` key -> the JAX QwenVLModule's flax
    key: the tower (`visual.*`) by its own map, the language model through
    LLAMA_KEY_MAP under `language_model.`."""
    if key.startswith("language_model."):
        return "language_model." + torch_key_to_flax(key[len("language_model."):],
                                                     LLAMA_KEY_MAP)
    return torch_key_to_flax(key, _QWEN_VL_VISION_KEY_MAP)


QWEN_VL_KEY_MAP: KeyMap = qwen_vl_key_to_flax

# paddlemix_tpu/models/qwen_vl/modeling.py _QWEN_VL_KEY_MAP: the published
# Qwen-VL checkpoint's keys (after the Resampler's and c_attn's q / k / v
# splits) -> the JAX module's, with the language model's embedding, MLP
# output projection and final norm read into the Llama's names, which JAX's
# map misses (ROADMAP C.41); the 2-D weights' `.kernel` and transposes follow
QWEN_VL_HF_RENAMES: KeyMap = (
    (r"^transformer\.visual\.", r"visual."),
    (r"^visual\.transformer\.resblocks\.(\d+)\.", r"visual.resblocks_\1."),
    (r"^visual\.resblocks\.(\d+)\.", r"visual.resblocks_\1."),
    (r"\.attn\.in_proj\.", r".in_proj."),
    (r"\.attn\.out_proj\.", r".out_proj."),
    (r"^(visual\.resblocks_\d+)\.mlp\.(c_fc|c_proj)\.", r"\1.\2."),
    (r"^transformer\.wte\.weight$", r"language_model.embed_tokens.embedding"),
    (r"^transformer\.h\.(\d+)\.", r"language_model.layers_\1."),
    (r"^transformer\.ln_f\.weight$", r"language_model.norm.scale"),
    (r"^lm_head\.", r"language_model.lm_head."),
    (r"\.attn\.c_proj\.", r".self_attn.o_proj."),
    (r"^(language_model\.layers_\d+)\.ln_1\.weight$", r"\1.input_layernorm.scale"),
    (r"^(language_model\.layers_\d+)\.ln_2\.weight$", r"\1.post_attention_layernorm.scale"),
    (r"\.mlp\.w1\.", r".mlp.up_proj."),
    (r"\.mlp\.w2\.", r".mlp.gate_proj."),
    (r"\.mlp\.c_proj\.", r".mlp.down_proj."),
    (r"(ln_q|ln_kv|ln_post|ln_pre|ln_1|ln_2)\.weight$", r"\1.scale"),
)


def torch_key_to_flax(key: str, key_map: KeyMap) -> str:
    if callable(key_map):
        return key_map(key)
    for pat, rep in key_map:
        key = re.sub(pat, rep, key)
    return key


def _permute(arr, perm):
    return arr.permute(*perm) if isinstance(arr, torch.Tensor) else np.transpose(arr, perm)


def _to_torch_layout(flax_key: str, arr):
    """Dense `kernel` (in, out) -> `weight` (out, in), and the same for a
    quantized `kernel_q` (its `scale` keeps (out,)): int8 (in, out), or packed
    int4 (in // 2, out), whose byte j holds rows j and j + in / 2, so that its
    transpose is the port's packed (out, in // 2); conv HWIO -> OIHW.
    `embedding` tables (nn.Embed) and every other array keep their layout: the
    decision is by the flax leaf name, so `time_embedding.linear_1.kernel` is a
    Dense and is transposed. Takes a numpy array or a tensor and returns a
    view of it."""
    if flax_key.endswith((".kernel", ".kernel_q")) and arr.ndim == 2:
        return arr.T
    if flax_key.endswith(".kernel") and arr.ndim == 4:
        return _permute(arr, (3, 2, 0, 1))
    return arr


def _to_flax_layout(flax_key: str, t):
    """The inverse of `_to_torch_layout`: weight (out, in) -> kernel (in, out),
    OIHW -> HWIO; a view."""
    if flax_key.endswith((".kernel", ".kernel_q")) and t.ndim == 2:
        return t.T
    if flax_key.endswith(".kernel") and t.ndim == 4:
        return _permute(t, (2, 3, 1, 0))
    return t


def _as_tensor(arr) -> torch.Tensor:
    """A flax array as a tensor: a tensor as it is (bf16 stays bf16); a numpy
    (or JAX) array's floats through fp32, numpy having no bf16 of its own,
    integers (int8 `kernel_q`, packed int4 included) in their type."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    return torch.from_numpy(np.array(arr) if np.issubdtype(arr.dtype, np.integer)
                            else arr.astype(np.float32))


def _match(flax_flat: Dict[str, object], module: torch.nn.Module, key_map: KeyMap):
    """[(torch key, the module's tensor, flax key)] for every key of `module`'s
    state_dict, checked before any data moves: each torch key must find its
    flax array with the matching shape, and every flax key must be consumed
    exactly once; anything left over on either side raises KeyError."""
    pairs, used = [], {}
    missing, mismatched = [], []
    for tkey, ref in module.state_dict().items():
        fkey = torch_key_to_flax(tkey, key_map)
        if fkey not in flax_flat:
            missing.append(f"{tkey} -> {fkey}")
            continue
        if fkey in used:
            raise KeyError(f"flax key {fkey} claimed by both {used[fkey]} and {tkey}")
        used[fkey] = tkey
        # the shape the layout gives, from a zero-stride view: no data read
        view = np.broadcast_to(np.empty((), np.bool_), tuple(flax_flat[fkey].shape))
        shape = tuple(_to_torch_layout(fkey, view).shape)
        if shape != tuple(ref.shape):
            mismatched.append(f"{tkey}: flax {shape} vs torch {tuple(ref.shape)}")
            continue
        pairs.append((tkey, ref, fkey))
    unused = sorted(set(flax_flat) - set(used))
    if missing or mismatched or unused:
        raise KeyError(f"flax->torch conversion failed: {len(missing)} torch keys without a "
                       f"flax array {missing[:5]}, {len(mismatched)} shape mismatches "
                       f"{mismatched[:5]}, {len(unused)} flax keys unused {unused[:5]}")
    return pairs


def flax_to_torch_state_dict(flax_flat: Dict[str, object], module: torch.nn.Module,
                             key_map: KeyMap) -> Dict[str, torch.Tensor]:
    """flax params flattened to dotted keys (numpy or JAX arrays, or
    tensors) -> `module`'s state_dict, each in the module's dtype; checked as
    `_match` says."""
    return {tkey: _to_torch_layout(fkey, _as_tensor(flax_flat[fkey])).to(ref.dtype)
            for tkey, ref, fkey in _match(flax_flat, module, key_map)}


@torch.no_grad()
def load_flax_state_(module: torch.nn.Module, flax_flat: Dict[str, object],
                     key_map: KeyMap) -> torch.nn.Module:
    """`flax_to_torch_state_dict` into `module` in place, one tensor at a time:
    each flax array goes to the module's device as it is laid out in the file
    (contiguous), is laid out there, cast and copied into the module's
    tensor. The host holds no converted copy of the model."""
    for _, ref, fkey in _match(flax_flat, module, key_map):
        src = _as_tensor(flax_flat[fkey]).to(ref.device)
        ref.copy_(_to_torch_layout(fkey, src))
    return module


def _state_key(name: str) -> Optional[str]:
    """A state_dict key of a module with `torch.nn.utils.parametrize`
    parametrizations -> its plain key: the original tensor of a parametrized
    `weight` is the weight (the base, not the LoRA-merged one); the
    parametrizations' own parameters (LoRA factors) have none."""
    if ".parametrizations." not in name:
        return name
    owner, rest = name.split(".parametrizations.", 1)
    attr, _, tail = rest.partition(".")
    return f"{owner}.{attr}" if tail == "original" else None


def torch_to_flax_state_dict(module: torch.nn.Module, key_map: KeyMap) -> Dict[str, torch.Tensor]:
    """`module`'s state_dict -> {flax key: tensor in the flax layout}, the
    exact inverse of `flax_to_torch_state_dict` (views of the module's
    tensors: no copy, dtype kept, transposes as `_to_flax_layout`). A
    parametrized weight gives its original (a LoRA-adapted projection its
    base weight); the parametrizations' own tensors are left out."""
    out: Dict[str, torch.Tensor] = {}
    owner: Dict[str, str] = {}
    for name, t in module.state_dict().items():
        tkey = _state_key(name)
        if tkey is None:
            continue
        fkey = torch_key_to_flax(tkey, key_map)
        if fkey in out:
            raise KeyError(f"torch->flax: {owner[fkey]} and {tkey} both map to {fkey}")
        owner[fkey] = tkey
        out[fkey] = _to_flax_layout(fkey, t.detach())
    return out


def flatten_flax(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params (dicts of arrays) -> {dotted key: array}."""
    flat = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if hasattr(value, "items"):  # a dict or a flax FrozenDict
            flat.update(flatten_flax(value, key + "."))
        else:
            flat[key] = value
    return flat


@torch.no_grad()
def lora_from_flax(jax_lora: Dict, module: torch.nn.Module, key_map: KeyMap) -> int:
    """Copy the JAX package's LoRA factors ({flax path tuple: {"a": (in, r),
    "b": (r, out)}}, from its `lora_init` or a trained state) into the
    factors `peft.lora_init` attached to `module`: lora_a = a^T (r, in) and
    lora_b = b^T (out, r), so that b^T a^T is the (out, in) delta of the
    torch weight. Every factor pair must be matched exactly once. Returns the
    pairs copied."""
    from ..peft.lora import LoraDelta

    flax = {".".join(path): ab for path, ab in jax_lora.items()}
    used = set()
    for name, m in module.named_modules():
        if not isinstance(m, LoraDelta):
            continue
        # <owner>.parametrizations.weight.0 -> the owner's weight key
        owner = name.rsplit(".parametrizations.", 1)[0]
        fkey = torch_key_to_flax(f"{owner}.weight", key_map)
        if fkey not in flax:
            raise KeyError(f"lora_from_flax: no JAX factors for {owner} ({fkey})")
        a, b = (np.asarray(flax[fkey][k], dtype=np.float32) for k in ("a", "b"))
        if a.T.shape != tuple(m.lora_a.shape) or b.T.shape != tuple(m.lora_b.shape):
            raise ValueError(f"lora_from_flax: {owner}: JAX a {a.shape} b {b.shape} vs port "
                             f"lora_a {tuple(m.lora_a.shape)} lora_b {tuple(m.lora_b.shape)}")
        m.lora_a.copy_(torch.from_numpy(np.ascontiguousarray(a.T)))
        m.lora_b.copy_(torch.from_numpy(np.ascontiguousarray(b.T)))
        used.add(fkey)
    if set(flax) - used:
        raise KeyError(f"lora_from_flax: JAX factors left unused: {sorted(set(flax) - used)[:5]}")
    return len(used)


def lora_to_flax(module: torch.nn.Module, key_map: KeyMap) -> Dict[tuple, Dict[str, torch.Tensor]]:
    """The inverse of `lora_from_flax`: the factors `peft.lora_init` attached
    to `module`, as the JAX package holds them: {flax path tuple of the
    adapted kernel: {"a": lora_a^T (in, r), "b": lora_b^T (r, out)}}, views
    of the port's factors."""
    from ..peft.lora import LoraDelta

    out = {}
    for name, m in module.named_modules():
        if isinstance(m, LoraDelta):
            owner = name.rsplit(".parametrizations.", 1)[0]
            path = tuple(torch_key_to_flax(f"{owner}.weight", key_map).split("."))
            out[path] = {"a": m.lora_a.detach().T, "b": m.lora_b.detach().T}
    return out
