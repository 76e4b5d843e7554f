"""LLaVA 1.5: CLIP vision tower + mlp2x_gelu projector + Llama. Port of
paddlemix_tpu/models/llava/modeling.py for square images and the CLIP tower
(anyres, SigLIP towers and the image-newline merge are not ported yet).

The prompt carries one placeholder id (`image_token_index`, the vocab size
for LLaVA-1.5) per vision patch, and `splice_image_features` swaps the
projected features in by a cumulative count, with static shapes, as the JAX
package does. Parameter names follow HF llava-hf (vision_tower.vision_model.*,
multi_modal_projector.linear_1/2, language_model.model.*,
language_model.lm_head), which the JAX package's LLaVA renames map
(core.convert.llava_key_to_flax).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import LLAVA_KEY_MAP
from ..clip.configuration import CLIPVisionConfig
from ..clip.modeling import CLIPVisionModel
from ..llama.configuration import LlamaConfig
from ..llama.modeling import KVCache, LlamaForCausalLM, RMSNorm, greedy_generate


@dataclasses.dataclass
class LlavaConfig(BaseConfig):
    model_type = "llava"
    vision_config: Optional[Dict[str, Any]] = None
    text_config: Optional[Dict[str, Any]] = None
    image_token_index: int = 32000
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"  # drop CLS
    mm_projector_type: str = "mlp2x_gelu"
    vision_tower_type: str = "clip"
    image_aspect_ratio: str = "square"
    mm_patch_merge_type: str = "flat"

    def __post_init__(self):
        self.vision_config = dict(self.vision_config or {})
        self.text_config = dict(self.text_config or {})
        if self.vision_tower_type != "clip" or self.image_aspect_ratio == "anyres" \
                or self.mm_patch_merge_type != "flat" \
                or self.mm_vision_select_feature != "patch" \
                or self.mm_projector_type != "mlp2x_gelu" \
                or not self.vision_config.get("use_pre_layernorm", True) \
                or self.vision_config.get("post_layernorm_full", False):
            raise NotImplementedError("LlavaConfig: only the pre-LN CLIP tower (post-LN on "
                                      "CLS), one image of fixed size, patch features (CLS "
                                      "dropped), the mlp2x_gelu projector and the flat merge "
                                      "are ported")

    @property
    def vision(self) -> CLIPVisionConfig:
        return CLIPVisionConfig(**self.vision_config)

    @property
    def text(self) -> LlamaConfig:
        return LlamaConfig.from_dict(self.text_config)

    @property
    def num_image_tokens(self) -> int:
        v = self.vision
        return (v.image_size // v.patch_size) ** 2


class MMProjector(nn.Module):
    """Vision features -> text width ("mlp2x_gelu"): Linear, exact (erf) GELU
    at every dtype, Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x), approximate="none"))


class LlavaModule(nn.Module):
    def __init__(self, config: LlavaConfig):
        super().__init__()
        self.config = config
        self.vision_tower = CLIPVisionModel(config.vision)
        self.multi_modal_projector = MMProjector(config.vision.hidden_size,
                                                 config.text.hidden_size)
        self.language_model = LlamaForCausalLM(config.text)

    def encode_images(self, pixel_values):
        """(B, H, W, 3) pixels, NHWC as in the JAX package ->
        (B, num_image_tokens, text_hidden): the hidden states of layer
        `mm_vision_select_layer` (-2), CLS dropped, projected."""
        _, _, hiddens = self.vision_tower(pixel_values, output_hidden_states=True)
        return self.multi_modal_projector(hiddens[self.config.mm_vision_select_layer][:, 1:])

    def splice_image_features(self, input_ids, image_features):
        """Token embeddings with every placeholder replaced by the next image
        feature. The placeholder id is the vocab size, past the table's end:
        flax's lookup does not fault there but nn.Embedding does (a device
        assert on CUDA), so placeholders are looked up as id 0 and replaced."""
        is_img = input_ids == self.config.image_token_index
        token_embeds = self.language_model.embed(input_ids.masked_fill(is_img, 0))
        feat_idx = (is_img.long().cumsum(dim=-1) - 1).clamp(0, image_features.shape[1] - 1)
        gathered = image_features.gather(
            1, feat_idx[:, :, None].expand(-1, -1, image_features.shape[-1]))
        return torch.where(is_img[:, :, None], gathered.to(token_embeds.dtype), token_embeds)

    def forward(self, input_ids, pixel_values=None, positions=None, *,
                cache: Optional[KVCache] = None):
        """-> (logits, cache). With pixels, the image features are spliced in."""
        inputs_embeds = None
        if pixel_values is not None:
            inputs_embeds = self.splice_image_features(input_ids,
                                                       self.encode_images(pixel_values))
        return self.language_model(input_ids, positions, inputs_embeds=inputs_embeds,
                                   cache=cache)


class LlavaForConditionalGeneration(LlavaModule):
    """LLaVA with generation. `language_model` is the Llama the JAX package's
    `_LlamaView` adapter presents to `greedy_generate`; here it already has
    that surface (config, forward), and `generate` hands it the dense cache of
    `init_cache`, which the adapter's `init_cache` builds."""

    flax_key_map = staticmethod(LLAVA_KEY_MAP)  # its names -> the JAX LlavaModule's

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: torch.dtype = torch.float32):
        """The model of directory `path` (config.json and flax- or
        llava-hf-keyed weights) on `device`, its parameters in `dtype` but the
        RMSNorm scales, which stay fp32."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, LlavaConfig, LLAVA_KEY_MAP, path, device=device, build=cls,
                               param_dtype=dtype, fp32_modules=(RMSNorm,),
                               unused=(r".*rotary_emb\.inv_freq$",))

    def save_pretrained(self, directory: str, **kwargs):
        """`core.modeling.save_pretrained` (config.json, flax-keyed
        safetensors)."""
        from ...core.modeling import save_pretrained

        return save_pretrained(self, directory, **kwargs)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The dense cache in `dtype` (the language model's by default),
        whatever the text config's `cachekv_int8` says, as the JAX LLaVA
        builds it."""
        lm = self.language_model
        return KVCache.create(lm.config, batch, max_len, dtype=dtype or lm.dtype, device=lm.device)

    def quantize_(self, mode: str = "a8w8") -> int:
        """`LlamaForCausalLM.quantize_` of the language model's projections
        and lm_head (the vision tower and projector stay); the config becomes
        a copy whose text config has `quant` set. Returns the bytes freed."""
        freed = self.language_model.quantize_(mode)
        self.config = dataclasses.replace(
            self.config, text_config=dict(self.config.text_config, quant=mode))
        return freed

    @torch.inference_mode()
    def generate(self, input_ids, pixel_values=None, attention_mask=None,
                 max_new_tokens: int = 32, **kwargs):
        """Greedy or sampled generation with the image spliced into the
        prefill (kwargs as `greedy_generate`: eos_token_id, sampling,
        generator). -> (B, max_new_tokens) int32."""
        inputs_embeds = None
        if pixel_values is not None:
            dev = self.language_model.device
            input_ids = input_ids.to(dev)
            inputs_embeds = self.splice_image_features(input_ids,
                                                       self.encode_images(pixel_values.to(dev)))
        b, s = input_ids.shape
        return greedy_generate(self.language_model, input_ids, attention_mask,
                               max_new_tokens=max_new_tokens, inputs_embeds=inputs_embeds,
                               cache=self.init_cache(b, s + max_new_tokens), **kwargs)


def llava_loss(logits, labels, ignore_index: int = -100):
    """Shifted masked LM loss (port of `llava_loss`): token t predicts label
    t + 1; the mean over labels that are not `ignore_index` of the fp32
    log-softmax's negative log-likelihood (0 when every label is ignored)."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    labels = labels[:, 1:]
    mask = labels != ignore_index
    nll = -logp.gather(-1, torch.where(mask, labels, 0).long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)
