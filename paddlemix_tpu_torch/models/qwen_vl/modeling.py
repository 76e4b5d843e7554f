"""Qwen-VL (v1): the ViT-bigG tower with its Resampler, and QWen's language
model as the port's Llama (q / k / v biases, NTK-aware rope and logn
attention scaling). Port of paddlemix_tpu/models/qwen_vl/modeling.py.

Each image becomes `num_queries` (256) features of the language model's
width; `splice` gives the j-th image placeholder of a row the j-th feature of
all images together (JAX's cumsum scatter: every row of a batch reads the one
feature set). Generation is `greedy_generate` over the language model and
the dense cache, as the JAX package serves it.

Kernels on this path, each launched for CUDA tensors (plain versions on the
CPU): the tower's (visual.py: B10, B1); RMSNorm (B11) for the language
model's norms and decode attention over the dense cache (B7, G 1) for every
single-token step, its q scaled by logn first where `use_logn_attn` is on.
The prefill over the cache runs math attention, as the JAX package's
`attention_xla`.

Parameter names follow the JAX module's under `visual` and HF's Llama under
`language_model` (`core.convert.QWEN_VL_KEY_MAP`). `from_pretrained` reads a
flax-keyed directory or the published checkpoint's keys (`transformer.*`,
`lm_head.*`) through `convert_hf_state_dict`, which reads every weight of the
language model, where JAX's key map leaves four kinds unread (ROADMAP C.41).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from ...core.config import BaseConfig
from ...core.convert import QWEN_VL_HF_RENAMES, QWEN_VL_KEY_MAP, torch_key_to_flax
from ..layers import FusedLayerNorm, device_tensor
from ..llama.configuration import LlamaConfig
from ..llama.modeling import KVCache, LlamaForCausalLM, RMSNorm, greedy_generate
from .visual import QwenVisionConfig, QwenVisionTransformer


@dataclasses.dataclass
class QwenVLConfig(BaseConfig):
    model_type = "qwen_vl"
    vision_config: Optional[Dict[str, Any]] = None
    text_config: Optional[Dict[str, Any]] = None
    num_queries: int = 256
    image_token_id: int = 151857  # placeholder id of the spliced features

    def __post_init__(self):
        self.vision_config = self.vision_config or {}
        self.text_config = self.text_config or {}

    @property
    def vision(self) -> QwenVisionConfig:
        """The tower's config; CLIP-style names are taken for the tower's
        (hidden_size, num_hidden_layers, num_attention_heads; an
        intermediate_size gives the MLP ratio), as in JAX; output_dim is the
        language model's width unless given."""
        d = dict(self.vision_config)
        alias = {"hidden_size": "width", "num_hidden_layers": "layers",
                 "num_attention_heads": "heads"}
        for src, dst in alias.items():
            if src in d and dst not in d:
                d[dst] = d.pop(src)
            d.pop(src, None)
        if "intermediate_size" in d:
            inter = d.pop("intermediate_size")
            if "width" in d and "mlp_ratio" not in d:
                d["mlp_ratio"] = inter / d["width"]
        d.setdefault("output_dim", self.text.hidden_size)
        return QwenVisionConfig.from_dict(d)

    @property
    def text(self) -> LlamaConfig:
        """QWen's language model: the Llama with q / k / v biases."""
        return LlamaConfig.from_dict(dict(self.text_config, attention_bias=True))


class QwenVLForConditionalGeneration(nn.Module):
    """Qwen-VL with generation (port of the JAX QwenVLModule and
    QwenVLForConditionalGeneration). Inputs may be tensors or numpy arrays;
    they go to the model's device."""

    flax_key_map = staticmethod(QWEN_VL_KEY_MAP)  # its names -> the JAX QwenVLModule's

    def __init__(self, config: QwenVLConfig):
        super().__init__()
        self.config = config
        self.visual = QwenVisionTransformer(config.vision, num_queries=config.num_queries)
        self.language_model = LlamaForCausalLM(config.text)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda", dtype: torch.dtype = torch.float32):
        """The model of directory `path` (config.json and flax-keyed weights,
        or the published checkpoint's through `convert_hf_state_dict`) on
        `device`, its parameters in `dtype` but the norms' (fp32)."""
        from ...core.modeling import from_pretrained

        return from_pretrained(cls, QwenVLConfig, QWEN_VL_KEY_MAP, path, device=device,
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

    def encode_images(self, pixel_values):
        """(N, H, W, 3) images -> (N, num_queries, text hidden)."""
        return self.visual(device_tensor(pixel_values, self.device).to(self.language_model.dtype))

    def splice(self, input_ids, image_features):
        """Token embeddings with the j-th placeholder of each row replaced by
        feature row j of all images' features (N, Q, D) flattened."""
        cfg = self.config
        is_img = input_ids == cfg.image_token_id
        token_embeds = self.language_model.embed(input_ids.masked_fill(is_img, 0))
        flat = image_features.reshape(1, -1, image_features.shape[-1])
        idx = (is_img.long().cumsum(dim=-1) - 1).clamp(0, flat.shape[1] - 1)
        gathered = flat.expand(input_ids.shape[0], -1, -1).gather(
            1, idx[:, :, None].expand(-1, -1, flat.shape[-1]))
        return torch.where(is_img[:, :, None], gathered.to(token_embeds.dtype), token_embeds)

    def _embeds(self, input_ids, pixel_values):
        if pixel_values is None:
            return None
        return self.splice(input_ids, self.encode_images(pixel_values))

    def forward(self, input_ids, pixel_values=None, positions=None, *, segment_ids=None,
                cache: Optional[KVCache] = None):
        """-> (logits (B, S, vocab), cache). With pixels, the images' features
        are spliced in."""
        input_ids = device_tensor(input_ids, self.device, torch.long)
        return self.language_model(input_ids, positions,
                                   inputs_embeds=self._embeds(input_ids, pixel_values),
                                   segment_ids=segment_ids, cache=cache)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """The dense cache in `dtype` (the language model's by default), as
        the JAX model builds it."""
        lm = self.language_model
        return KVCache.create(lm.config, batch, max_len, dtype=dtype or lm.dtype, device=lm.device)

    @torch.inference_mode()
    def generate(self, input_ids, pixel_values=None, attention_mask=None,
                 max_new_tokens: int = 32, **kwargs):
        """Greedy or sampled generation with the images spliced into the
        prefill (kwargs as `greedy_generate`: eos_token_id, sampling,
        generator). -> (B, max_new_tokens) int32."""
        input_ids = device_tensor(input_ids, self.device, torch.long)
        b, s = input_ids.shape
        return greedy_generate(self.language_model, input_ids, attention_mask,
                               max_new_tokens=max_new_tokens,
                               inputs_embeds=self._embeds(input_ids, pixel_values),
                               cache=self.init_cache(b, s + max_new_tokens), **kwargs)


def convert_hf_state_dict(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published Qwen-VL checkpoint's tensors (`transformer.visual.*`,
    `transformer.{wte, h.N, ln_f}.*`, `lm_head.*`; views of the mapped files)
    -> the JAX QwenVLModule's flax keys and layouts. The Resampler's packed
    `attn.in_proj_{weight,bias}` split into q / k / v thirds, as the JAX
    `convert_foreign_state_dict` splits them; QWen's fused `c_attn` split the
    same way into q / k / v ([Q; K; V] rows), which JAX leaves to a fused
    layer its model does not build. The renames (`QWEN_VL_HF_RENAMES`) read
    the language model's embedding, MLP output and final norm into the
    Llama's names, which JAX's map misses (ROADMAP C.41)."""
    from ...core.modeling import convert_torch_state_dict

    out = {}
    for k, v in flat.items():
        m = re.match(r"^(.*attn_pool)\.attn\.in_proj_(weight|bias)$", k) or \
            re.match(r"^(transformer\.h\.\d+\.attn)\.c_attn\.(weight|bias)$", k)
        if m:
            prefix, kind = m.groups()
            prefix = prefix.replace(".attn", ".self_attn") if prefix.startswith(
                "transformer.h.") else prefix
            for name, part in zip("qkv", v.chunk(3, dim=0)):
                out[f"{prefix}.{name}_proj.{kind}"] = part
        elif re.search(r"attn_pool\.attn\.out_proj", k):
            out[k.replace("attn.out_proj", "out_proj")] = v
        else:
            out[k] = v
    out = {torch_key_to_flax(k, QWEN_VL_HF_RENAMES): v for k, v in out.items()}
    return convert_torch_state_dict(out, ((r"\.weight$", ".kernel"),))
