"""SD3 text-to-image and DiT class-conditional pipelines (port of
StableDiffusion3Pipeline and DiTPipeline in
paddlemix_tpu/diffusers/pipelines/stable_diffusion_3.py).

Same signature and semantics as the JAX pipeline: two CLIP towers with
projection (penultimate hidden states concatenated and zero-padded to the
joint width, pooled outputs concatenated), then T5's output or, without a
third encoder, zeros of 77 tokens; [uncond, cond] classifier-free guidance on
the batch axis; fp32 latents and FlowMatch Euler steps with the transformer
run in its own dtype. `tokenizer_3` is any callable that maps a list of texts
to {"input_ids": (B, L) ids}. Registered, so `DiffusionPipeline.from_pretrained`
reads SD3's published directory (with `tokenizer_3` as an override). The JAX package compiles the denoise loop into
one lax.fori_loop; here it is a Python loop over steps.

`DiTPipeline` samples class labels with classifier-free guidance over
[labels, null class] and guidance on the first `in_channels` output channels
(the learned variance dropped), then decodes with the VAE. Its loop takes any
ported scheduler. JAX's calls `set_timesteps` without the latents' shape, so
DPM-Solver++'s x0 history is carried as (1,) and its fori_loop refuses the
first step (ROADMAP C.39); the port's Python loop carries the history as it
comes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..image_processor import VaeImageProcessor
from .pipeline_utils import DiffusionPipeline, register_pipeline

T5_SEQ_LEN = 77  # context tokens that stand in for T5 when there is no third encoder


@register_pipeline
class StableDiffusion3Pipeline(DiffusionPipeline):
    def __init__(self, transformer, scheduler, vae, text_encoder, tokenizer, text_encoder_2,
                 tokenizer_2, text_encoder_3=None, tokenizer_3=None):
        self.register_modules(transformer=transformer, scheduler=scheduler, vae=vae,
                              text_encoder=text_encoder, tokenizer=tokenizer,
                              text_encoder_2=text_encoder_2, tokenizer_2=tokenizer_2,
                              text_encoder_3=text_encoder_3, tokenizer_3=tokenizer_3)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor()

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    def _ids(self, tok, texts):
        return torch.as_tensor(np.asarray(tok(texts)["input_ids"]), dtype=torch.long,
                               device=self.device)

    def encode_prompt(self, prompt, negative_prompt=None):
        if isinstance(prompt, str):
            prompt = [prompt]
        negative_prompt = negative_prompt or [""] * len(prompt)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        joint_dim = self.transformer.config.joint_attention_dim

        def encode(texts):
            clip_embeds, pooleds = [], []
            for tok, enc in ((self.tokenizer, self.text_encoder),
                             (self.tokenizer_2, self.text_encoder_2)):
                _, pooled, hiddens = enc(self._ids(tok, texts), output_hidden_states=True)
                clip_embeds.append(hiddens[-2])  # penultimate layer
                pooleds.append(pooled)
            clip_embed = torch.cat(clip_embeds, dim=-1)
            clip_embed = F.pad(clip_embed, (0, joint_dim - clip_embed.shape[-1]))
            if self.text_encoder_3 is not None:
                t5_embed = self.text_encoder_3(self._ids(self.tokenizer_3, texts))[0]
            else:
                t5_embed = clip_embed.new_zeros((len(texts), T5_SEQ_LEN, joint_dim))
            return torch.cat([clip_embed, t5_embed], dim=1), torch.cat(pooleds, dim=-1)

        cond, pooled = encode(prompt)
        uncond, neg_pooled = encode(negative_prompt)
        return cond, uncond, pooled, neg_pooled

    def _decode_latents(self, latents):
        cfg = self.vae.config
        latents = latents / cfg.scaling_factor
        if cfg.shift_factor:
            latents = latents + cfg.shift_factor
        return self.vae.decode(latents).float()

    @torch.inference_mode()
    def __call__(self, prompt=None, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 28, guidance_scale: float = 7.0,
                 negative_prompt=None, seed: int = 0, latents=None, output_type: str = "pil",
                 return_dict: bool = False):
        """latents: optional (B, H/8, W/8, C) NHWC noise, numpy or tensor; when
        None it is drawn from a torch.Generator seeded with `seed`."""
        device, dtype = self.device, self.transformer.dtype
        do_cfg = guidance_scale > 1.0
        cond, uncond, pooled, neg_pooled = self.encode_prompt(prompt, negative_prompt)
        context = (torch.cat([uncond, cond]) if do_cfg else cond).to(dtype)
        pooled_all = (torch.cat([neg_pooled, pooled]) if do_cfg else pooled).to(dtype)

        shape = (cond.shape[0], height // self.vae_scale_factor, width // self.vae_scale_factor,
                 self.transformer.config.in_channels)
        if latents is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        elif isinstance(latents, np.ndarray):
            latents = torch.from_numpy(latents)
        latents = latents.to(device=device, dtype=torch.float32)
        state = self.scheduler.set_timesteps(num_inference_steps)

        for i in range(num_inference_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t_in = state.timesteps[i].to(device).expand(lat_in.shape[0])
            pred = self.transformer(lat_in.to(dtype), t_in, context, pooled_all).float()
            if do_cfg:
                un, co = pred.chunk(2)
                pred = un + guidance_scale * (co - un)
            latents, state = self.scheduler.step(state, pred, i, latents)
        if output_type == "latent":
            return (latents,)
        image = self._decode_latents(latents)
        return (self.image_processor.postprocess(image, output_type),)


@register_pipeline
class DiTPipeline(DiffusionPipeline):
    """Class-conditional DiT sampling: defaults as JAX's (25 steps, guidance
    4.0). `class_labels` is a list or tensor of ints; `latents` an optional
    (B, s, s, C) NHWC noise, else drawn from a torch.Generator seeded with
    `seed`."""

    def __init__(self, transformer, vae, scheduler):
        self.register_modules(transformer=transformer, vae=vae, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1) if vae else 8
        self.image_processor = VaeImageProcessor()

    @property
    def device(self) -> torch.device:
        return self.transformer.final_proj.weight.device

    @torch.inference_mode()
    def __call__(self, class_labels, guidance_scale: float = 4.0, num_inference_steps: int = 25,
                 seed: int = 0, output_type: str = "pil", latents=None):
        device, tf = self.device, self.transformer
        cfg = tf.config
        labels = torch.as_tensor(class_labels, dtype=torch.long, device=device)
        do_cfg = guidance_scale > 1.0
        all_labels = torch.cat([labels, torch.full_like(labels, cfg.num_classes)]) if do_cfg \
            else labels
        shape = (labels.shape[0], cfg.sample_size, cfg.sample_size, cfg.in_channels)
        if latents is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        latents = torch.as_tensor(latents).to(device=device, dtype=torch.float32)
        state = self.scheduler.set_timesteps(num_inference_steps)
        for i in range(num_inference_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t_in = state.timesteps[i].to(device).expand(lat_in.shape[0])
            pred = tf(lat_in.to(tf.dtype), t_in, all_labels)[..., :cfg.in_channels].float()
            if do_cfg:
                co, un = pred.chunk(2)
                pred = un + guidance_scale * (co - un)
            latents, state = self.scheduler.step(state, pred, i, latents)
        if output_type == "latent":
            return (latents,)
        image = self.vae.decode(latents / self.vae.config.scaling_factor).float()
        return (self.image_processor.postprocess(image, output_type),)
