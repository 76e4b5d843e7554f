"""PixArt-alpha text-to-image (port of
paddlemix_tpu/diffusers/pipelines/pixart_alpha.py): T5 caption encoding, the
PixArt transformer's denoise loop (the learned variance dropped, then
classifier-free guidance) and the VAE decode.

As JAX: the prompt and the negative prompt are encoded apart and the context
is [negative, prompt]; no caption mask is passed (ROADMAP C.37); the latents
are scaled by the scheduler's `init_noise_sigma` and each step's input by
`scale_model_input`. The tokenizer is any callable mapping a list of texts to
{"input_ids": (B, L) ids} (`diffusers.sd3.seeded_t5_tokenizer(length=120)`
stands in for T5's). Registered, so `DiffusionPipeline.from_pretrained`
reads its directory, with the tokenizer as an override. The JAX package
compiles the denoise loop into one lax.fori_loop; here it is a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..image_processor import VaeImageProcessor
from .pipeline_utils import DiffusionPipeline, register_pipeline


@register_pipeline
class PixArtAlphaPipeline(DiffusionPipeline):
    def __init__(self, tokenizer, text_encoder, vae, transformer, scheduler):
        self.register_modules(tokenizer=tokenizer, text_encoder=text_encoder, vae=vae,
                              transformer=transformer, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1) if vae else 8
        self.image_processor = VaeImageProcessor()

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    @torch.inference_mode()
    def encode_prompt(self, prompt):
        """(B, L, caption_channels) T5 hidden states of a list of texts."""
        ids = torch.as_tensor(np.asarray(self.tokenizer(prompt)["input_ids"]), dtype=torch.long,
                              device=self.device)
        out = self.text_encoder(ids)
        return out[0] if isinstance(out, tuple) else out

    @torch.inference_mode()
    def __call__(self, prompt, negative_prompt=None, height=None, width=None,
                 num_inference_steps: int = 20, guidance_scale: float = 4.5, seed: int = 0,
                 output_type: str = "np", latents=None):
        """Defaults as JAX's: 20 steps, guidance 4.5, the transformer's
        sample size. `latents`: optional (B, H/8, W/8, C) NHWC noise, else
        drawn from a torch.Generator seeded with `seed`."""
        if isinstance(prompt, str):
            prompt = [prompt]
        negative_prompt = negative_prompt or [""] * len(prompt)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        do_cfg = guidance_scale > 1.0
        cond = self.encode_prompt(prompt)
        ctx = torch.cat([self.encode_prompt(negative_prompt), cond]) if do_cfg else cond

        device, tf = self.device, self.transformer
        cfg, f = tf.config, self.vae_scale_factor
        height = height or cfg.sample_size * f
        width = width or cfg.sample_size * f
        shape = (len(prompt), height // f, width // f, cfg.in_channels)
        if latents is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        latents = torch.as_tensor(latents).to(device=device, dtype=torch.float32)
        state = self.scheduler.set_timesteps(num_inference_steps)
        latents = latents * self.scheduler.init_noise_sigma
        ctx = ctx.to(tf.dtype)
        for i in range(num_inference_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            lat_in = self.scheduler.scale_model_input(state, lat_in, i)
            t_in = state.timesteps[i].to(device).expand(lat_in.shape[0])
            pred = tf(lat_in.to(tf.dtype), t_in, ctx)[..., :cfg.in_channels].float()
            if do_cfg:
                un, co = pred.chunk(2)
                pred = un + guidance_scale * (co - un)
            latents, state = self.scheduler.step(state, pred, i, latents)
        if output_type == "latent":
            return (latents,)
        image = self.vae.decode(latents / self.vae.config.scaling_factor).float()
        return (self.image_processor.postprocess(image, output_type),)
