"""SDXL text-to-image pipeline (port of StableDiffusionXLPipeline in
paddlemix_tpu/diffusers/pipelines/stable_diffusion.py).

Same signature and semantics as the JAX pipeline: dual text encoders
(penultimate hidden states, pooled embeds from encoder 2), [uncond, cond]
classifier-free guidance on the batch axis, SDXL add_time_ids, fp32 latents
with the UNet run in its own dtype. The JAX package compiles the denoise loop
into one lax.fori_loop; here it is a Python loop over steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..image_processor import VaeImageProcessor
from .pipeline_utils import DiffusionPipeline, make_scheduler_state


class StableDiffusionXLPipeline(DiffusionPipeline):
    def __init__(self, vae, text_encoder, text_encoder_2, tokenizer, tokenizer_2, unet,
                 scheduler):
        self.register_modules(vae=vae, text_encoder=text_encoder,
                              text_encoder_2=text_encoder_2, tokenizer=tokenizer,
                              tokenizer_2=tokenizer_2, unet=unet, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def encode_prompt(self, prompt, negative_prompt=None):
        if isinstance(prompt, str):
            prompt = [prompt]
        negative_prompt = negative_prompt or [""] * len(prompt)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)

        def encode(texts):
            embeds, pooled = [], None
            for tok, enc in ((self.tokenizer, self.text_encoder),
                             (self.tokenizer_2, self.text_encoder_2)):
                ids = torch.as_tensor(tok(texts)["input_ids"], dtype=torch.long,
                                      device=self.device)
                _, pool, hiddens = enc(ids, output_hidden_states=True)
                embeds.append(hiddens[-2])  # penultimate layer, SDXL convention
                pooled = pool  # pooled comes from encoder 2
            return torch.cat(embeds, dim=-1), pooled

        cond, pooled = encode(prompt)
        uncond, neg_pooled = encode(negative_prompt)
        return cond, uncond, pooled, neg_pooled

    def _decode_latents(self, latents):
        cfg = self.vae.config
        latents = latents / cfg.scaling_factor
        if cfg.shift_factor:
            latents = latents + cfg.shift_factor
        return self.vae.decode(latents).float()

    def prepare_inputs(self, prompt, height: int, width: int, guidance_scale: float,
                       negative_prompt=None, seed: int = 0, latents=None,
                       original_size: Optional[Tuple[int, int]] = None,
                       target_size: Optional[Tuple[int, int]] = None,
                       crops_coords_top_left: Tuple[int, int] = (0, 0)):
        """Text conditioning (CFG-doubled when guidance_scale > 1) and the
        initial fp32 noise, before the scheduler's init_noise_sigma."""
        device = self.device
        do_cfg = guidance_scale > 1.0
        cond, uncond, pooled, neg_pooled = self.encode_prompt(prompt, negative_prompt)
        batch = cond.shape[0]
        context = torch.cat([uncond, cond]) if do_cfg else cond

        original_size = original_size or (height, width)
        target_size = target_size or (height, width)
        add_time_ids = torch.tensor(
            [list(original_size) + list(crops_coords_top_left) + list(target_size)],
            dtype=torch.float32, device=device).expand(batch, 6)
        if do_cfg:
            add_text_embeds = torch.cat([neg_pooled, pooled])
            add_time_ids = torch.cat([add_time_ids, add_time_ids])
        else:
            add_text_embeds = pooled

        shape = (batch, height // self.vae_scale_factor, width // self.vae_scale_factor,
                 self.unet.config.in_channels)
        if latents is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        elif isinstance(latents, np.ndarray):
            latents = torch.from_numpy(latents)
        latents = latents.to(device=device, dtype=torch.float32)
        dtype = self.unet.dtype
        added = {"text_embeds": add_text_embeds.to(dtype), "time_ids": add_time_ids}
        return context.to(dtype), added, latents

    @torch.inference_mode()
    def __call__(self, prompt=None, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 50, guidance_scale: float = 5.0,
                 negative_prompt=None, seed: int = 0, latents=None, output_type: str = "pil",
                 original_size: Optional[Tuple[int, int]] = None,
                 target_size: Optional[Tuple[int, int]] = None,
                 crops_coords_top_left: Tuple[int, int] = (0, 0), return_dict: bool = False):
        """latents: optional (B, H/8, W/8, C) NHWC noise, numpy or tensor; when
        None it is drawn from a torch.Generator seeded with `seed`."""
        do_cfg = guidance_scale > 1.0
        context, added, latents = self.prepare_inputs(
            prompt, height, width, guidance_scale, negative_prompt, seed, latents,
            original_size, target_size, crops_coords_top_left)
        state = make_scheduler_state(self.scheduler, num_inference_steps,
                                     sample_shape=tuple(latents.shape))
        latents = latents * self.scheduler.init_noise_sigma

        unet, dtype = self.unet, self.unet.dtype
        for i in range(num_inference_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            lat_in = self.scheduler.scale_model_input(state, lat_in, i)
            t_in = state.timesteps[i].to(latents.device).expand(lat_in.shape[0])
            noise_pred = unet(lat_in.to(dtype), t_in, context, added_cond_kwargs=added).float()
            if do_cfg:
                un, co = noise_pred.chunk(2)
                noise_pred = un + guidance_scale * (co - un)
            latents, state = self.scheduler.step(state, noise_pred, i, latents)
        if output_type == "latent":
            return (latents,)
        image = self._decode_latents(latents)
        return (self.image_processor.postprocess(image, output_type),)
