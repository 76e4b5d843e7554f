"""SD1.5 / 2.x and SDXL text-to-image pipelines (port of
StableDiffusionPipeline and StableDiffusionXLPipeline in
paddlemix_tpu/diffusers/pipelines/stable_diffusion.py).

Same signatures and semantics as the JAX pipelines: [uncond, cond]
classifier-free guidance on the batch axis, fp32 latents with the UNet run in
its own dtype and its noise prediction taken in fp32; SD1.5 conditions on one
CLIP text tower's final-LayerNorm output (or, with `clip_skip`, an earlier
hidden state), SDXL on two towers' penultimate hidden states, the pooled
embeds of the second and add_time_ids. The JAX package compiles the denoise
loop into one lax.fori_loop; here it is a Python loop over steps. Both are
registered, so `DiffusionPipeline.from_pretrained` of a directory whose
model_index.json names either builds it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..image_processor import VaeImageProcessor
from .pipeline_utils import DiffusionPipeline, make_scheduler_state, register_pipeline


def _noise(shape, latents, seed: int, device) -> torch.Tensor:
    """The initial fp32 noise: `latents` (numpy or tensor) if given, else
    drawn from a torch.Generator seeded with `seed`."""
    if latents is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    elif isinstance(latents, np.ndarray):
        latents = torch.from_numpy(latents)
    return latents.to(device=device, dtype=torch.float32)


class _UNetPipeline(DiffusionPipeline):
    """What the UNet pipelines share: the CFG denoise loop and the decode."""

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _denoise(self, latents, context, num_inference_steps: int, guidance_scale: float,
                 added=None, residuals=None):
        """The scheduler loop from the initial noise (before init_noise_sigma):
        each step one UNet call on the CFG-doubled latents, the prediction in
        fp32, uncond + g * (cond - uncond), then the scheduler's step.
        `residuals(lat_in, t_in)` gives the UNet's residual keywords of the
        step (the ControlNet's or the T2I-Adapter's)."""
        do_cfg = guidance_scale > 1.0
        state = make_scheduler_state(self.scheduler, num_inference_steps,
                                     sample_shape=tuple(latents.shape))
        latents = latents * self.scheduler.init_noise_sigma
        unet, dtype = self.unet, self.unet.dtype
        for i in range(num_inference_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            lat_in = self.scheduler.scale_model_input(state, lat_in, i)
            t_in = state.timesteps[i].to(latents.device).expand(lat_in.shape[0])
            extra = residuals(lat_in, t_in) if residuals is not None else {}
            noise_pred = unet(lat_in.to(dtype), t_in, context, added_cond_kwargs=added,
                              **extra).float()
            if do_cfg:
                un, co = noise_pred.chunk(2)
                noise_pred = un + guidance_scale * (co - un)
            latents, state = self.scheduler.step(state, noise_pred, i, latents)
        return latents

    def _decode_latents(self, latents):
        cfg = self.vae.config
        latents = latents / cfg.scaling_factor
        if cfg.shift_factor:
            latents = latents + cfg.shift_factor
        return self.vae.decode(latents).float()

    def _output(self, latents, output_type: str):
        if output_type == "latent":
            return (latents,)
        image = self._decode_latents(latents)
        return (self.image_processor.postprocess(image, output_type),)


@register_pipeline
class StableDiffusionPipeline(_UNetPipeline):
    """SD1.5 / 2.x: one CLIP text tower, no micro-conditioning."""

    def __init__(self, vae, text_encoder, tokenizer, unet, scheduler):
        self.register_modules(vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
                              unet=unet, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor()

    def encode_prompt(self, prompt, negative_prompt=None, clip_skip: Optional[int] = None):
        """(cond, uncond): the tower's final-LayerNorm output, or with
        `clip_skip` its hidden state `clip_skip` layers before the last."""
        if isinstance(prompt, str):
            prompt = [prompt]
        negative_prompt = negative_prompt or [""] * len(prompt)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)

        def encode(texts):
            ids = torch.as_tensor(self.tokenizer(texts)["input_ids"], dtype=torch.long,
                                  device=self.device)
            if clip_skip:
                return self.text_encoder(ids, output_hidden_states=True)[2][-(clip_skip + 1)]
            return self.text_encoder(ids)[0]

        return encode(prompt), encode(negative_prompt)

    @classmethod
    def from_single_file(cls, path: str, **kwargs):
        raise NotImplementedError("from_single_file is not ported: the port reads a "
                                  "diffusers directory (DiffusionPipeline.from_pretrained)")

    def load_ip_adapter(self, path: str, scale: float = 1.0):
        raise NotImplementedError("IP-Adapter is not ported")

    @torch.inference_mode()
    def __call__(self, prompt=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 negative_prompt=None, num_images_per_prompt: int = 1, seed: int = 0,
                 latents=None, output_type: str = "pil", clip_skip: Optional[int] = None,
                 return_dict: bool = False, ip_adapter_image_embeds=None):
        """latents: optional (B, H/8, W/8, C) NHWC noise, numpy or tensor; when
        None it is drawn from a torch.Generator seeded with `seed`."""
        if ip_adapter_image_embeds is not None:
            raise NotImplementedError("IP-Adapter is not ported")
        cond, uncond = self.encode_prompt(prompt, negative_prompt, clip_skip)
        if num_images_per_prompt > 1:
            cond = cond.repeat_interleave(num_images_per_prompt, dim=0)
            uncond = uncond.repeat_interleave(num_images_per_prompt, dim=0)
        context = torch.cat([uncond, cond]) if guidance_scale > 1.0 else cond
        f = self.vae_scale_factor
        shape = (cond.shape[0], height // f, width // f, self.unet.config.in_channels)
        latents = _noise(shape, latents, seed, self.device)
        latents = self._denoise(latents, context.to(self.unet.dtype), num_inference_steps,
                                guidance_scale)
        return self._output(latents, output_type)


@register_pipeline
class StableDiffusionXLPipeline(_UNetPipeline):
    def __init__(self, vae, text_encoder, text_encoder_2, tokenizer, tokenizer_2, unet,
                 scheduler):
        self.register_modules(vae=vae, text_encoder=text_encoder,
                              text_encoder_2=text_encoder_2, tokenizer=tokenizer,
                              tokenizer_2=tokenizer_2, unet=unet, scheduler=scheduler)
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.image_processor = VaeImageProcessor()

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
        latents = _noise(shape, latents, seed, device)
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
        context, added, latents = self.prepare_inputs(
            prompt, height, width, guidance_scale, negative_prompt, seed, latents,
            original_size, target_size, crops_coords_top_left)
        latents = self._denoise(latents, context, num_inference_steps, guidance_scale, added)
        return self._output(latents, output_type)
