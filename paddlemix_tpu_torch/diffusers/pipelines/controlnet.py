"""SD1.5 text-to-image under a ControlNet (port of StableDiffusionControlNetPipeline
in paddlemix_tpu/diffusers/pipelines/controlnet.py).

JAX's semantics: the control image (NHWC, numpy, PIL or tensor; divided by
255 when its max is over 1.5) is broadcast to the prompt batch and doubled
under classifier-free guidance; each step the ControlNet runs on the
CFG-doubled, scale-adjusted latents at the step's timestep, and the UNet adds
its residuals (times `controlnet_conditioning_scale`) to its skips and its mid
block. The loop is `_UNetPipeline._denoise`'s, with the ControlNet call as
its per-step residuals. A control image whose side is not the ControlNet's
factor (8 at SD1.5) times the latents' is refused with a ValueError, where
JAX fails inside its compiled loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline_utils import register_pipeline
from .stable_diffusion import StableDiffusionPipeline, _noise


def control_tensor(image, device) -> torch.Tensor:
    """The control image as the JAX pipelines read it: fp32, divided by 255
    when its max is over 1.5, with a batch axis."""
    if isinstance(image, torch.Tensor):
        image = image.to(device=device, dtype=torch.float32)
    else:
        image = torch.from_numpy(np.asarray(image, np.float32)).to(device)
    if image.max() > 1.5:
        image = image / 255.0
    return image[None] if image.ndim == 3 else image


@register_pipeline
class StableDiffusionControlNetPipeline(StableDiffusionPipeline):
    def __init__(self, vae, text_encoder, tokenizer, unet, controlnet, scheduler):
        super().__init__(vae, text_encoder, tokenizer, unet, scheduler)
        self.controlnet = controlnet
        self._components["controlnet"] = controlnet

    @torch.inference_mode()
    def __call__(self, prompt=None, image=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 controlnet_conditioning_scale: float = 1.0, negative_prompt=None, seed: int = 0,
                 latents=None, output_type: str = "pil", return_dict: bool = False):
        """image: the control image, (H, W, C) or (B, H, W, C) at the
        request's size; latents: optional (B, H/8, W/8, C) NHWC noise, numpy
        or tensor, else drawn from a torch.Generator seeded with `seed`."""
        do_cfg = guidance_scale > 1.0
        cond, uncond = self.encode_prompt(prompt, negative_prompt)
        batch = cond.shape[0]
        context = torch.cat([uncond, cond]) if do_cfg else cond
        f = self.vae_scale_factor
        shape = (batch, height // f, width // f, self.unet.config.in_channels)

        cn = self.controlnet
        control = control_tensor(image, self.device)
        side = cn.cond_scale_factor
        if tuple(control.shape[1:3]) != (shape[1] * side, shape[2] * side):
            raise ValueError(f"StableDiffusionControlNetPipeline: control image "
                             f"{tuple(control.shape[1:3])} for {shape[1]} x {shape[2]} latents; "
                             f"the ControlNet takes {side}x the latents' side, "
                             f"{shape[1] * side} x {shape[2] * side}")
        if control.shape[0] != batch:
            control = control.expand(batch, *control.shape[1:])
        control_in = (torch.cat([control, control]) if do_cfg else control).to(cn.dtype)
        context_cn = context.to(cn.dtype)
        scale = float(controlnet_conditioning_scale)

        def residuals(lat_in, t_in):
            down, mid = cn(lat_in.to(cn.dtype), t_in, context_cn, control_in, scale)
            return {"down_block_additional_residuals": down, "mid_block_additional_residual": mid}

        latents = _noise(shape, latents, seed, self.device)
        latents = self._denoise(latents, context.to(self.unet.dtype), num_inference_steps,
                                guidance_scale, residuals=residuals)
        return self._output(latents, output_type)
