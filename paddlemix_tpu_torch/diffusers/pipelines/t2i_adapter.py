"""SD1.5 text-to-image under a T2I-Adapter (port of StableDiffusionAdapterPipeline
in paddlemix_tpu/diffusers/pipelines/t2i_adapter.py).

JAX's semantics: the condition image (NHWC; divided by 255 when its max is
over 1.5, so the adapter sees [0, 1] where JAX's trainer feeds it [-1, 1]:
ROADMAP C.32) goes through the adapter once, before the loop; its features,
cast to fp32 and times `adapter_conditioning_scale`, are doubled under
classifier-free guidance and added by the UNet after each down block
(`down_intrablock_additional_residuals`) at every step of
`_UNetPipeline._denoise`. The image is not broadcast to the prompt batch, as
in JAX. JAX's `register_modules(adapter=...)` replaces the pipeline's
components, so its `save_pretrained` writes the adapter alone; the port keeps
every component (C.33).
"""

from __future__ import annotations

import torch

from .controlnet import control_tensor
from .pipeline_utils import register_pipeline
from .stable_diffusion import StableDiffusionPipeline, _noise


@register_pipeline
class StableDiffusionAdapterPipeline(StableDiffusionPipeline):
    def __init__(self, vae, text_encoder, tokenizer, unet, adapter, scheduler):
        super().__init__(vae, text_encoder, tokenizer, unet, scheduler)
        self.adapter = adapter
        self._components["adapter"] = adapter

    @torch.inference_mode()
    def __call__(self, prompt=None, image=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 adapter_conditioning_scale: float = 1.0, negative_prompt=None, seed: int = 0,
                 output_type: str = "np", latents=None, return_dict: bool = False):
        """image: the condition image, (H, W, C) or (B, H, W, C); latents:
        optional (B, H/8, W/8, C) NHWC noise, numpy or tensor, else drawn
        from a torch.Generator seeded with `seed`."""
        do_cfg = guidance_scale > 1.0
        cond, uncond = self.encode_prompt(prompt, negative_prompt)
        context = torch.cat([uncond, cond]) if do_cfg else cond
        feats = [f.float() * adapter_conditioning_scale
                 for f in self.adapter(control_tensor(image, self.device))]
        if do_cfg:
            feats = [torch.cat([f, f]) for f in feats]
        f = self.vae_scale_factor
        shape = (cond.shape[0], height // f, width // f, self.unet.config.in_channels)
        latents = _noise(shape, latents, seed, self.device)
        latents = self._denoise(latents, context.to(self.unet.dtype), num_inference_steps,
                                guidance_scale, residuals=lambda lat_in, t_in: {
                                    "down_intrablock_additional_residuals": feats})
        return self._output(latents, output_type)
