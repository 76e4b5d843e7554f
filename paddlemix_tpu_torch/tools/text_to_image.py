"""Text-to-image from a diffusers-layout pipeline directory (port of
examples/text_to_image.py).

Usage: python -m paddlemix_tpu_torch.tools.text_to_image CKPT "a prompt" [out.png]

CKPT holds model_index.json (`StableDiffusionPipeline` or
`StableDiffusionXLPipeline`) and its components' subfolders, as diffusers
or `DiffusionPipeline.save_pretrained` write them: `unet/`, `vae/`,
`text_encoder/` (and `text_encoder_2/`), `tokenizer/` (and `tokenizer_2/`),
`scheduler/`. The pipeline is read onto the card with its parameters in bf16
(fp32 on the CPU), then one request of 25 steps at the pipeline's default
size and guidance, and the first image is saved as a PNG.
"""

from __future__ import annotations

import sys

import torch

from ..diffusers import DiffusionPipeline

STEPS = 25


def main(argv=None, device="cuda", **call_kwargs):
    """Run the example on `device` (the card by default); `call_kwargs`
    (e.g. height, width, num_inference_steps, seed) are passed to the
    pipeline's call over the example's 25 steps. Returns the PNG's path."""
    argv = sys.argv[1:] if argv is None else argv
    path, prompt = argv[0], argv[1]
    out = argv[2] if len(argv) > 2 else "out.png"
    dtype = torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16
    pipe = DiffusionPipeline.from_pretrained(path, dtype=dtype, device=device)
    images = pipe(prompt, **dict(dict(num_inference_steps=STEPS), **call_kwargs))[0]
    images[0].save(out)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
