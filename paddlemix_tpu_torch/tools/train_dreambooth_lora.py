"""DreamBooth-LoRA fine-tuning (port of examples/train_dreambooth_lora.py):
subject images -> VAE latents -> LoRA-only UNet training through the
Trainer.

Usage: python -m paddlemix_tpu_torch.tools.train_dreambooth_lora CKPT IMAGE_DIR "a sks dog"

CKPT is a diffusers-layout pipeline directory. The images and the prompt
are encoded once as `train_dreambooth.encode_dir` does (no `is_prior`).
LoRA r 8, alpha 16 goes on the UNet's attention projections (to_q, to_k,
to_v, to_out: the JAX `lora_init` targets, matched on the JAX names; SD1.5
has 16 transformer blocks of 2 attentions, 128 pairs), the base frozen;
the SD denoising loss (`make_sd_loss_fn`: epsilon, no SNR weighting) trains
the factors at lr 1e-4, max_steps 500, shuffled batches of 1 over the
samples repeated 50 times, no checkpoints; then `save_lora` writes the
adapter in the JAX package's keys to `output/dreambooth/lora`, which JAX's
`load_lora` reads. On the card the UNet keeps fp32 masters and computes in
bf16; on the CPU everything is fp32.
"""

from __future__ import annotations

import os
import sys

import torch

from ..datasets import DataLoader, MapDataset
from ..diffusers.training_utils import make_sd_loss_fn
from ..peft import LoraConfig, lora_init, lora_loss_fn, save_lora
from ..trainer import Trainer, TrainingArguments
from .train_dreambooth import IMAGE_SIZE, REPEATS, encode_dir, load_frozen
from .train_text_to_image import training_unet

LORA = dict(r=8, lora_alpha=16)


def main(argv=None, device="cuda", resolution: int = IMAGE_SIZE, **overrides):
    """The example on `device` (the card by default), the images resized to
    `resolution` square (the example's 512); `overrides` replace
    TrainingArguments fields (e.g. max_steps, output_dir). Returns (trainer,
    train's result, the adapter directory)."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt, image_dir, prompt = argv[0], argv[1], argv[2]
    unet = training_unet(ckpt, device)
    vae, text_encoder, tokenizer, scheduler = load_frozen(ckpt, device)
    samples = encode_dir(image_dir, prompt, vae, text_encoder, tokenizer, resolution=resolution)
    del vae, text_encoder

    lcfg = LoraConfig(**LORA)
    lora = lora_init(unet, lcfg, torch.Generator(device=device).manual_seed(0),
                     key_map=unet.flax_key_map)
    loss = lora_loss_fn(make_sd_loss_fn(unet, scheduler), unet)
    args = TrainingArguments(**dict(dict(output_dir="output/dreambooth", learning_rate=1e-4,
                                         max_steps=500, logging_steps=10, save_steps=0),
                                    **overrides))
    trainer = Trainer(params=lora, args=args, loss_fn=loss,
                      train_dataloader=DataLoader(MapDataset(samples * REPEATS), batch_size=1,
                                                  shuffle=True))
    result = trainer.train()
    out = os.path.join(args.output_dir, "lora")
    save_lora(trainer.state.params, lcfg, out, key_map=unet.flax_key_map)
    return trainer, result, out


if __name__ == "__main__":
    main()
