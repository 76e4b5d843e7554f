"""DreamBooth full-UNet fine-tuning with prior preservation (port of
examples/train_dreambooth.py).

Usage: python -m paddlemix_tpu_torch.tools.train_dreambooth CKPT INSTANCE_DIR \
    "a sks dog" [CLASS_DIR "a dog" [PRIOR_LOSS_WEIGHT]]

CKPT is a diffusers-layout pipeline directory (`unet/`, `vae/`,
`text_encoder/`, `tokenizer/`, `scheduler/`). Every image of INSTANCE_DIR
(and of CLASS_DIR, whose samples are marked `is_prior`) is read by PIL,
resized to 512 x 512 and encoded once by the frozen VAE
(`encode(...).mode() * scaling_factor`), beside its prompt embedded once by
the frozen text tower, both under `torch.inference_mode`. Then the whole
UNet trains on the samples repeated 50 times through the Trainer: AdamW at
lr 5e-6, max_steps 800, shuffled batches of 2, no checkpoints, the loss
`make_dreambooth_loss_fn` (the epsilon MSE per example, class examples
weighted by the prior weight, 1.0 by default); at the end
`unet.save_pretrained` writes `output/dreambooth_full/unet`. Without
CLASS_DIR it is plain subject fine-tuning. On the card the UNet keeps fp32
masters and computes in bf16, and the VAE and the text tower run in bf16;
on the CPU everything is fp32. The images are read in sorted order (the
example takes glob's order).
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from ..datasets import DataLoader, MapDataset
from ..diffusers import AutoencoderKL, DDPMScheduler
from ..models.clip import CLIPTextModel, CLIPTokenizer
from ..processors.image_utils import resize, to_numpy_rgb
from ..trainer import Trainer, TrainingArguments
from .train_text_to_image import compute_dtype, training_unet

IMAGE_SIZE = 512
REPEATS = 50  # the samples repeated, as MapDataset(samples * 50)


@torch.inference_mode()
def encode_dir(image_dir: str, prompt: str, vae, text_encoder, tokenizer, is_prior=None,
               resolution: int = IMAGE_SIZE):
    """One sample a file of `image_dir` (sorted): "latents" (the VAE
    posterior's mode of the image resized to `resolution` (512) square and
    scaled to [-1, 1], times the VAE's scaling_factor; (h, w, latent) fp32
    numpy) and "encoder_hidden_states" (the prompt's embedding, (77, D)
    fp32), with "is_prior" where given."""
    from PIL import Image

    dev = text_encoder.text_model.final_layer_norm.weight.device
    ids = torch.as_tensor(tokenizer([prompt])["input_ids"], device=dev)
    embeds = text_encoder(ids)[0][0].float().cpu().numpy()
    samples = []
    for p in sorted(glob.glob(os.path.join(image_dir, "*"))):
        img = resize(to_numpy_rgb(Image.open(p)), (resolution, resolution)).astype(np.float32)
        x = torch.from_numpy(img[None] / 127.5 - 1.0).to(dev)
        lat = vae.encode(x).mode()[0].float().cpu().numpy()
        sample = {"latents": lat * vae.config.scaling_factor, "encoder_hidden_states": embeds}
        if is_prior is not None:
            sample["is_prior"] = np.float32(is_prior)
        samples.append(sample)
    if not samples:
        raise FileNotFoundError(f"no images under {image_dir}")
    return samples


def load_frozen(ckpt: str, device):
    """The VAE, the text tower, the tokenizer and the DDPM scheduler of a
    pipeline directory (the models in `compute_dtype(device)`)."""
    dtype = compute_dtype(device)
    return (AutoencoderKL.from_pretrained(ckpt, subfolder="vae", device=device, dtype=dtype),
            CLIPTextModel.from_pretrained(ckpt, subfolder="text_encoder", device=device,
                                          dtype=dtype),
            CLIPTokenizer.from_pretrained(ckpt, subfolder="tokenizer"),
            DDPMScheduler.from_pretrained(ckpt, subfolder="scheduler"))


def dreambooth_loss(unet, scheduler, batch, timesteps, noise, prior_loss_weight: float):
    """The loss at given `timesteps` (B,) and `noise` (the latents' shape,
    fp32): the latents noised by `scheduler.add_noise`, the UNet's epsilon
    prediction in fp32, the mean squared error per example, each class
    example (`is_prior` > 0) weighted by `prior_loss_weight`, then the mean
    (JAX's `make_dreambooth_loss_fn` body)."""
    latents = batch["latents"].float()
    noisy = scheduler.add_noise(latents, noise, timesteps)
    pred = unet(noisy.to(unet.dtype), timesteps,
                batch["encoder_hidden_states"].to(unet.dtype)).float()
    per_ex = ((pred - noise) ** 2).mean(dim=(1, 2, 3))
    w = torch.where(batch["is_prior"] > 0, prior_loss_weight, 1.0)
    return (per_ex * w).mean()


def make_dreambooth_loss_fn(unet, scheduler, prior_loss_weight: float):
    """loss_fn(params, batch, rng) for the Trainer: timesteps uniform in
    [0, num_train_timesteps) and normal noise drawn from `rng` (a
    torch.Generator on the batch's device), then `dreambooth_loss`."""
    num_train = scheduler.config.num_train_timesteps

    def loss_fn(params, batch, rng):
        latents = batch["latents"]
        t = torch.randint(0, num_train, (latents.shape[0],), generator=rng,
                          device=latents.device)
        noise = torch.randn(latents.shape, generator=rng, device=latents.device,
                            dtype=torch.float32)
        return dreambooth_loss(unet, scheduler, batch, t, noise, prior_loss_weight)

    return loss_fn


def main(argv=None, device="cuda", resolution: int = IMAGE_SIZE, **overrides):
    """The example on `device` (the card by default), the images resized to
    `resolution` square (the example's 512); `overrides` replace
    TrainingArguments fields (e.g. max_steps, output_dir). Returns (trainer,
    train's result, the saved unet directory)."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt, instance_dir, instance_prompt = argv[0], argv[1], argv[2]
    class_dir = argv[3] if len(argv) > 3 else None
    class_prompt = argv[4] if len(argv) > 4 else None
    prior_w = float(argv[5]) if len(argv) > 5 else 1.0

    unet = training_unet(ckpt, device)
    vae, text_encoder, tokenizer, scheduler = load_frozen(ckpt, device)
    samples = encode_dir(instance_dir, instance_prompt, vae, text_encoder, tokenizer,
                         is_prior=0.0, resolution=resolution)
    if class_dir:
        samples += encode_dir(class_dir, class_prompt or instance_prompt, vae, text_encoder,
                              tokenizer, is_prior=1.0, resolution=resolution)
    del vae, text_encoder

    args = TrainingArguments(**dict(dict(output_dir="output/dreambooth_full", learning_rate=5e-6,
                                         max_steps=800, logging_steps=10, save_steps=0),
                                    **overrides))
    loader = DataLoader(MapDataset(samples * REPEATS), batch_size=2, shuffle=True)
    trainer = Trainer(model=unet, args=args, loss_fn=make_dreambooth_loss_fn(unet, scheduler,
                                                                             prior_w),
                      train_dataloader=loader)
    result = trainer.train()
    out = os.path.join(args.output_dir, "unet")
    unet.save_pretrained(out)
    return trainer, result, out


if __name__ == "__main__":
    main()
