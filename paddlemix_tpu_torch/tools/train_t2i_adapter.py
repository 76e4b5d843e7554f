"""T2I-Adapter training (port of examples/train_t2i_adapter.py): the adapter
trunk alone learns to map a control image to the features a frozen SD UNet
adds after its down blocks.

The recipe: synthetic (image, control) pairs (`synthetic_pair`: a coloured
square and its edge map, from np.random.default_rng(seed) as the example
draws them), each step the images encoded by the VAE (`encode(images * 2 -
1).sample(generator)` times its scaling factor), timesteps uniform in [0,
1000) and normal noise, the latents noised by the pipeline's scheduler, the
adapter on the controls in [-1, 1] (ROADMAP C.32: the pipeline feeds it [0,
1]), the UNet's epsilon prediction under the features as intrablock
residuals, the MSE in fp32, and AdamW (b1 0.9, b2 0.999, eps 1e-8, weight
decay 1e-2 on every parameter, a constant lr, no clipping: optax.adamw).
The draws of a step come from one torch.Generator seeded with `--seed`, in
the order z, t, noise.

Usage: python -m paddlemix_tpu_torch.tools.train_t2i_adapter --pretrained DIR
    [--steps 100] [--batch 2] [--lr 1e-4] [--resolution 64] [--output DIR]

`--pretrained` is a pipeline directory (any SD pipeline's: its vae, unet,
text_encoder, tokenizer and scheduler are used); the adapter is built at the
UNet's block_out_channels with downscale 8 and saved to `--output` at the
end. Its weights are drawn from the seed (the JAX example's come from flax's
init at the same seed, which the port does not reproduce). The example's run
without `--pretrained` builds tiny models from the JAX package's tests and is
not ported. On the card the frozen models compute in bf16 (`freeze`: the
VAE cast to it, the UNet and the text tower over their fp32 parameters)
and the adapter keeps fp32 masters; on the CPU everything is fp32.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.init import build_random
from ..diffusers import DiffusionPipeline, T2IAdapter, T2IAdapterConfig
from ..models.layers import set_compute_dtype
from ..optimization import Optimizer
from .train_text_to_image import compute_dtype


def synthetic_pair(rng: np.random.Generator, n: int, res: int):
    """Target images (n, res, res, 3): a random coloured square each; controls:
    its edge map (the example's, draw for draw)."""
    img = np.zeros((n, res, res, 3), np.float32)
    ctl = np.zeros((n, res, res, 3), np.float32)
    for i in range(n):
        x0, y0 = rng.integers(4, res // 2, 2)
        w = int(rng.integers(res // 4, res // 2))
        c = rng.uniform(0.3, 1.0, 3)
        img[i, y0:y0 + w, x0:x0 + w] = c
        ctl[i, y0:y0 + w, [x0, min(x0 + w, res - 1)]] = 1.0
        ctl[i, [y0, min(y0 + w, res - 1)], x0:x0 + w] = 1.0
    return img, ctl


def adapter_loss(pipe, adapter, images, controls, context, z_noise, timesteps, noise):
    """The example's loss at given draws: `z_noise` (the posterior's sample
    noise, the latents' shape), `timesteps` (B,) and `noise` (fp32, the
    latents' shape). images, controls: (B, H, W, 3) in [0, 1]; context: (1,
    S, D), broadcast to the batch."""
    vae, unet = pipe.vae, pipe.unet
    post = vae.encode(images * 2 - 1)
    std = torch.exp(0.5 * post.logvar.clamp(-30.0, 20.0))
    latents = (post.mean + std * z_noise.to(post.mean.dtype)).float() * vae.config.scaling_factor
    noisy = pipe.scheduler.add_noise(latents, noise, timesteps)
    feats = adapter((controls * 2 - 1).to(adapter.dtype))
    ctx = context.expand(latents.shape[0], *context.shape[1:])
    pred = unet(noisy.to(unet.dtype), timesteps.float(), ctx.to(unet.dtype),
                down_intrablock_additional_residuals=[f.float() for f in feats])
    return ((pred.float() - noise) ** 2).mean()


def freeze(pipe, dtype: torch.dtype):
    """The pipeline's VAE, UNet and text tower frozen for the adapter's
    training, computing in `dtype`: the VAE cast to it (its attention's
    Linears take no compute dtype), the UNet and the text tower computing in
    it over their parameters. Returns `pipe`."""
    pipe.vae.to(dtype)
    for model in (pipe.unet, pipe.text_encoder):
        set_compute_dtype(model, dtype)
    for model in (pipe.vae, pipe.unet, pipe.text_encoder):
        model.requires_grad_(False)
    return pipe


def adapter_for(unet, seed: int, device, downscale_factor: int = 8) -> T2IAdapter:
    """The example's adapter at `unet`'s block_out_channels (3-channel
    controls, 2 res blocks), fp32 weights drawn from `seed` on `device`."""
    cfg = T2IAdapterConfig(channels=tuple(unet.config.block_out_channels),
                           downscale_factor=downscale_factor)
    gen = torch.Generator(device=device).manual_seed(seed)
    adapter = build_random(lambda: T2IAdapter(cfg), device=device, dtype=torch.float32,
                           generator=gen)
    return adapter.to(memory_format=torch.channels_last)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrained", type=str, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--output", type=str, default="t2i_adapter_out")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, device="cuda"):
    """The example on `device` (the card by default). Returns (the adapter,
    the losses as fp32 device scalars, the host time each step returned)."""
    args = parse_args(argv)
    if not args.pretrained:
        raise NotImplementedError("train_t2i_adapter: the example's tiny pipeline without "
                                  "--pretrained comes from the JAX package's tests and is not "
                                  "ported; pass --pretrained DIR")
    pipe = DiffusionPipeline.from_pretrained(args.pretrained, device=device)
    dtype = compute_dtype(device)
    freeze(pipe, dtype)
    adapter = set_compute_dtype(adapter_for(pipe.unet, args.seed, device), dtype)
    params = dict(adapter.named_parameters())
    tx = Optimizer(lambda count: args.lr, weight_decay=1e-2, max_grad_norm=None)
    state = tx.init(params)

    ids = torch.as_tensor(pipe.tokenizer(["a square"])["input_ids"], dtype=torch.long,
                          device=device)
    with torch.no_grad():
        context = pipe.text_encoder(ids)[0]
    num_train = 1000  # the example's: its scheduler object has no num_train_timesteps
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    f = pipe.vae_scale_factor
    lat_shape = (args.batch, args.resolution // f, args.resolution // f,
                 pipe.vae.config.latent_channels)
    losses, times = [], []
    t0 = time.time()
    for it in range(args.steps):
        img, ctl = synthetic_pair(rng, args.batch, args.resolution)
        images = torch.from_numpy(img).to(device)
        controls = torch.from_numpy(ctl).to(device)
        z_noise = torch.randn(lat_shape, generator=gen, device=device)
        t = torch.randint(0, num_train, (args.batch,), generator=gen, device=device)
        noise = torch.randn(lat_shape, generator=gen, device=device)
        loss = adapter_loss(pipe, adapter, images, controls, context, z_noise, t, noise)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.update(dict(zip(params, grads)), state, params)
        losses.append(loss.detach())
        times.append(time.perf_counter())
        if it % 20 == 0 or it == args.steps - 1:
            print(f"step {it}: loss={float(loss):.4f} ({time.time() - t0:.1f}s)", flush=True)
    adapter.save_pretrained(args.output)
    print(f"saved adapter -> {args.output}")
    return adapter, losses, times


if __name__ == "__main__":
    main()
