#!/usr/bin/env python3
"""Where the device time of one SD3-medium request goes, in the PyTorch port.

Builds the full-width SD3-medium pipeline of paddlemix_tpu_torch (MM-DiT,
CLIP-L + bigG, T5 v1.1-XXL encoder, 16-channel VAE) with seeded random bf16
weights on one CUDA card, then runs one warm-up request, one request under
torch.profiler (CUDA activity) and one unprofiled request, each 1024x1024, 28
FlowMatch steps, guidance 7.0 (CFG batch 2). Prints the card's nvidia-smi
name and power limit, device kernel time by category (the slice's kernels by
name, cuBLAS GEMMs, cuDNN convs, softmax, the rest), the top kernels, the
kernels launched a request and a denoising step (one transformer forward,
profiled apart), and the busy share = device kernel time of the profiled
request / wall time of the unprofiled one.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/profile_torch_sd3.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 28
GUIDANCE = 7.0
PROMPT = "a photograph of an astronaut riding a horse on the moon"


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "flash_fwd" in n:
        return "B1 flash attention (joint)"
    if "fused_adaln_residual" in n:
        return "B13 fused adaLN + residual"
    if "adaln_" in n:  # adaln_warp_kernel / adaln_row_kernel; an older tree: Triton adaln_fwd
        return "B12 adaLN"
    if "rms_norm" in n:  # rms_norm_fwd_kernel (CUDA); an older tree's Triton rms_norm_fwd
        return "B11 RMSNorm (T5)"
    if n.startswith("gn_"):
        return "B4 GroupNorm (VAE)"
    if any(s in n for s in ("conv", "cudnn", "implicit", "winograd")):
        return "cuDNN convs (VAE, patch embed)"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90", "gemv")):
        return "cuBLAS GEMMs"
    if "softmax" in n:
        return "softmax (math attention)"
    if "layer_norm" in n or "layernorm" in n:
        return "LayerNorm (CLIP)"
    return "elementwise / copies / reductions"


def device_kernels(prof, torch):
    """[(device us, launches, name)] of the CUDA kernels a profile saw."""
    return [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers.sd3 import random_sd3_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sd3: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    pipe = random_sd3_pipeline(dev, bf16, seed=0)

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(PROMPT, num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=0,
             output_type="np")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"[sd3] warm-up request (Triton compiles, library set-up) {request():.3f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = request()
    unprofiled = request()
    kernels = device_kernels(prof, torch)
    total = sum(us for us, _, _ in kernels)
    launches = sum(n for _, n, _ in kernels)
    cats = {}
    for us, _, key in kernels:
        cats[category(key)] = cats.get(category(key), 0.0) + us
    print(f"[sd3] profiled request {profiled:.3f} s, unprofiled {unprofiled:.3f} s, device "
          f"kernel time {total / 1e6:.3f} s, busy share {total / 1e6 / unprofiled:.3f}, "
          f"{launches} kernels a request")
    for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[sd3]   {name:34s} {us / 1e3:9.1f} ms {100 * us / total:5.1f}%")
    for us, count, key in sorted(kernels, reverse=True)[:15]:
        print(f"[sd3]     {us / 1e3:9.1f} ms x{count:6d} {key[:110]}")

    # one denoising step: the transformer at CFG batch 2 over 4096 + 154 tokens
    gen = torch.Generator(device=dev).manual_seed(1)
    lat = torch.randn((2, 128, 128, 16), generator=gen, device=dev, dtype=bf16)
    t = torch.full((2,), 500.0, device=dev)
    ctx = torch.randn((2, 154, 4096), generator=gen, device=dev, dtype=bf16)
    pooled = torch.randn((2, 2048), generator=gen, device=dev, dtype=bf16)
    with torch.inference_mode():
        pipe.transformer(lat, t, ctx, pooled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.transformer(lat, t, ctx, pooled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.transformer(lat, t, ctx, pooled)
            torch.cuda.synchronize()
    kernels = device_kernels(prof, torch)
    step_us = sum(us for us, _, _ in kernels)
    print(f"[sd3 step] one transformer forward: {wall * 1e3:.1f} ms wall unprofiled, device "
          f"kernel time {step_us / 1e3:.1f} ms, {sum(n for _, n, _ in kernels)} kernels")
    cats = {}
    for us, _, key in kernels:
        cats[category(key)] = cats.get(category(key), 0.0) + us
    for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[sd3 step]   {name:34s} {us / 1e3:9.2f} ms {100 * us / step_us:5.1f}%")


if __name__ == "__main__":
    main()
