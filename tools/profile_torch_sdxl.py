#!/usr/bin/env python3
"""Where the device time of one SDXL-1024 request goes, in the PyTorch port.

Builds the full-width SDXL pipeline of paddlemix_tpu_torch with seeded random
weights on one CUDA card (quant="a8w8_static": bf16 until scales are
loaded), then for bf16 and for static a8w8 (after calibration): two warm
requests, one request under torch.profiler (CUDA activity), one unprofiled
request. Prints the card's nvidia-smi name and power limit, device kernel
time by category (the port's five kernels by name, cuBLAS/cuDNN, LayerNorm,
softmax, the rest), the top kernels, and the busy share = device kernel time
of the profiled request / wall time of the unprofiled one.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/profile_torch_sdxl.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPT = "a photograph of an astronaut riding a horse on the moon"
CALL = dict(height=1024, width=1024, num_inference_steps=25, guidance_scale=5.0,
            output_type="np")


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "int8_gemm" in n:
        return "B2 int8 GEMM"
    if "conv3x3_kernel<true>" in n or "conv3x3_kernelilb1" in n:
        return "B5 fused GN+SiLU+int8 conv"
    if "conv3x3_kernel" in n:
        return "B3 int8 conv"
    if "flash" in n:
        return "B1 flash forward"
    if "gn_" in n:
        return "B4 GroupNorm (Triton)"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90", "conv", "cudnn",
                            "implicit")):
        return "cuBLAS GEMMs + cuDNN convs"
    if "layer_norm" in n or "layernorm" in n:
        return "LayerNorm"
    if "softmax" in n:
        return "softmax"
    return "elementwise / copies / reductions"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers.sdxl import calibrate_static_a8w8, random_sdxl_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sdxl: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pipe = random_sdxl_pipeline(torch.device("cuda"), torch.bfloat16, seed=0,
                                quant="a8w8_static")

    def request(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(PROMPT, seed=seed, **CALL)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label in ("bf16", "a8w8"):
        if label == "a8w8":
            calibrate_static_a8w8(pipe, PROMPT, 1024, 1024, 25, 5.0)
        print(f"[{label}] warm requests {request(1):.3f} s, {request(2):.3f} s")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = request(3)
        unprofiled = request(4)
        total, cats, top = 0.0, {}, []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            us = e.self_device_time_total
            total += us
            cats[category(e.key)] = cats.get(category(e.key), 0.0) + us
            top.append((us, e.count, e.key[:110]))
        print(f"[{label}] profiled request {profiled:.3f} s, unprofiled {unprofiled:.3f} s, "
              f"device kernel time {total / 1e6:.3f} s, busy share "
              f"{total / 1e6 / unprofiled:.3f}")
        for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
            print(f"[{label}]   {name:34s} {us / 1e3:9.1f} ms {100 * us / total:5.1f}%")
        for us, count, key in sorted(top, reverse=True)[:18]:
            print(f"[{label}]     {us / 1e3:9.1f} ms x{count:6d} {key}")


if __name__ == "__main__":
    main()
