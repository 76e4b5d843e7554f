#!/usr/bin/env python3
"""Where the device time of one SDXL-1024 request goes, in the PyTorch port.

Builds the full-width SDXL pipeline of paddlemix_tpu_torch with seeded random
weights on one CUDA card (quant="a8w8_static": bf16 until scales are
loaded), then for bf16 and for static a8w8 (after calibration): two warm
requests, one request under torch.profiler (CUDA activity), one unprofiled
request. Prints the card's nvidia-smi name and power limit, device kernel
time by category (the port's five kernels by name, cuBLAS/cuDNN, LayerNorm,
softmax, the rest), the top kernels, and the busy share = device kernel time
of the profiled request / wall time of the unprofiled one; then, for a8w8,
the int8 GEMM's (B2) device ms in one more profiled request by its (M, K, N):
the kernels, in the order they ran, paired with the calls' shapes in the
order they were made.

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


def b2_by_shape(torch, run):
    """{(M, K, N): (device ms, calls)} of the int8 GEMM in `run()`: its
    kernels under the profiler, in the order they ran, paired with the calls'
    shapes in the order they were made (one stream: the same order)."""
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.ops import quant

    shapes = []
    kernel = quant.int8_a8w8_matmul

    def recorded(x, wq, sw, sx, bias=None):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1], wq.shape[0]))
        return kernel(x, wq, sw, sx, bias)

    quant.int8_a8w8_matmul = recorded
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        quant.int8_a8w8_matmul = kernel
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and "int8_gemm" in e.name),
                     key=lambda e: e.time_range.start)
    if len(kernels) != len(shapes):
        raise SystemExit(f"profile_torch_sdxl: {len(kernels)} B2 kernels for {len(shapes)} calls")
    by_shape = {}
    for shape, e in zip(shapes, kernels):
        ms, n = by_shape.get(shape, (0.0, 0))
        by_shape[shape] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_shape


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
        if label == "a8w8":
            by_shape = b2_by_shape(torch, lambda: request(5))
            total_ms = sum(ms for ms, _ in by_shape.values())
            print(f"[a8w8] B2 by (M, K, N), one request: {total_ms:.1f} ms in "
                  f"{sum(n for _, n in by_shape.values())} calls")
            for shape, (ms, n) in sorted(by_shape.items(), key=lambda kv: -kv[1][0]):
                print(f"[a8w8]   {str(shape):22s} {ms:8.1f} ms x{n:5d} ({ms / n:.4f} ms a call)")


if __name__ == "__main__":
    main()
