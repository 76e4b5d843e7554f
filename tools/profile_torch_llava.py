#!/usr/bin/env python3
"""Where the device time of one LLaVA-1.5-7B request goes, in the PyTorch port.

Builds the full-width LLaVA-1.5-7B of paddlemix_tpu_torch with seeded random
weights on one CUDA card, then in bf16 and after weight-only int8
quantization: one warm request, one request under torch.profiler (CUDA
activity), one unprofiled request. A request is the JAX bench's: 576 image
placeholders + 32 text ids, one 336 px image, 128 new tokens, no eos. Prints
the card's nvidia-smi name and power limit, device kernel time by category
(the slice's three kernels by name, cuBLAS GEMMs, softmax, the rest), the top
kernels, the launches per token, and the busy share = device kernel time of
the profiled request / wall time of the unprofiled one.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/profile_torch_llava.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NEW_TOKENS = 128


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "wint8_gem" in n:
        return "B6 wint8 GEMM"
    if "decode_attention" in n:
        return "B7 decode attention"
    if "rms_norm" in n:
        return "B11 RMSNorm (Triton)"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90", "gemv", "conv",
                            "cudnn", "implicit")):
        return "cuBLAS GEMMs / GEMVs"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "LayerNorm"
    return "elementwise / copies / reductions"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.models.llava import bench_input_ids, random_llava

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_llava: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    model = random_llava(dev, torch.bfloat16, seed=0)
    ids = bench_input_ids(model.config, device=dev)
    isz = model.config.vision.image_size
    px = torch.randn((1, isz, isz, 3), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))

    def request(n=NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, px, max_new_tokens=n, eos_token_id=-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for label in ("bf16", "wint8"):
        if label == "wint8":
            model.quantize_("wint8")
        print(f"[{label}] warm request {request():.3f} s, TTFT {1e3 * request(1):.1f} ms")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = request()
        unprofiled = request()
        total, launches, cats, top = 0.0, 0, {}, []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            us = e.self_device_time_total
            total += us
            launches += e.count
            cats[category(e.key)] = cats.get(category(e.key), 0.0) + us
            top.append((us, e.count, e.key[:110]))
        print(f"[{label}] profiled request {profiled:.3f} s, unprofiled {unprofiled:.3f} s, "
              f"device kernel time {total / 1e6:.3f} s, busy share {total / 1e6 / unprofiled:.3f}"
              f", {launches} kernels ({launches / NEW_TOKENS:.0f} a token)")
        for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
            print(f"[{label}]   {name:34s} {us / 1e3:9.1f} ms {100 * us / total:5.1f}%")
        for us, count, key in sorted(top, reverse=True)[:15]:
            print(f"[{label}]     {us / 1e3:9.1f} ms x{count:6d} {key}")


if __name__ == "__main__":
    main()
