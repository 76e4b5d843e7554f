#!/usr/bin/env python3
"""Where the device time of one SD1.5-512 request goes, in the PyTorch port.

Builds the full-width SD1.5 pipeline of paddlemix_tpu_torch
(runwayml/stable-diffusion-v1-5: UNet 320-1280 with 8 heads a block, so
self-attention at head_dim 40, 80 and 160; CLIP-L; PNDM) with seeded random
weights on one CUDA card, then runs two warm requests (512 px, 50 steps,
guidance 7.5), one request under torch.profiler (CUDA activity) and one
unprofiled request. Prints the card's nvidia-smi name and power limit, the
device kernel time of the profiled request, the kernels it launched, the
busy share = that device time / the unprofiled request's wall time, the time
by category, B1 (the flash forward) by the head it served, and the top
kernels. B1's kernels are told apart by their instantiation's head width
(the template's first argument): 64 serves head 40, 96 or 128 head 80, 160
or 192 head 160, so a copy of this script also reads an older checkout,
whose heads 80 and 160 ran a WMMA core at 96 and 160 behind padding copies.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/profile_torch_sd15.py
"""

import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPT = "a photograph of an astronaut riding a horse on the moon"
CALL = dict(height=512, width=512, num_inference_steps=50, guidance_scale=7.5,
            output_type="np")
# SD1.5's heads by the width of the flash instantiation that serves them
HEAD_OF_WIDTH = {64: 40, 96: 80, 128: 80, 160: 160, 192: 160}


def category(name: str) -> str:
    n = name.lower()
    if "flash" in n:
        m = re.search(r"flash_fwd\w*kernel<(\d+)", n)
        head = HEAD_OF_WIDTH.get(int(m.group(1))) if m else None
        return f"B1 flash forward, head {head}" if head else "B1 flash forward"
    if "gn_" in n:
        return "B4 GroupNorm"
    if "layer_norm" in n or "layernorm" in n:
        return "B10 LayerNorm / LayerNorm"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90", "conv", "cudnn",
                            "implicit")):
        return "cuBLAS GEMMs + cuDNN convs"
    if "softmax" in n:
        return "softmax"
    return "elementwise / copies / reductions"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.diffusers.sd15 import random_sd15_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sd15: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pipe = random_sd15_pipeline(torch.device("cuda"), torch.bfloat16, seed=0)

    def request(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(PROMPT, seed=seed, **CALL)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"[sd15] warm requests {request(1):.3f} s, {request(2):.3f} s")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = request(3)
    unprofiled = request(4)
    total, launches, cats, top = 0.0, 0, {}, []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        us = e.self_device_time_total
        total += us
        launches += e.count
        cat = category(e.key)
        ms, n = cats.get(cat, (0.0, 0))
        cats[cat] = (ms + us / 1e3, n + e.count)
        top.append((us, e.count, e.key[:110]))
    print(f"[sd15] profiled request {profiled:.3f} s, unprofiled {unprofiled:.3f} s, device "
          f"kernel time {total / 1e3:.1f} ms in {launches} kernels, busy share "
          f"{total / 1e6 / unprofiled:.3f}")
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"[sd15]   {cat:36s} {ms:9.2f} ms {100 * ms * 1e3 / total:5.1f}% x{n:6d}")
    for us, count, key in sorted(top, reverse=True)[:15]:
        print(f"[sd15]     {us / 1e3:9.2f} ms x{count:6d} {key}")


if __name__ == "__main__":
    main()
