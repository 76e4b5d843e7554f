#!/usr/bin/env python3
"""Where the device time of Llama-2-7B serving goes, in the PyTorch port, over
the int8 KV cache and over the paged KV cache.

Builds the full-width Llama-2-7B of paddlemix_tpu_torch (32 layers, 32 heads x
128, bf16 weights) with seeded random weights on one CUDA card, then for each
path: one warm request, one request under torch.profiler (CUDA activity), one
unprofiled request. The int8 path is one request of 3,968 prompt tokens and
128 new ones through greedy_generate with cachekv_int8; the paged path is the
batch of 8 right-padded prompts (2,000 down to 130 tokens), 128 new tokens
each, through paged_greedy_generate over a pool of exactly the blocks the
batch needs. No eos. Prints the card's nvidia-smi name and power limit,
device kernel time by category (the slice's kernels by name, the prefill's
attention, cuBLAS GEMMs, the rest), the top kernels, the launches per decode
step, and the busy share = device kernel time of the profiled request / wall
time of the unprofiled one. A profiled 1-token request splits the prefill
from the decode.

Usage (from the root of a checkout, on a machine with a CUDA card; naming a
path runs it alone):
    python3 tools/profile_torch_llama_kv.py [int8kv] [paged]
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "paged_decode" in n:
        return "B9 paged decode attention"
    if "decode_attention" in n:
        return "B8 int8-cache decode attention (+ merge)"
    if "rms_norm" in n:  # rms_norm_fwd_kernel (CUDA); an older tree's Triton rms_norm_fwd
        return "B11 RMSNorm"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90", "gemv")):
        return "cuBLAS GEMMs / GEMVs"
    if "softmax" in n:
        return "softmax"
    if any(s in n for s in ("index", "scatter", "gather")):
        return "cache writes and gathers"
    return "elementwise / copies / reductions"


def profile_request(torch, label, run, new_tokens):
    from torch.profiler import ProfilerActivity, profile

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    print(f"[{label}] warm request {timed(new_tokens):.3f} s, TTFT {1e3 * timed(1):.1f} ms",
          flush=True)
    for n in (1, new_tokens):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = timed(n)
        unprofiled = timed(n)
        total, launches, cats, top = 0.0, 0, {}, []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            us = e.self_device_time_total
            total += us
            launches += e.count
            cats[category(e.key)] = cats.get(category(e.key), 0.0) + us
            top.append((us, e.count, e.key[:110]))
        print(f"[{label}] {n}-token request: profiled {profiled:.3f} s, unprofiled "
              f"{unprofiled:.3f} s, device kernel time {total / 1e6:.3f} s, busy share "
              f"{total / 1e6 / unprofiled:.3f}, {launches} kernels", flush=True)
        for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
            print(f"[{label}]   {name:42s} {us / 1e3:9.1f} ms {100 * us / total:5.1f}%")
        for us, count, key in sorted(top, reverse=True)[:12]:
            print(f"[{label}]     {us / 1e3:9.1f} ms x{count:6d} {key}")
        if n == 1:
            prefill = (total, launches)
    print(f"[{label}] decode: {(total - prefill[0]) / 1e3 / (new_tokens - 1):.3f} ms of device "
          f"time and {(launches - prefill[1]) / (new_tokens - 1):.0f} kernels a step", flush=True)


def main():
    import torch

    from paddlemix_tpu_torch.models.llama import (
        blocks_needed,
        greedy_generate,
        int8kv_request,
        paged_batch,
        paged_greedy_generate,
        random_llama,
    )
    from paddlemix_tpu_torch.models.llama import llama7b

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_llama_kv: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    model = random_llama(dev, torch.bfloat16, seed=0, cachekv_int8=True)

    paths = [a for a in sys.argv[1:] if a in ("int8kv", "paged")] or ["int8kv", "paged"]
    if "int8kv" in paths:
        ids, mask = int8kv_request(model.config, 1, dev)
        profile_request(torch, "int8kv", lambda n: greedy_generate(
            model, ids, mask, max_new_tokens=n, eos_token_id=-1), llama7b.INT8KV_NEW_TOKENS)
    if "paged" not in paths:
        return
    ids, mask = paged_batch(model.config, 1, dev)
    bs, lens = llama7b.PAGED_BLOCK_SIZE, llama7b.PAGED_PROMPT_LENS
    profile_request(torch, "paged", lambda n: paged_greedy_generate(
        model, ids, mask, max_new_tokens=n, block_size=bs, num_blocks=blocks_needed(lens, n, bs),
        eos_token_id=-1), llama7b.PAGED_NEW_TOKENS)


if __name__ == "__main__":
    main()
