#!/usr/bin/env python3
"""Where the device time of one CLIP ViT-B/16 training step goes, in the
PyTorch port: the contrastive loss of `tools.train_clip.clip_loss_fn` over a
seeded batch of 256 (pixels and captions), forward and backward
(torch.autograd.grad over every trainable parameter), as the Trainer runs a
micro-batch; the optimizer is left out. Builds the model with seeded random
weights on one CUDA card, runs three warm steps, then one under
torch.profiler (CUDA activity). Prints the card's nvidia-smi name and power
limit, the step's device kernel time and kernels, the time by category (B10
LayerNorm's forward and its backward, the flash forward and backward, GEMMs,
the rest) and the top kernels. The package is imported from the tree given
(default: this checkout), so the parent commit unpacked into a git-ignored
directory can be profiled beside this one:

    python3 tools/profile_torch_clip_train.py --tree build/parent
"""

import argparse
import os
import subprocess
import sys


def category(name: str) -> str:
    n = name.lower()
    if "ln_bwd" in n or "layer_norm_bwd" in n or "column_sum" in n:
        return "B10 LayerNorm backward"
    if "layer_norm_fwd" in n:
        return "B10 LayerNorm forward"
    if "flash" in n:
        return "flash attention"
    if any(s in n for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "cuBLAS GEMMs"
    if "softmax" in n:
        return "softmax"
    return "elementwise / copies / reductions"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlemix_tpu_torch.models.clip.vitb16 import BENCH_BATCH, random_clip, seeded_inputs
    from paddlemix_tpu_torch.ops import norms
    from paddlemix_tpu_torch.tools import train_clip

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_clip_train: needs a CUDA card")
    assert os.path.dirname(os.path.abspath(norms.__file__)).startswith(tree), norms.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model = random_clip(dev, seed=0)
    px, ids = seeded_inputs(model.config, BENCH_BATCH, seed=1, device=dev)
    loss_fn = train_clip.clip_loss_fn(model)
    params = [p for p in model.parameters() if p.requires_grad]
    batch = {"pixel_values": px, "input_ids": ids}

    def step():
        loss = loss_fn(None, batch, None)[0]
        return torch.autograd.grad(loss, params)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    total, launches, cats, top = 0.0, 0, {}, []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        total += ms
        launches += e.count
        cat = category(e.key)
        cats[cat] = (cats.get(cat, (0.0, 0))[0] + ms, cats.get(cat, (0.0, 0))[1] + e.count)
        top.append((ms, e.count, e.key))
    print(f"{tree} | {smi} | CLIP ViT-B/16 training step at batch {BENCH_BATCH} (forward + "
          f"backward): {total:.2f} ms of device time, {launches} kernels", flush=True)
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat}: {ms:.3f} ms, {n} kernels", flush=True)
    for ms, n, key in sorted(top, reverse=True)[:12]:
        print(f"  top: {ms:.3f} ms, {n}x {key[:110]}", flush=True)


if __name__ == "__main__":
    main()
