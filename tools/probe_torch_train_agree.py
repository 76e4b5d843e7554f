#!/usr/bin/env python3
"""Where the gradient gap of `chip_smoke.py`'s train agree comes from, in the
PyTorch port.

Builds the full-width Llama-2-7B (seeded random weights, bf16) with the LoRA
factors and the packed 1 x 2048 row of train agree (`chip_smoke.agree_inputs`)
on one CUDA card, and runs one forward + backward in five variants: the
kernels; every training kernel's plain version; the same with the forward's
P rounded to bf16 before P.V (`chip_smoke.train_plain_swaps`); the attention
kernels' plain versions alone; RMSNorm's alone. For the full 32 layers, then
the first 8 and the first 2, prints each pair's loss gap (relative) and the
median and largest relative L2 between their factor gradients, and the
kernels-vs-plain gap of each layer's worst factor.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_train_agree.py
"""

import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEPTHS = (32, 8, 2)
PAIRS = (("kernels", "plain"), ("plain P rounded", "plain"), ("kernels", "plain P rounded"),
         ("kernels", "plain attention"), ("kernels", "plain RMSNorm"))


def layer_of(name):
    return int(name.split("layers.")[1].split(".")[0])


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddlemix_tpu_torch.kernels import build_all
    from paddlemix_tpu_torch.models.llama import random_llama
    from paddlemix_tpu_torch.ops import attention, norms
    from paddlemix_tpu_torch.tools import supervised_finetune as sft

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_train_agree: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_all(["flash_fwd", "flash_bwd"])
    model = random_llama(dev, torch.bfloat16, seed=0)
    cfg = sft.load_config(cs.TRAIN_CONFIG, cs.TRAIN_OVERRIDES)
    _, factors, loss_fn, batch = cs.agree_inputs(torch, np, dev, model, cfg)
    plain, plain_rounded = cs.train_plain_swaps(
        torch, types.SimpleNamespace(attn=attention, norms=norms))
    variants = {"kernels": [], "plain": plain, "plain P rounded": plain_rounded,
                "plain attention": plain[:3], "plain RMSNorm": plain[3:]}
    layers = model.model.layers
    for depth in DEPTHS:
        model.model.layers = layers[:depth]
        kept = {n: p for n, p in factors.items() if "layers." not in n or layer_of(n) < depth}
        runs = {}
        for name, swaps in variants.items():
            with cs.swapped(swaps):
                loss = loss_fn(kept, batch, None)
                runs[name] = (loss.item(), torch.autograd.grad(loss, list(kept.values())))
        for a, b in PAIRS:
            (loss_a, grads_a), (loss_b, grads_b) = runs[a], runs[b]
            med, top = cs.gradient_gap(grads_a, grads_b)
            print(f"[{depth} layers] {a} vs {b}: loss {abs(loss_a - loss_b) / abs(loss_b):.3e} "
                  f"apart; factor gradients median {med:.3e}, max {top:.3e}", flush=True)
        worst = {}
        for n, x, y in zip(kept, runs["kernels"][1], runs["plain"][1]):
            if "layers." in n:
                gap = cs.rel_l2(x.float(), y.float())
                worst[layer_of(n)] = max(worst.get(layer_of(n), 0.0), gap)
        print(f"[{depth} layers] kernels vs plain, each layer's worst factor: "
              + ", ".join(f"{i}: {w:.4f}" for i, w in sorted(worst.items())), flush=True)
        del runs
    model.model.layers = layers


if __name__ == "__main__":
    main()
