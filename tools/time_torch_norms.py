#!/usr/bin/env python3
"""B4 (GroupNorm, and its statistics alone) and B10's backward in the PyTorch
port, one checkout against another in one call: `group_norm` and
`group_norm_stats` at the paths' GroupNorm shapes and `layer_norm_backward` at
the CLIP path's rows, each timed as chip_smoke.py times a kernel (10 launches
captured in a CUDA graph, one replay between CUDA events), with F.group_norm +
F.silu (weight and bias in bf16) and the backward of F.layer_norm as
yardsticks. The package is imported from the tree given (default: this
checkout), whose kernels build into that tree's own build/ directory, so the
parent commit unpacked into a git-ignored directory can be timed beside this
one:

    git archive HEAD~1 | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 tools/time_torch_norms.py --tree $t; done

Prints one line a case: the tree, the card and its power limit, and the
times in ms. With --walks it prints instead, on the CPU, B4's launches by
shape in a request or training step of each path, from the module walks
(chip_smoke.py `group_norm_walks`).
"""

import argparse
import os
import subprocess
import sys

# (B, H, W, C), act, weight dtype: SDXL's largest map, the 64 x 64 ones at
# 960 (SDXL) and in training, SD1.5's and training's small ones, the VAE maps
GN_SHAPES = [((2, 128, 128, 320), "silu", "bf16"), ((2, 64, 64, 960), "silu", "bf16"),
             ((2, 128, 128, 960), "silu", "bf16"), ((8, 64, 64, 320), "silu", "fp32"),
             ((8, 64, 64, 960), "silu", "fp32"), ((2, 32, 32, 640), "silu", "bf16"),
             ((8, 8, 8, 1280), "silu", "fp32"), ((2, 32, 32, 1280), "none", "bf16"),
             ((1, 256, 256, 256), "silu", "bf16"), ((1, 512, 512, 128), "silu", "bf16"),
             ((1, 1024, 1024, 128), "silu", "bf16"), ((1, 50, 100, 96), "silu", "bf16")]


def walks():
    import chip_smoke as cs

    for path, calls in cs.group_norm_walks().items():
        print(f"{path}: {sum(calls.values())} launches", flush=True)
        for (name, shape, act), n in sorted(calls.items(), key=lambda kv: (-kv[1], kv[0][1])):
            print(f"  {name} {shape} {act}: {n}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--walks", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    if args.walks:
        return walks()
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddlemix_tpu_torch.ops import norms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    assert os.path.dirname(os.path.abspath(norms.__file__)).startswith(tree), norms.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    wdt = {"bf16": bf16, "fp32": torch.float32}
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, act, wd in GN_SHAPES:
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        w = (1 + 0.05 * torch.randn(c, generator=gen, device=dev)).to(wdt[wd])
        b = (0.05 * torch.randn(c, generator=gen, device=dev)).to(wdt[wd])
        ms = cs.cuda_ms(torch, lambda: norms.group_norm(x, w, b, 32, 1e-5, act))
        x_nchw, w16, b16 = x.permute(0, 3, 1, 2), w.to(bf16), b.to(bf16)

        def lib():
            y = F.group_norm(x_nchw, 32, w16, b16, 1e-5)
            return F.silu(y) if act == "silu" else y
        lib_ms = cs.cuda_ms(torch, lib)
        print(f"{tree} | {smi} | group_norm {shape} {act} {wd} w / b: {ms:.4f} ms; "
              f"F.group_norm{' + F.silu' if act == 'silu' else ''} {lib_ms:.4f} ms", flush=True)
        del x, x_nchw
        torch.cuda.empty_cache()
    for shape, _, _ in cs.FUSED_CASES:
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        ms = cs.cuda_ms(torch, lambda: norms.group_norm_stats(x, 32, 1e-5))
        print(f"{tree} | {smi} | group_norm_stats {shape}: {ms:.4f} ms", flush=True)
        del x
        torch.cuda.empty_cache()
    for rows, h, span in cs.CLIP_LN_SHAPES:
        x = torch.randn((rows, span, h), generator=gen, device=dev).to(bf16)[:, 0]
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        g = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
        ms = cs.cuda_ms(torch, lambda: norms.layer_norm_backward(x, w, g, 1e-5))
        lib_ms = cs.backward_ms(torch, lambda *t: F.layer_norm(t[0], (h,), t[1], t[2], 1e-5),
                                tuple(t.detach().clone().requires_grad_()
                                      for t in (x, w.to(bf16), (0.1 * w).to(bf16))), g)
        label = f"({rows},{h}){' row stride ' + str(span) if span > 1 else ''}"
        print(f"{tree} | {smi} | layer_norm_backward {label}: {ms:.4f} ms; the backward of "
              f"F.layer_norm {lib_ms:.4f} ms", flush=True)
        del x, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
