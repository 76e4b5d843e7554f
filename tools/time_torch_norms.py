#!/usr/bin/env python3
"""The norm kernels of the PyTorch port, one checkout against another in one
call: B4 (`group_norm`, `group_norm_stats`) at the paths' GroupNorm shapes,
B10 (`layer_norm` and `layer_norm_backward`) at the CLIP-family rows, B11's
forward (`rms_norm`) at its four path shapes and B12 (`adaptive_layer_norm`)
and B13 (`fused_adaln_scale_residual`) at SD3's image and context rows, each
timed as chip_smoke.py times a kernel (10 launches, or a pass through copies
of the input rotating past the L2, captured in a CUDA graph, one replay
between CUDA events), with F.group_norm + F.silu (weight and bias in bf16),
F.layer_norm (bf16 weight and bias) and its backward, F.rms_norm (bf16
weight) and F.layer_norm (the norm alone) as yardsticks. For B10's forward,
B11, B12 and B13 it also prints `copy_` of the rows read (the same bytes read
and written), the floor (an empty kernel of the plan's launch shape, as many
launches in the graph; trees with no such plan print none) and the host
microseconds to enqueue one call (1,000 calls without a sync, then one sync).
The package is imported from the tree given (default: this checkout), whose
kernels build into that tree's own build/ directory, so the parent commit
unpacked into a git-ignored directory can be timed beside this one:

    git archive HEAD~1 | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 tools/time_torch_norms.py --tree $t; done

`--only gn|ln|rows` times one group. Prints one line a case: the tree, the
card and its power limit, and the times in ms. With --walks it prints
instead, on the CPU, B4's launches by shape in a request or training step of
each path, from the module walks (chip_smoke.py `group_norm_walks`).
"""

import argparse
import os
import subprocess
import sys
import time

# (B, H, W, C), act, weight dtype: SDXL's largest map, the 64 x 64 ones at
# 960 (SDXL) and in training, SD1.5's and training's small ones, the VAE maps
GN_SHAPES = [((2, 128, 128, 320), "silu", "bf16"), ((2, 64, 64, 960), "silu", "bf16"),
             ((2, 128, 128, 960), "silu", "bf16"), ((8, 64, 64, 320), "silu", "fp32"),
             ((8, 64, 64, 960), "silu", "fp32"), ((2, 32, 32, 640), "silu", "bf16"),
             ((8, 8, 8, 1280), "silu", "fp32"), ((2, 32, 32, 1280), "none", "bf16"),
             ((1, 256, 256, 256), "silu", "bf16"), ((1, 512, 512, 128), "silu", "bf16"),
             ((1, 1024, 1024, 128), "silu", "bf16"), ((1, 50, 100, 96), "silu", "bf16")]
# (rows, width) of B11's forward: the decode row, T5's rows, the LLaVA prefill,
# the SFT forward's; (B, S, H) of B12: SD3's image and context rows
RMS_SHAPES = [(1, 4096), (77, 4096), (608, 4096), (4096, 4096)]
ADALN_SHAPES = [(2, 4096, 1536), (2, 154, 1536)]
HOST_CALLS = 1000


def host_us(torch, fn):
    """Host microseconds a call: HOST_CALLS calls without a sync, then one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def floor_ms(torch, cs, norms, blocks, threads, copies):
    """An empty kernel of the launch shape, timed as the kernel is (`copies`
    launches in one graph), where the tree's library has one."""
    if not hasattr(norms, "empty_launch"):
        return "none in this tree"
    return f"{cs.cuda_ms(torch, lambda: norms.empty_launch(blocks, threads), iters=copies):.4f} ms"


def row_norms(torch, F, cs, norms, label, dev, gen):
    bf16 = torch.bfloat16
    for rows, h in RMS_SHAPES:
        x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(bf16)
        w = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
        w16 = w.to(bf16)
        kernel = cs.cold(lambda x_: norms.rms_norm(x_, w, 1e-5), x, cs.nbytes(x))
        ms = cs.cuda_ms(torch, kernel)
        lib_ms = cs.cuda_ms(torch, cs.cold(lambda x_: F.rms_norm(x_, (h,), w16, 1e-5), x,
                                           cs.nbytes(x)))
        plan = norms.rms_norm_plan(rows, h, 2) if hasattr(norms, "rms_norm_plan") else None
        floor = floor_ms(torch, cs, norms, plan.blocks, plan.threads, kernel.copies) \
            if plan else "no plan"
        host = host_us(torch, lambda: norms.rms_norm(x, w, 1e-5))
        copy = cs.cuda_ms(torch, cs.cold(lambda x_: torch.empty_like(x_).copy_(x_), x,
                                         cs.nbytes(x)))
        print(f"{label} | rms_norm ({rows},{h}) bf16, fp32 weight: {ms:.4f} ms; F.rms_norm "
              f"{lib_ms:.4f} ms; copy_ of x {copy:.4f} ms; floor {floor}; host {host:.2f} us a "
              f"call | plan {plan}", flush=True)
        del x
    for shape in ADALN_SHAPES:
        b_, s_, h_ = shape
        rx = torch.randn((2,) + shape, generator=gen, device=dev).mul_(2.0).to(bf16)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(bf16)
        shift, scale = mod.chunk(6, dim=-1)[:2]
        kernel = cs.cold(lambda t: norms.adaptive_layer_norm(t[1], scale, shift), rx,
                         cs.nbytes(rx))
        ms = cs.cuda_ms(torch, kernel)
        lib_ms = cs.cuda_ms(torch, cs.cold(lambda t: F.layer_norm(t[1], (h_,), eps=1e-5), rx,
                                           cs.nbytes(rx)))
        plan = norms.adaln_plan(b_, s_, h_) if hasattr(norms, "adaln_plan") else None
        floor = floor_ms(torch, cs, norms, b_ * plan.nb, plan.threads, kernel.copies) \
            if plan else "no plan"
        host = host_us(torch, lambda: norms.adaptive_layer_norm(rx[1], scale, shift))
        copy = cs.cuda_ms(torch, cs.cold(lambda t: torch.empty_like(t[1]).copy_(t[1]), rx,
                                         cs.nbytes(rx)))
        print(f"{label} | adaptive_layer_norm {shape} bf16: {ms:.4f} ms; F.layer_norm "
              f"{lib_ms:.4f} ms; copy_ of x {copy:.4f} ms; floor {floor}; host {host:.2f} us a "
              f"call | plan {plan}", flush=True)
        gate = mod.chunk(6, dim=-1)[2]
        kernel = cs.cold(lambda t: norms.fused_adaln_scale_residual(t[0], t[1], gate, scale, shift),
                         rx, cs.nbytes(rx))
        ms = cs.cuda_ms(torch, kernel)
        plan = norms.fused_adaln_plan(b_, s_, h_) if hasattr(norms, "fused_adaln_plan") else None
        floor = floor_ms(torch, cs, norms, b_ * plan.nb, plan.threads, kernel.copies) \
            if plan else "no plan"
        host = host_us(torch, lambda: norms.fused_adaln_scale_residual(rx[0], rx[1], gate, scale,
                                                                       shift))
        # the residual and x read, as many bytes written: one copy_ of both
        copy = cs.cuda_ms(torch, cs.cold(lambda t: torch.empty_like(t).copy_(t), rx,
                                         cs.nbytes(rx)))
        print(f"{label} | fused_adaln_scale_residual {shape} bf16: {ms:.4f} ms; copy_ of residual "
              f"and x {copy:.4f} ms; floor {floor}; host {host:.2f} us a call | plan {plan}",
              flush=True)
        del rx
        torch.cuda.empty_cache()


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
    ap.add_argument("--only", choices=("gn", "ln", "rows"))
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
    if args.only in (None, "rows"):
        row_norms(torch, F, cs, norms, f"{tree} | {smi}", dev, gen)
    for shape, act, wd in GN_SHAPES if args.only in (None, "gn") else ():
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
    for shape, _, _ in cs.FUSED_CASES if args.only in (None, "gn") else ():
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        ms = cs.cuda_ms(torch, lambda: norms.group_norm_stats(x, 32, 1e-5))
        print(f"{tree} | {smi} | group_norm_stats {shape}: {ms:.4f} ms", flush=True)
        del x
        torch.cuda.empty_cache()
    for rows, h, span in cs.CLIP_LN_SHAPES if args.only in (None, "ln") else ():
        x = torch.randn((rows, span, h), generator=gen, device=dev).to(bf16)[:, 0]
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        b = 0.2 * torch.randn(h, generator=gen, device=dev)
        g = torch.randn((rows, h), generator=gen, device=dev).to(bf16)
        label = f"({rows},{h}){' row stride ' + str(span) if span > 1 else ''}"
        kernel = cs.cold(lambda x_: norms.layer_norm(x_, w, b, 1e-5), x, cs.nbytes(x))
        ms = cs.cuda_ms(torch, kernel)
        w16, b16 = w.to(bf16), b.to(bf16)
        lib_ms = cs.cuda_ms(torch, cs.cold(lambda x_: F.layer_norm(x_, (h,), w16, b16, 1e-5), x,
                                           cs.nbytes(x)))
        plan = norms.layer_norm_plan(rows, h, 2) if hasattr(norms, "layer_norm_plan") else None
        floor = floor_ms(torch, cs, norms, plan.nb, plan.threads, kernel.copies) \
            if plan else "no plan"
        host = host_us(torch, lambda: norms.layer_norm(x, w, b, 1e-5))
        copy = cs.cuda_ms(torch, cs.cold(lambda x_: torch.empty_like(x_).copy_(x_), x,
                                         cs.nbytes(x)))
        print(f"{tree} | {smi} | layer_norm {label} bf16, fp32 w / b: {ms:.4f} ms; F.layer_norm "
              f"{lib_ms:.4f} ms; copy_ of x {copy:.4f} ms; floor {floor}; host {host:.2f} us a "
              f"call | plan {plan}", flush=True)
        ms = cs.cuda_ms(torch, lambda: norms.layer_norm_backward(x, w, g, 1e-5))
        lib_ms = cs.backward_ms(torch, lambda *t: F.layer_norm(t[0], (h,), t[1], t[2], 1e-5),
                                tuple(t.detach().clone().requires_grad_()
                                      for t in (x, w.to(bf16), (0.1 * w).to(bf16))), g)
        print(f"{tree} | {smi} | layer_norm_backward {label}: {ms:.4f} ms; the backward of "
              f"F.layer_norm {lib_ms:.4f} ms", flush=True)
        del x, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
