#!/usr/bin/env python3
"""Where the device time of one SDXL-1024 request goes, in the PyTorch port.

Builds the full-width SDXL pipeline of paddlemix_tpu_torch with seeded random
weights on one CUDA card (quant="a8w8_static": bf16 until scales are
loaded), then for bf16, for static a8w8 (after calibration) and for a8w8
with int8 QK^T attention (PMIX_INT8_ATTN=1, JAX's switch: every flash call
on B1's int8 form), or for those named on the command line: two warm
requests, one request under torch.profiler (CUDA activity), one unprofiled
request. Prints the card's nvidia-smi name and power limit, device kernel
time by category (the port's five kernels by name, cuBLAS/cuDNN, LayerNorm,
softmax, the rest), the top kernels, and the busy share = device kernel time
of the profiled request / wall time of the unprofiled one; then, for a8w8,
in one more profiled request, the int8 GEMM's (B2) device ms by its (M, K, N)
and the int8 convs' (B3, B5: the activation pass and the conv a call; B5's
GroupNorm statistics are B4's) by (B, H, W, C, O): each wrapper call in a
record_function range, and the kernels inside its span on the device's
timeline. Reads the kernel names of this tree and of older ones (one
mma.sync kernel a conv call; B1's int8 form on the WMMA core, without an
activation pass), so a copy of this script can profile an older checkout.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/profile_torch_sdxl.py [bf16] [a8w8] [a8w8_int8_attn]
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPT = "a photograph of an astronaut riding a horse on the moon"
LABELS = ("bf16", "a8w8", "a8w8_int8_attn")
CALL = dict(height=1024, width=1024, num_inference_steps=25, guidance_scale=5.0,
            output_type="np")


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "int8_gemm" in n:
        return "B2 int8 GEMM"
    if "act_quant_kernel<true>" in n or "act_quant_kernelilb1" in n:
        return "B5 activation pass"
    if "act_quant_kernel" in n:
        return "B3 activation pass"
    if "conv3x3_wgmma" in n:
        return "B3 + B5 int8 conv (wgmma)"
    if "conv3x3_kernel<true>" in n or "conv3x3_kernelilb1" in n:
        return "B5 fused GN+SiLU+int8 conv"
    if "conv3x3_kernel" in n:
        return "B3 int8 conv"
    if "quantize_rows_kernel" in n:
        return "B1 int8 QK^T activation pass"
    if "flash" in n and (", true>" in n or "lb1e" in n):
        return "B1 flash forward, int8 QK^T"
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


def by_shape(torch, run, groups):
    """({wrapper: {shape: (device ms, calls)}}, {wrapper: kernels counted})
    over `run()`, one profile: every call of a group's wrapper (module,
    wrapper name, shape of the call's arguments, kernel name parts) runs in a
    record_function range named by its shape, which the profiler also lays on
    the device's timeline over the kernels launched inside it; a call's
    device time is that of those kernels whose names hold the group's parts
    (B5's GroupNorm statistics are B4's, not B5's)."""
    import bisect
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile, record_function

    ranges, calls = {}, Counter()  # range name -> (wrapper name, shape); calls by that
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in groups]
    for (mod, name, shape_of, _), (_, _, fn) in zip(groups, saved):
        def recorded(*args, _fn=fn, _name=name, _shape=shape_of, **kw):
            key = f"by_shape {_name} {_shape(*args)}"
            ranges[key] = (_name, _shape(*args))
            calls[ranges[key]] += 1
            with record_function(key):
                return _fn(*args, **kw)
        setattr(mod, name, recorded)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    device = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == device]
    spans = sorted((e.time_range.start, e.time_range.end, ranges[e.name])
                   for e in events if e.name in ranges)
    starts = [span[0] for span in spans]
    parts = {name: p for _, name, _, p in groups}
    us, counted = Counter(), Counter()
    for e in events:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if e.name in ranges or i < 0 or e.time_range.start > spans[i][1]:
            continue
        key = spans[i][2]
        if any(p in e.name for p in parts[key[0]]):
            us[key] += e.time_range.elapsed_us()
            counted[key[0]] += 1
    out = {name: {} for _, name, _, _ in groups}
    for (name, shape), n in calls.items():
        out[name][shape] = (us[(name, shape)] / 1e3, n)
    return out, counted


def a8w8_groups():
    """B2 by (M, K, N), B3 and B5 by (B, H, W, C, O), at the names the model calls."""
    from paddlemix_tpu_torch.diffusers.models import resnet
    from paddlemix_tpu_torch.ops import quant

    conv = ("conv3x3_kernel", "conv3x3_wgmma", "act_quant_kernel")
    return [(quant, "int8_a8w8_matmul",
             lambda x, wq, *a: (x.numel() // x.shape[-1], x.shape[-1], wq.shape[0]),
             ("int8_gemm",)),
            (quant, "int8_conv3x3_same", lambda x, wq, *a: tuple(x.shape) + (wq.shape[0],),
             conv),
            (resnet, "fused_gn_silu_conv3x3",
             lambda x, g, b, groups, eps, wq, *a: tuple(x.shape) + (wq.shape[0],), conv)]


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

    labels = [a for a in sys.argv[1:] if a in LABELS] or list(LABELS)
    calibrated = False
    for label in labels:
        if label != "bf16" and not calibrated:
            calibrate_static_a8w8(pipe, PROMPT, 1024, 1024, 25, 5.0)
            calibrated = True
        os.environ["PMIX_INT8_ATTN"] = "1" if label == "a8w8_int8_attn" else "0"
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
            tables, counted = by_shape(torch, lambda: request(5), a8w8_groups())
            for name, key in (("int8_a8w8_matmul", "B2 by (M, K, N)"),
                              ("int8_conv3x3_same", "B3 by (B, H, W, C, O)"),
                              ("fused_gn_silu_conv3x3", "B5 by (B, H, W, C, O)")):
                table = tables[name]
                total_ms = sum(ms for ms, _ in table.values())
                print(f"[a8w8] {key}, one request: {total_ms:.1f} ms in "
                      f"{sum(n for _, n in table.values())} calls, {counted[name]} kernels")
                for shape, (ms, n) in sorted(table.items(), key=lambda kv: -kv[1][0]):
                    print(f"[a8w8]   {str(shape):26s} {ms:8.1f} ms x{n:5d} "
                          f"({ms / n:.4f} ms a call)")

if __name__ == "__main__":
    main()
