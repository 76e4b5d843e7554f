#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddlemix_tpu_torch) on one CUDA card.

Drives SDXL-1024 text-to-image through StableDiffusionXLPipeline.__call__
at the published SDXL widths, in bf16 and then in the static a8w8
configuration, with weights drawn on the card from a seeded
torch.Generator. One pipeline built with quant="a8w8_static" serves both:
until its scales are loaded it is the bf16 path. Phases:

  1. device       card name and power limit, TF32 switches set and printed
  2. build        nvcc builds paddlemix_tpu_torch/csrc/*.cu into
                  build/kernels/, one process per source, in parallel
  3. kernels      each kernel against its plain PyTorch version at the main
                  path's shapes, with kernel and plain times from CUDA events
  4. agree        one full-width bf16 UNet forward at a small latent, kernels
                  vs plain
  5. serve        3 bf16 requests, 1024x1024, 25 Euler steps, guidance 5.0;
                  each must launch the kernels as often as walking the blocks
                  predicts
  6. calibrate    record and load the 771 UNet + 33 VAE static a8w8 scales
  7. a8w8 agree   the full-width a8w8 UNet at a small latent like the
                  calibration's, int8 kernels vs plain, and for each int8
                  kernel a control run whose plain version skips its
                  activation quantize, which must fail the same limit (and,
                  ungated, all kernels vs plain and a8w8 vs bf16)
  8. a8w8 serve   the same 3 requests in a8w8, with the same checks

Any failed check exits non-zero. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero before printing any result. The line
before the last is the card's `nvidia-smi` name and power limit, the one
before that a JSON summary of the kernels, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HEIGHT = WIDTH = 1024
STEPS = 25
GUIDANCE = 5.0
REQUESTS = [("a photograph of an astronaut riding a horse on the moon", 1),
            ("a watercolor painting of a lighthouse at dawn", 2),
            ("a bowl of ramen on a wooden table, studio lighting", 3)]
FLASH_SHAPES = [(2, 4096, 10, 64), (2, 1024, 20, 64), (1, 1000, 4, 64)]
GN_CASES = [((2, 128, 128, 320), "silu"), ((2, 64, 64, 960), "silu"),
            ((2, 32, 32, 1280), "none"), ((1, 1024, 1024, 256), "silu"),
            ((1, 1024, 1024, 128), "silu")]
# (M, K, N) of the int8 GEMM: GEGLU proj at 64x64 and 32x32, ff out at 32x32, attn2 k/v
GEMM_SHAPES = [(8192, 640, 5120), (2048, 1280, 10240), (2048, 5120, 1280), (154, 2048, 1280)]
# (B, H, W, C) of the int8 3x3 conv (C -> C): the UNet's and the VAE's up-sample convs
CONV_SHAPES = [(2, 64, 64, 1280), (1, 512, 512, 512), (1, 1024, 1024, 256)]
# ((B, H, W, C), O, epilogue) of the fused resnet conv
FUSED_CASES = [((2, 128, 128, 320), 320, None), ((2, 32, 32, 2560), 1280, "temb"),
               ((2, 32, 32, 1280), 1280, "residual"), ((1, 1024, 1024, 128), 128, None)]
FLASH_TOL = 2e-2  # x max(1, |ref|max): bf16 inputs and P against an fp32 plain version
GN_TOL = 3e-2     # absolute: bf16 output rounding (half an ulp is 1.6e-2 below 8)
# B2, B3, B5: the int32 sums are exact on both sides and the kernels round
# every fp32 step (affine, SiLU, quantize, dequant, epilogue) as the plain
# versions do, so they are bit-exact; the limit allows one bf16 rounding apart
# per element, |out - ref| <= 2**-7 * |ref| (see bf16_ulps). A plain version
# that skips its activation quantize must fail it (the control).
INT8_ULPS = 1.0
AGREE_TOL = 5e-2  # relative L2 of the full-width UNet output, kernels vs plain, bf16
A8W8_AGREE_TOL = 1e-3  # the same with B2/B3/B5 vs plain: bit-exact kernels read 0


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(torch, fn, iters=10, warmup=3):
    """Mean milliseconds of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(torch, kernel, plain):
    """Kernel and plain times measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def bf16_ulps(out, ref):
    """max |out - ref| in units of one bf16 ulp of ref (<= 2**-7 * |ref|)."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (2.0 ** -7 * ref.abs() + 2.0 ** -126)).max().item()


def plain_swaps(m, int8=True, bf16=True):
    """(module, wrapper name, plain version) for the kernel wrappers the model
    calls: the int8 ones (B2, B3, B5), and with `bf16` also flash attention
    and GroupNorm (B1, B4, and the GroupNorm statistics that make B5's
    affine)."""
    swaps = []
    if bf16:
        swaps += [
            (m.attn, "flash_attention", lambda q, k, v, **kw: m.attn.flash_attention_ref(
                q, k, v, scale=kw.get("scale"))),
            (m.resnet, "group_norm", m.norms.group_norm_ref),
            (m.fused, "group_norm_stats", m.norms._group_moments),
        ]
    if int8:
        swaps += [
            (m.quant, "int8_a8w8_matmul", m.conv_int8.int8_a8w8_matmul_ref),
            (m.quant, "int8_conv3x3_same", m.conv_int8.int8_conv3x3_same_ref),
            (m.resnet, "fused_gn_silu_conv3x3", m.fused.fused_gn_silu_conv3x3_ref),
        ]
    return swaps


def unquantized(m, plain):
    """`plain` with its activation quantize step removed: it convolves or
    multiplies x / sx unrounded and unclipped. The control of the int8 checks."""
    def no_quantize(x, sx):
        return x.float() * (1.0 / sx)

    def run(*args, **kwargs):
        with swapped([(m.conv_int8, "quantize_int8", no_quantize),
                      (m.fused, "quantize_int8", no_quantize)]):
            return plain(*args, **kwargs)
    return run


class swapped:
    """Inside the block, each (module, name) attribute is replaced by fn."""

    def __init__(self, swaps):
        self.swaps = list(swaps)

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.saved):
            setattr(mod, name, fn)


def main():
    import types

    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this run needs a "
                                     "CUDA card")
    check(os.path.isdir(os.path.join(REPO, "paddlemix_tpu_torch")),
          f"paddlemix_tpu_torch not found beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO)
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod
    from paddlemix_tpu_torch.diffusers.sdxl import (
        calibrate_static_a8w8,
        expected_launches,
        random_sdxl_pipeline,
    )
    from paddlemix_tpu_torch.kernels import build_all, build_log
    from paddlemix_tpu_torch.ops import attention as attn_mod
    from paddlemix_tpu_torch.ops import conv_int8 as conv_int8_mod
    from paddlemix_tpu_torch.ops import fused_resnet as fused_mod
    from paddlemix_tpu_torch.ops import norms as norms_mod
    from paddlemix_tpu_torch.ops import quant as quant_mod

    mods = types.SimpleNamespace(attn=attn_mod, resnet=resnet_mod, norms=norms_mod,
                                 quant=quant_mod, conv_int8=conv_int8_mod, fused=fused_mod)

    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    build_all(["flash_fwd", "int8_gemm", "int8_conv3x3"])
    print(f"[build] 3 sources in parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build_log.items():
        print(f"[build] {name}.cu: {log['seconds']:.1f} s -> {log['path']}", flush=True)
        for line in log["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # --------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    for shape in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(3))
        out = attn_mod.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attn_mod.flash_attention_ref(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        tol = FLASH_TOL * max(1.0, ref.abs().max().item())
        ms, plain_ms = timed_pair(torch, lambda: attn_mod.flash_attention(q, k, v),
                                  lambda: attn_mod.flash_attention_ref(q, k, v))
        print(f"[kernels] flash {shape} bf16: max_abs_err {err:.3e} (tol {tol:.3e}) | "
              f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms", flush=True)
        check(bool(torch.isfinite(out).all()) and err <= tol, f"flash {shape}: err {err}")
        summary.setdefault("flash_attention", []).append((shape, err, ms, plain_ms))
        del q, k, v, out, ref
    for shape, act in GN_CASES:
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev, dtype=bf16)
        w = (1.0 + 0.05 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        b = (0.05 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        t0 = time.perf_counter()
        out = norms_mod.group_norm(x, w, b, 32, 1e-5, act)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ref = norms_mod.group_norm_ref(x.float(), w.float(), b.float(), 32, 1e-5, act)
        err = (out.float() - ref).abs().max().item()
        ms, plain_ms = timed_pair(torch, lambda: norms_mod.group_norm(x, w, b, 32, 1e-5, act),
                                  lambda: norms_mod.group_norm_ref(x, w, b, 32, 1e-5, act))
        print(f"[kernels] group_norm {shape} {act} bf16: max_abs_err {err:.3e} (tol {GN_TOL}) | "
              f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | first call {first_s:.2f} s",
              flush=True)
        check(bool(torch.isfinite(out).all()) and err <= GN_TOL,
              f"group_norm {shape} {act}: err {err}")
        summary.setdefault("group_norm", []).append((shape, err, ms, plain_ms))
        del x, out, ref

    def int8_case(name, shape, kernel, plain, extra=""):
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        ulps = bf16_ulps(out, ref)
        control = bf16_ulps(unquantized(mods, plain)(), ref)
        ms, plain_ms = timed_pair(torch, kernel, plain)
        print(f"[kernels] {name} {shape}{extra}: max_abs_err {err:.3e}, {ulps:.3g} bf16 ulps "
              f"(limit {INT8_ULPS}; control without the quantize {control:.3g}) | "
              f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms", flush=True)
        check(bool(torch.isfinite(out).all()) and ulps <= INT8_ULPS,
              f"{name} {shape}: {ulps} bf16 ulps")
        check(control > INT8_ULPS, f"{name} {shape}: the control passes the limit ({control})")
        summary.setdefault(name, []).append((shape, err, ms, plain_ms))

    ci, fr = conv_int8_mod, fused_mod
    for m, k, n in GEMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wf = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        sx = quant_mod.static_scale(x.float().abs().max().item())
        int8_case("int8_a8w8_matmul", (m, k, n), lambda: ci.int8_a8w8_matmul(x, wq, sw, sx, bias),
                  lambda: ci.int8_a8w8_matmul_ref(x, wq, sw, sx, bias))
        w16 = wf.to(bf16).t().contiguous()
        mm_ms = (cuda_ms(torch, lambda: torch.matmul(x, w16))
                 + cuda_ms(torch, lambda: torch.matmul(x, w16))) / 2
        print(f"[kernels]   bf16 torch.matmul {(m, k, n)} for comparison (not gated): "
              f"{mm_ms:.3f} ms", flush=True)
        del x, wf, wq, w16
    for shape in CONV_SHAPES:
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        wf = torch.randn((c, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        wq = ci.conv3x3_weight_layout(wq)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        sx = quant_mod.static_scale(x.float().abs().max().item())
        int8_case("int8_conv3x3_same", shape,
                  lambda: ci.int8_conv3x3_same(x, wq, sw, sx, bias),
                  lambda: ci.int8_conv3x3_same_ref(x, wq, sw, sx, bias))
        del x, wf, wq
    for shape, o, epi in FUSED_CASES:
        b_, h, w_, c = shape
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        wf = torch.randn((o, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5
        wq, sw = ci.quantize_weight_per_cout(wf)
        wq = ci.conv3x3_weight_layout(wq)
        bias = 0.1 * torch.randn(o, generator=gen, device=dev)
        kw = {}
        if epi == "temb":
            kw["temb"] = torch.randn((b_, o), generator=gen, device=dev).to(bf16)
        elif epi == "residual":
            kw["residual"] = torch.randn((b_, h, w_, o), generator=gen, device=dev).to(bf16)
        sx = quant_mod.static_scale(4.0)  # SiLU of a unit-variance GroupNorm output
        args = (x, gamma, beta, 32, 1e-5, wq, sw, sx, bias)
        int8_case("fused_gn_silu_conv3x3", shape + (o,),
                  lambda: fr.fused_gn_silu_conv3x3(*args, **kw),
                  lambda: fr.fused_gn_silu_conv3x3_ref(*args, **kw), f" {epi or 'bias only'}")
        del x, wf, wq, kw

    # ---------------------------------------------------------------- models
    t0 = time.perf_counter()
    pipe = random_sdxl_pipeline(dev, bf16, seed=0, quant="a8w8_static")
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("unet", "vae", "text_encoder", "text_encoder_2")}
    print(f"[models] built on the card in {time.perf_counter() - t0:.1f} s (quant "
          f"a8w8_static, no scales loaded yet: the bf16 path): {n_params}", flush=True)

    # ----------------------------------------------------------------- agree
    rand_inputs = (
        torch.randn((2, 32, 32, 4), generator=gen, device=dev, dtype=bf16),
        torch.tensor([500.0, 500.0], device=dev),
        torch.randn((2, 77, 2048), generator=gen, device=dev, dtype=bf16),
        {"text_embeds": torch.randn((2, 1280), generator=gen, device=dev, dtype=bf16),
         "time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2, device=dev)})
    # a8w8 is checked on inputs like the calibration's (the first request's
    # prompt, the first timestep), which fill the recorded int8 ranges
    with torch.inference_mode():
        ctx_c, added_c, lat_c = pipe.prepare_inputs(REQUESTS[0][0], 256, 256, GUIDANCE, seed=0)
    t_c = pipe.scheduler.set_timesteps(STEPS).timesteps[0].to(dev).expand(2)
    calib_inputs = (torch.cat([lat_c, lat_c]).to(bf16), t_c, ctx_c, added_c)

    def unet(inputs, swaps=()):
        lat, t, ctx, added = inputs
        with torch.inference_mode(), swapped(swaps):
            return pipe.unet(lat, t, ctx, added_cond_kwargs=added).float()

    def agree(label, out_k, out_p, what, tol=AGREE_TOL):
        rel = rel_l2(out_k, out_p)
        print(f"[{label}] full-width UNet at 32x32 latents, {what}: relative L2 "
              f"{rel:.3e} (tol {tol}), |out| max {out_p.abs().max().item():.3f}",
              flush=True)
        check(bool(torch.isfinite(out_k).all()) and rel <= tol, f"{label}: relative L2 {rel}")

    agree("agree", unet(rand_inputs), unet(rand_inputs, plain_swaps(mods, int8=False)),
          "kernels vs plain")
    out_bf16 = unet(calib_inputs)

    # ----------------------------------------------------------------- serve
    counters = {"flash_attention": attn_mod.flash_attention, "group_norm": norms_mod.group_norm,
                "group_norm_stats": norms_mod.group_norm_stats,
                "int8_a8w8_matmul": conv_int8_mod.int8_a8w8_matmul,
                "int8_conv3x3_same": conv_int8_mod.int8_conv3x3_same,
                "fused_gn_silu_conv3x3": fused_mod.fused_gn_silu_conv3x3}

    def count(name):
        fn = counters.get(name, conv_int8_mod.int8_conv2d_plain)
        return fn.calls if name == "int8_conv2d_plain" else fn.launches

    names = list(counters) + ["int8_conv2d_plain"]

    def serve(label):
        expected = expected_launches(pipe, HEIGHT, WIDTH, STEPS, guidance_scale=GUIDANCE)
        expected = {name: expected.get(name, 0) for name in names}
        print(f"[{label}] expected launches per request (walking the blocks): {expected}")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        conv_int8_mod.int8_conv2d_plain.calls = 0
        seconds = []
        for prompt, seed in REQUESTS:
            before = {name: count(name) for name in names}
            t0 = time.perf_counter()
            image = pipe(prompt, height=HEIGHT, width=WIDTH, num_inference_steps=STEPS,
                         guidance_scale=GUIDANCE, seed=seed, output_type="np")[0]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            got = {name: count(name) - before[name] for name in names}
            print(f"[{label}] seed {seed}: {seconds[-1]:.3f} s | image {image.shape} finite "
                  f"{bool((image == image).all())} range [{image.min():.3f}, "
                  f"{image.max():.3f}] mean {image.mean():.3f} std {image.std():.3f} | "
                  f"launches {got}", flush=True)
            check(image.shape == (1, HEIGHT, WIDTH, 3), f"image shape {image.shape}")
            check(bool(torch.isfinite(torch.from_numpy(image)).all()), "image not finite")
            check(image.min() >= 0.0 and image.max() <= 1.0, "image outside [0, 1]")
            check(got == expected, f"{label}: launches {got} != expected {expected}")
        launches = {name: count(name) for name in names}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] peak memory allocated {peak:.2f} GiB | launches over "
              f"{len(REQUESTS)} requests {launches}", flush=True)
        return launches, seconds, peak

    launches_bf16, s_bf16, peak_bf16 = serve("serve")

    # ------------------------------------------------------------- calibrate
    t0 = time.perf_counter()
    raw = calibrate_static_a8w8(pipe, REQUESTS[0][0], HEIGHT, WIDTH, STEPS, GUIDANCE, seed=0)
    torch.cuda.synchronize()
    n_unet = len(quant_mod.quant_modules(pipe.unet))
    print(f"[calibrate] {len(raw)} scales ({n_unet} UNet + {len(raw) - n_unet} VAE) recorded "
          f"and loaded in {time.perf_counter() - t0:.1f} s; raw absmax min {min(raw):.3f} "
          f"max {max(raw):.3f}", flush=True)
    check(n_unet == 771 and len(raw) == 771 + 33, f"calibrate: {len(raw)} scales")

    # ------------------------------------------------------------ a8w8 agree
    out_a8w8 = unet(calib_inputs)
    agree("a8w8 agree", out_a8w8, unet(calib_inputs, plain_swaps(mods, bf16=False)),
          "int8 kernels (B2, B3, B5) vs their plain versions, on calibration-like inputs",
          A8W8_AGREE_TOL)
    # the controls: one int8 wrapper at a time runs its plain version without
    # the activation quantize; each must fail the limit above
    for mod, name, plain in plain_swaps(mods, bf16=False):
        rel = rel_l2(unet(calib_inputs, [(mod, name, unquantized(mods, plain))]), out_a8w8)
        print(f"[a8w8 agree] control: {name} without its quantize step: relative L2 "
              f"{rel:.3e} (must exceed {A8W8_AGREE_TOL})", flush=True)
        check(rel > A8W8_AGREE_TOL, f"a8w8 agree: the {name} control passes the limit ({rel})")
    # every op requantizes its input, so a bf16 rounding difference upstream
    # (flash, GroupNorm) can move an int8 value by a whole step downstream
    all_plain = unet(calib_inputs, plain_swaps(mods))
    print(f"[a8w8 agree] not gated: all five kernels vs plain: relative L2 "
          f"{rel_l2(out_a8w8, all_plain):.3e}; a8w8 vs bf16 UNet (random weights): "
          f"{rel_l2(out_a8w8, out_bf16):.3e}", flush=True)

    # ------------------------------------------------------------ a8w8 serve
    launches_a8w8, s_a8w8, peak_a8w8 = serve("a8w8 serve")
    print(f"[a8w8 serve] seconds per request a8w8 {[round(x, 3) for x in s_a8w8]} vs bf16 "
          f"{[round(x, 3) for x in s_bf16]} (same run); peak memory a8w8 {peak_a8w8:.2f} GiB "
          f"vs bf16 {peak_bf16:.2f} GiB", flush=True)

    # --------------------------------------------------------------- summary
    def entry(name, route, source, replaces):
        # ms / plain_ms at the first shape listed; max_abs_err over all shapes;
        # launches summed over both serve phases
        rows = summary[name]
        by_phase = {"bf16": launches_bf16[name], "a8w8": launches_a8w8[name]}
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                "max_abs_err": max(r[1] for r in rows), "ms": rows[0][2],
                "plain_ms": rows[0][3]}

    kernels = [
        entry("flash_attention", "cuda", "paddlemix_tpu_torch/csrc/flash_fwd.cu",
              "paddlemix_tpu/ops/attention.py:168"),
        entry("group_norm", "triton", "paddlemix_tpu_torch/ops/norms.py",
              "paddlemix_tpu/ops/norms.py:462"),
        entry("int8_a8w8_matmul", "cuda", "paddlemix_tpu_torch/csrc/int8_gemm.cu",
              "paddlemix_tpu/ops/conv_int8.py:187"),
        entry("int8_conv3x3_same", "cuda", "paddlemix_tpu_torch/csrc/int8_conv3x3.cu",
              "paddlemix_tpu/ops/conv_int8.py:108"),
        entry("fused_gn_silu_conv3x3", "cuda", "paddlemix_tpu_torch/csrc/int8_conv3x3.cu",
              "paddlemix_tpu/ops/fused_resnet.py:196"),
    ]
    kernels[1]["stats_launches_by_phase"] = {"bf16": launches_bf16["group_norm_stats"],
                                             "a8w8": launches_a8w8["group_norm_stats"]}
    # the a8w8 requests run all five kernels, the bf16 ones flash and GroupNorm
    idle = [k["name"] for k in kernels if k["launches_by_phase"]["a8w8"] == 0] + \
        [name for name in ("flash_attention", "group_norm") if launches_bf16[name] == 0]
    check(not idle, f"kernels never launched by the requests: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
