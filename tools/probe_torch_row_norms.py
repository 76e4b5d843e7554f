#!/usr/bin/env python3
"""The row norms of csrc/norms.cu against the Triton kernels they replaced and
against edited copies of csrc/norms.cu, in one process on one card: B11's
forward (RMSNorm) and B12 (adaLN), B13 (fused adaLN + gated residual) and
B10's forward (LayerNorm).

The Triton kernels (`rms_norm_fwd` and `adaln_fwd`, `fused_adaln_residual_fwd`
and `layer_norm_fwd`, as ops/norms.py had them before csrc/norms.cu took them
over) are kept here only as a yardstick.
Variants are copies of csrc/norms.cu with text edits, given as a JSON file
{tag: [[old, new], ...]}, built with nvcc (kernels.build.NVCC_FLAGS) into the
git-ignored build/row_norm_variants/ and called through their own plans;
ptxas's registers and spills are printed for each build's row kernels. At
each path shape every build is first held against the plain version (the
gate of chip_smoke.py; a variant whose tag starts with `diag_` edits the
arithmetic away and is timed ungated), then timed as chip_smoke.py times a
kernel (a pass through copies of the inputs rotating past the L2, captured
in a CUDA graph), in two rounds (forward and reversed order), beside `copy_`
of the same bytes (the rows read, copied into as many written) and an empty
kernel of the plan's launch shape with as many launches. Last, the host
microseconds of one call through the wrapper and through the Triton launcher
(1,000 calls, then one sync; five times each, in turns).

    python3 tools/probe_torch_row_norms.py [--kernels rms,adaln,fused,ln] [--variants edits.json]
"""

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "row_norm_variants")
RMS_SHAPES = [(1, 4096), (77, 4096), (608, 4096), (4096, 4096)]
ADALN_SHAPES = [(2, 4096, 1536), (2, 154, 1536)]
# B10's forward: (rows, width, row stride in rows), chip_smoke.py's CLIP_LN_SHAPES
LN_SHAPES = [(50432, 768, 1), (19712, 512, 1), (256, 768, 197), (77, 768, 1), (77, 1280, 1),
             (577, 1024, 1)]


@functools.lru_cache(maxsize=None)
def triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_fwd(x_ptr, w_ptr, y_ptr, H, eps, BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        x = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(tl.sum(x * x, axis=0) / H + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * H + cols, (y * w).to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def adaln_fwd(x_ptr, scale_ptr, shift_ptr, y_ptr, S, H, mod_stride, eps,
                  BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        r = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(r, axis=0) / H
        diff = tl.where(mask, r - mean, 0.0)
        rstd = tl.rsqrt(tl.sum(diff * diff, axis=0) / H + eps)
        sc = tl.load(scale_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * H + cols, (diff * rstd * (1.0 + sc) + sh).to(y_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def fused_adaln_residual_fwd(res_ptr, x_ptr, gate_ptr, scale_ptr, shift_ptr, y_ptr,
                                 resi_ptr, S, H, mod_stride, eps, BLOCK_H: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // S
        cols = tl.arange(0, BLOCK_H)
        mask = cols < H
        offs = row * H + cols
        res = tl.load(res_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(gate_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        r = res + g * x
        tl.store(resi_ptr + offs, r.to(resi_ptr.dtype.element_ty), mask=mask)
        mean = tl.sum(r, axis=0) / H
        diff = tl.where(mask, r - mean, 0.0)
        rstd = tl.rsqrt(tl.sum(diff * diff, axis=0) / H + eps)
        sc = tl.load(scale_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * mod_stride + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(y_ptr + offs, (diff * rstd * (1.0 + sc) + sh).to(y_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def layer_norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, rows, H, x_stride, eps,
                       BLOCK_R: tl.constexpr, BLOCK_H: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        mask = (r < rows)[:, None] & cmask[None, :]
        r64 = r.to(tl.int64)[:, None]
        x = tl.load(x_ptr + r64 * x_stride + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / H
        diff = tl.where(mask, x - mean[:, None], 0.0)
        rstd = tl.rsqrt(tl.sum(diff * diff, axis=1) / H + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = diff * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(y_ptr + r64 * H + cols[None, :], y.to(y_ptr.dtype.element_ty), mask=mask)
    return rms_norm_fwd, adaln_fwd, fused_adaln_residual_fwd, layer_norm_fwd


def triton_rms(torch, x, w, eps=1e-5):
    h = x.shape[-1]
    y = torch.empty_like(x)
    block = max(128, 1 << (h - 1).bit_length())
    with torch.cuda.device(x.device):
        triton_kernels()[0][(x.numel() // h,)](x, w, y, h, float(eps), BLOCK_H=block,
                                               num_warps=min(16, max(1, block // 512)))
    return y


def triton_adaln(torch, x, scale, shift, eps=1e-5):
    b, s, h = x.shape
    y = torch.empty_like(x)
    block = max(128, 1 << (h - 1).bit_length())
    with torch.cuda.device(x.device):
        triton_kernels()[1][(b * s,)](x, scale, shift, y, s, h, scale.stride(0), float(eps),
                                      BLOCK_H=block, num_warps=min(16, max(1, block // 256)))
    return y


def triton_fused(torch, res, x, gate, scale, shift, eps=1e-5):
    b, s, h = x.shape
    y, resi = torch.empty_like(x), torch.empty_like(x)
    block = max(128, 1 << (h - 1).bit_length())
    with torch.cuda.device(x.device):
        triton_kernels()[2][(b * s,)](res, x, gate, scale, shift, y, resi, s, h, gate.stride(0),
                                      float(eps), BLOCK_H=block,
                                      num_warps=min(16, max(1, block // 256)))
    return y, resi


def triton_ln(torch, x, w, b, eps=1e-5):
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    block_h = max(128, 1 << (h - 1).bit_length())
    block_r = max(1, 4096 // block_h)
    with torch.cuda.device(x.device):
        triton_kernels()[3][(-(-rows // block_r),)](x, w, b, y, rows, h, x.stride(0), float(eps),
                                                     BLOCK_R=block_r, BLOCK_H=block_h,
                                                     num_warps=4)
    return y


class Build:
    """A build of (an edited copy of) csrc/norms.cu, called through its own
    plans and C entry points."""

    def __init__(self, tag, src):
        from paddlemix_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc

        os.makedirs(OUT, exist_ok=True)
        so = os.path.join(OUT, f"lib{tag}.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {tag}:\n{proc.stderr[-4000:]}")
        self.tag, self.log, L = tag, proc.stderr, ctypes.CDLL(so)
        L.rms_norm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        L.adaln_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        tail = [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        L.rms_norm_cuda.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 3 + tail
        L.adaln_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + tail
        L.fused_adaln_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        L.layer_norm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        L.fused_adaln_cuda.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + tail
        L.layer_norm_cuda.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 3 + [ctypes.c_longlong] + tail
        self.lib, self.plans = L, {}

    def plan(self, fn, n, *args):
        if (fn, args) not in self.plans:
            arr = (ctypes.c_int * n)()
            assert getattr(self.lib, fn)(*args, arr) == 0, (self.tag, fn, args)
            self.plans[(fn, args)] = arr
        return self.plans[(fn, args)]

    def rms(self, torch, x, w, eps=1e-5):
        y = torch.empty_like(x)
        rows, h = x.numel() // x.shape[-1], x.shape[-1]
        arr = self.plan("rms_norm_plan", 5, rows, h, 1, 1)
        err = self.lib.rms_norm_cuda(x.data_ptr(), w.data_ptr(), 0, y.data_ptr(), 1, rows, h,
                                     eps, arr, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, (self.tag, err)
        return y

    def adaln(self, torch, x, scale, shift, eps=1e-5):
        b, s, h = x.shape
        y = torch.empty_like(x)
        arr = self.plan("adaln_plan", 6, b, s, h, 1)
        err = self.lib.adaln_cuda(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), 1,
                                  y.data_ptr(), b, s, h, scale.stride(0), shift.stride(0), eps,
                                  arr, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, (self.tag, err)
        return y

    def fused(self, torch, res, x, gate, scale, shift, eps=1e-5):
        b, s, h = x.shape
        y, resi = torch.empty_like(x), torch.empty_like(x)
        arr = self.plan("fused_adaln_plan", 8, b, s, h, 1)
        err = self.lib.fused_adaln_cuda(res.data_ptr(), x.data_ptr(), gate.data_ptr(),
                                        scale.data_ptr(), shift.data_ptr(), 1, y.data_ptr(),
                                        resi.data_ptr(), b, s, h, gate.stride(0), scale.stride(0),
                                        shift.stride(0), eps, arr, 0,
                                        torch.cuda.current_stream().cuda_stream)
        assert err == 0, (self.tag, err)
        return y, resi

    def ln(self, torch, x, w, b, eps=1e-5):
        h = x.shape[-1]
        rows = x.numel() // h
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        arr = self.plan("layer_norm_plan", 8, rows, h, 1, 1)
        err = self.lib.layer_norm_cuda(x.data_ptr(), w.data_ptr(), b.data_ptr(), 0, y.data_ptr(),
                                       1, rows, h, x.stride(0), eps, arr, 0,
                                       torch.cuda.current_stream().cuda_stream)
        assert err == 0, (self.tag, err)
        return y

    def ptxas(self):
        rep = self.log.splitlines()
        for i, line in enumerate(rep):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m and re.search(r"rms_norm_fwd|adaln_|layer_norm_fwd", m.group(1)):
                name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
                info = " ".join(x.split(":", 1)[-1].strip() for x in rep[i + 1:i + 4]
                                if "registers" in x or "spill" in x)
                print(f"[{self.tag}] {name[:64]} | {info}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="JSON {tag: [[old, new], ...]} of edits to csrc/norms.cu")
    ap.add_argument("--kernels", default="rms,adaln,fused,ln",
                    help="comma-separated of rms (B11), adaln (B12), fused (B13), ln (B10)")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    import torch

    import chip_smoke as cs
    from paddlemix_tpu_torch.ops import norms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = os.path.join(REPO, "paddlemix_tpu_torch", "csrc", "norms.cu")
    sources = [("this", src)]
    if args.variants:
        text = open(src).read()
        for tag, edits in json.load(open(args.variants)).items():
            edited = text
            for old, new in edits:
                assert old in edited, f"{tag}: {old[:60]!r} not in csrc/norms.cu"
                edited = edited.replace(old, new)
            os.makedirs(OUT, exist_ok=True)
            path = os.path.join(OUT, f"{tag}.cu")
            open(path, "w").write(edited)
            sources.append((tag, path))
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda ts: Build(*ts), sources))
    for b in builds:
        b.ptxas()
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rounds(cases):
        """{tag: [ms, ms]}: each case timed in two rounds, forward then reversed."""
        out = {}
        for order in (cases, cases[::-1]):
            for tag, kernel in order:
                out.setdefault(tag, []).append(cs.cuda_ms(torch, kernel))
        return out

    def show(label, res, plan, copies, x, floor_shape):
        """x: the rows read (a tensor or a tuple), copied as a yardstick."""
        floor = cs.cuda_ms(torch, lambda: norms.empty_launch(*floor_shape), iters=copies)
        copy = cs.cuda_ms(torch, cs.cold(lambda t: [torch.empty_like(u).copy_(u) for u in t],
                                         x, cs.nbytes(*x)))
        print(f"{label}: " + " | ".join(f"{t} {min(v):.4f}/{max(v):.4f}" for t, v in res.items())
              + f" | copy_ {copy:.4f} | floor {floor:.4f} ({floor_shape[0]} x {floor_shape[1]}, "
              f"{copies} launches) | {plan}", flush=True)

    for rows, h in RMS_SHAPES if "rms" in kinds else ():
        x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(bf16)
        w = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
        ref = norms.rms_norm_ref(x.float(), w, 1e-5)
        for b in builds:
            ok = cs.ulp_gate(b.rms(torch, x, w), ref, cs.RMS_SUM)[0] <= 0
            assert ok or b.tag.startswith("diag_"), (b.tag, rows)
        cases = [("triton", cs.cold(lambda x_: triton_rms(torch, x_, w), x, cs.nbytes(x)))] + \
            [(b.tag, cs.cold(lambda x_, b=b: b.rms(torch, x_, w), x, cs.nbytes(x))) for b in builds]
        plan = norms.rms_norm_plan(rows, h, 2)
        show(f"rms_norm ({rows},{h})", rounds(cases), plan, cases[0][1].copies, (x,),
             (plan.blocks, plan.threads))
    for shape in ADALN_SHAPES if "adaln" in kinds else ():
        b_, s_, h_ = shape
        x = (2 * torch.randn(shape, generator=gen, device=dev)).to(bf16)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(bf16)
        shift, scale = mod.chunk(6, -1)[:2]
        ref = norms.adaptive_layer_norm_ref(x, scale, shift)
        for b in builds:
            ok = cs.ulp_gate(b.adaln(torch, x, scale, shift), ref, cs.ADALN_SUM)[0] <= 0
            assert ok or b.tag.startswith("diag_"), (b.tag, shape)
        cases = [("triton", cs.cold(lambda t: triton_adaln(torch, t, scale, shift), x,
                                    cs.nbytes(x)))] + \
            [(b.tag, cs.cold(lambda t, b=b: b.adaln(torch, t, scale, shift), x, cs.nbytes(x)))
             for b in builds]
        plan = norms.adaln_plan(*shape)
        show(f"adaptive_layer_norm {shape}", rounds(cases), plan, cases[0][1].copies, (x,),
             (b_ * plan.nb, plan.threads))
    for shape in ADALN_SHAPES if "fused" in kinds else ():
        b_, s_, h_ = shape
        rx = (2 * torch.randn((2,) + shape, generator=gen, device=dev)).to(bf16)
        mod = torch.randn((b_, 6 * h_), generator=gen, device=dev).to(bf16)
        shift, scale, gate = mod.chunk(6, -1)[:3]
        ref = norms.fused_adaln_scale_residual_ref(rx[0], rx[1], gate, scale, shift)
        for b in builds:
            out = b.fused(torch, rx[0], rx[1], gate, scale, shift)
            ok = max(cs.ulp_gate(o, r, cs.ADALN_SUM)[0] for o, r in zip(out, ref)) <= 0
            assert ok or b.tag.startswith("diag_"), (b.tag, shape)
        cases = [("triton", cs.cold(lambda t: triton_fused(torch, t[0], t[1], gate, scale, shift),
                                    rx, cs.nbytes(rx)))] + \
            [(b.tag, cs.cold(lambda t, b=b: b.fused(torch, t[0], t[1], gate, scale, shift), rx,
                             cs.nbytes(rx))) for b in builds]
        plan = norms.fused_adaln_plan(*shape)
        show(f"fused_adaln_scale_residual {shape}", rounds(cases), plan, cases[0][1].copies,
             (rx,), (b_ * plan.nb, plan.threads))
    for rows, h, span in LN_SHAPES if "ln" in kinds else ():
        x = (2 * torch.randn((rows, span, h), generator=gen, device=dev)).to(bf16)[:, 0]
        w = 1 + 0.2 * torch.randn(h, generator=gen, device=dev)
        bias = 0.2 * torch.randn(h, generator=gen, device=dev)
        ref = norms.layer_norm_ref(x.float(), w, bias, 1e-5)
        for b in builds:
            ok = cs.ulp_gate(b.ln(torch, x, w, bias), ref, cs.LN_SUM)[0] <= 0
            assert ok or b.tag.startswith("diag_"), (b.tag, rows, h)
        nb = rows * h * 2 * span
        cases = [("triton", cs.cold(lambda t: triton_ln(torch, t, w, bias), x, nb))] + \
            [(b.tag, cs.cold(lambda t, b=b: b.ln(torch, t, w, bias), x, nb)) for b in builds]
        plan = norms.layer_norm_plan(rows, h, 2)
        show(f"layer_norm ({rows},{h}){' row stride ' + str(span) if span > 1 else ''}",
             rounds(cases), plan, cases[0][1].copies, (x.contiguous(),), (plan.nb, plan.threads))

    def host(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3  # us a call

    x = (3 * torch.randn((1, 1, 4096), generator=gen, device=dev)).to(bf16)
    w = 1 + 0.1 * torch.randn(4096, generator=gen, device=dev)
    xa, ra = torch.randn((2, 2, 154, 1536), generator=gen, device=dev).to(bf16)
    sh, sc, gt = torch.randn((2, 6 * 1536), generator=gen, device=dev).to(bf16).chunk(6, -1)[:3]
    xl = torch.randn((77, 1280), generator=gen, device=dev).to(bf16)
    wl, bl = 1 + 0.1 * torch.randn(1280, generator=gen, device=dev), torch.zeros(1280, device=dev)
    calls = {"rms": ("rms_norm (1,4096)", lambda: norms.rms_norm(x, w, 1e-5),
                     lambda: triton_rms(torch, x, w)),
             "adaln": ("adaptive_layer_norm (2,154,1536)",
                       lambda: norms.adaptive_layer_norm(xa, sc, sh),
                       lambda: triton_adaln(torch, xa, sc, sh)),
             "fused": ("fused_adaln_scale_residual (2,154,1536)",
                       lambda: norms.fused_adaln_scale_residual(ra, xa, gt, sc, sh),
                       lambda: triton_fused(torch, ra, xa, gt, sc, sh)),
             "ln": ("layer_norm (77,1280)", lambda: norms.layer_norm(xl, wl, bl, 1e-5),
                    lambda: triton_ln(torch, xl, wl, bl))}
    for kind, (label, ours, theirs) in calls.items():
        if kind not in kinds:
            continue
        got = {"wrapper": [], "triton": []}
        for _ in range(5):
            got["wrapper"].append(host(ours))
            got["triton"].append(host(theirs))
        print(f"host us a call, {label}: " + " | ".join(
            f"{k} {' '.join(f'{v:.2f}' for v in sorted(vs))}" for k, vs in got.items()), flush=True)


if __name__ == "__main__":
    main()
