#!/usr/bin/env python3
"""Which form the int8 3x3 convs (B3, B5) take on the card: the port's, an
activation pass that quantizes x once into an int8 map and then an int8
implicit GEMM in the SS form of the wgmma core (csrc/int8_conv3x3.cu), or
B2's RS form, in which x stays bf16 and each consumer thread activates and
quantizes its A fragments of every tap in registers, with no int8 map
(tools/probe_torch_conv_forms.cu).

The RS form is built with nvcc into build/conv_forms/ (git-ignored) against
a copy of csrc/gemm_wg.cuh whose RS build is told its k block and pixel
tile, with an RS wgmma.m64n160k32 product generated beside it; it takes
128-pixel tiles by 160 columns, column tiles paired. At the smoke's UNet
shapes, both forms are held against the plain versions (bf16 ulps) and
timed in one call (the mean of 10 launches replayed from a CUDA graph,
chip_smoke.cuda_ms): the RS kernel alone (B5's affine table made beforehand,
untimed), the port's whole call at the RS form's tile and at its own plan,
and the port's parts (the activation pass; B5's GroupNorm statistics). The
card's name and power limit come first.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_conv_forms.py
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (B, H, W, C, O, kernel): B3 at the UNet's up-sample convs, B5 at its resnets
SHAPES = [(2, 64, 64, 1280, 1280, "B3"), (2, 128, 128, 640, 640, "B3"),
          (2, 128, 128, 320, 320, "B5"), (2, 32, 32, 1280, 1280, "B5"),
          (2, 64, 64, 640, 640, "B5")]
RS_TILE = ((160, 128),)  # the RS form's tile (columns, pixels), as a conv plan sees it


def _sub(text, old, new):
    if old not in text:
        raise SystemExit(f"probe_torch_conv_forms: the core no longer holds {old[:60]!r}")
    return text.replace(old, new)


def rs_core(core):
    """csrc/gemm_wg.cuh with the RS build told its k block and pixel tile."""
    for old, new in [
            ("void build_stage(uint32_t (&f)", "void build_stage(int kb, int outer, uint32_t (&f)"),
            ("S::build(f[s], st, s, p, th);", "S::build(f[s], st, s, p, th, kb, outer);"),
            ("build_stage<S>(nxt,", "build_stage<S>(kb + 1, outer, nxt,"),
            ("build_stage<S>(f[0],", "build_stage<S>(0, outer, f[0],"),
            ("void mainloop(typename S::Acc& acc,",
             "void mainloop(int outer, typename S::Acc& acc,"),
            ("mainloop<S>(acc, p, L, it, th);", "mainloop<S>(outer, acc, p, L, it, th);")]:
        core = _sub(core, old, new)
    return core


def rs_product(n=160):
    """wgmma.m64nNk32.s32.s8.s8 with A from registers, as an inline function."""
    r = n // 2
    regs = [f"%{i}" for i in range(r)]
    lines = "\n".join('      "' + ", ".join(regs[i:i + 16]) + ('"' if i + 16 >= r else ',"')
                      for i in range(0, r, 16))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_s8_rs_n{n}(int (&d)[{r}], "
            f"const uint32_t (&a)[4], uint64_t db, int accumulate) {{\n"
            f'  asm volatile(\n      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{"\n{lines}\n'
            f'      "}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));\n}}\n')


def build_rs():
    """The RS form's library, built into build/conv_forms/."""
    from paddlemix_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc

    csrc = os.path.join(ROOT, "paddlemix_tpu_torch", "csrc")
    out = os.path.join(ROOT, "build", "conv_forms")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, "gemm_wg.cuh")) as f:
        core = rs_core(f.read())
    files = {"gemm_wg.cuh": core, "rs160.inc": rs_product()}
    with open(os.path.join(ROOT, "tools", "probe_torch_conv_forms.cu")) as f:
        files["conv_rs.cu"] = f.read()
    for name, text in files.items():
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    lib = os.path.join(out, "libconv_rs.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", csrc, "-o", lib,
                           os.path.join(out, "conv_rs.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe_torch_conv_forms: nvcc failed:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if any(w in line for w in ("registers", "spill")):
            print("RS form ptxas:", line.strip())
    rs = ctypes.CDLL(lib)
    rs.conv_rs.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    rs.conv_rs.restype = ctypes.c_int
    return rs


def main():
    import torch
    import torch.nn.functional as F

    from chip_smoke import bf16_ulps, cuda_ms
    from paddlemix_tpu_torch.ops import conv_int8 as ci
    from paddlemix_tpu_torch.ops import fused_resnet as fr
    from paddlemix_tpu_torch.ops import gemm_tiles as gt
    from paddlemix_tpu_torch.ops import norms
    from paddlemix_tpu_torch.ops.quant import static_scale

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_conv_forms: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rs = build_rs()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, h, w, c, o, kind in SHAPES:
        x = torch.randn((b, h, w, c), generator=gen, device=dev).to(bf16)
        wq, sw = ci.quantize_weight_per_cout(
            torch.randn((o, c, 3, 3), generator=gen, device=dev) * (9 * c) ** -0.5)
        wq = ci.conv3x3_weight_layout(wq)
        bias = 0.1 * torch.randn(o, generator=gen, device=dev)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        fused = kind == "B5"
        sx = static_scale(4.0) if fused else static_scale(x.float().abs().max().item())
        plan = gt.conv_plan(b, h, w, c, o, gt.H100_CLUSTERS, RS_TILE, (True,))
        out = torch.empty((b, h, w, o), dtype=bf16, device=dev)
        cpad = plan.chunks * gt.BK
        aff = F.pad(fr.gn_affine(x, gamma, beta, 32, 1e-5), (0, cpad - c)) if fused else None

        def rs_conv():
            err = rs.conv_rs(x.data_ptr(), 0 if aff is None else aff.data_ptr(), wq.data_ptr(),
                             sw.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, o, sx,
                             1.0 / sx, plan.tw, plan.grid,
                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"probe_torch_conv_forms: conv_rs returned {err}")
            return out

        if fused:
            args = (x, gamma, beta, 32, 1e-5, wq, sw, sx, bias)
            ref = fr.fused_gn_silu_conv3x3_ref(*args)
            port = lambda: fr.fused_gn_silu_conv3x3(*args)  # noqa: E731
            port_at_rs_tile = lambda: fr._fused_cuda(*args, None, None, tiles=RS_TILE,  # noqa
                                                     pairings=(True,))
            stats = norms.group_norm_stats(x, 32, 1e-5)
            pass_ms = cuda_ms(torch, lambda: ci.conv3x3_act_quant(x, sx, stats, gamma, beta, 32))
            stats_ms = f"{cuda_ms(torch, lambda: norms.group_norm_stats(x, 32, 1e-5)):.4f}"
        else:
            ref = ci.int8_conv3x3_same_ref(x, wq, sw, sx, bias)
            port = lambda: ci.int8_conv3x3_same(x, wq, sw, sx, bias)  # noqa: E731
            port_at_rs_tile = lambda: ci._int8_conv3x3_cuda(x, wq, sw, sx, bias,  # noqa: E731
                                                            tiles=RS_TILE, pairings=(True,))
            pass_ms = cuda_ms(torch, lambda: ci.conv3x3_act_quant(x, sx))
            stats_ms = "none"
        ulps_rs = bf16_ulps(rs_conv(), ref)
        ulps_port = bf16_ulps(port(), ref)
        print(f"{kind} {(b, h, w, c, o)}: bf16 ulps RS {ulps_rs:.3g}, port {ulps_port:.3g} | RS "
              f"kernel at 160 x 128 {cuda_ms(torch, rs_conv):.4f} ms | port whole at 160 x 128 "
              f"{cuda_ms(torch, port_at_rs_tile):.4f} ms, at its plan "
              f"{cuda_ms(torch, port):.4f} ms | its activation pass {pass_ms:.4f} ms, "
              f"GroupNorm statistics {stats_ms} ms", flush=True)


if __name__ == "__main__":
    main()
