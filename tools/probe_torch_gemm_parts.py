#!/usr/bin/env python3
"""What holds back the int8 GEMMs (B2, csrc/int8_gemm.cu) and the wint8
GEMM's tiled path (B6, csrc/wint8_gemm.cu): each kernel whole, then with one
part of its work taken out, timed in turns on one card.

Copies of the sources are edited and built with nvcc into
build/gemm_parts/<variant>/ (git-ignored), each with the library's C
interface, and launched at the smoke's prefill shapes with the plan that
ops/gemm_tiles.py picks:
  whole        the kernel as it is;
  no_convert   B2 without quantizing x (the bf16 bits go to the products as
               they are), B6 without widening the weight (its int8 bytes);
  no_epilogue  B2 / B6 without the epilogue's conversion, staging and store:
               the accumulators are only summed, so that the products stay
               (ptxas drops a wgmma whose results nobody reads);
  loads_only   neither products nor conversion nor epilogue: the TMA ring
               and its barriers alone.
A variant computes garbage: only its time means anything. Each time is the
mean of 20 launches replayed from a CUDA graph (CUDA events), as
chip_smoke.py times kernels; the variants are timed in order, then in the
reverse order, and both times are printed, with the card's name and power
limit.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_gemm_parts.py
"""

import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B2_SHAPES = [(8192, 640, 5120), (2048, 1280, 10240), (2048, 5120, 1280)]
B6_SHAPES = [(608, 4096, 11008), (608, 11008, 4096), (608, 4096, 4096)]


def _sub(text, old, new):
    if old not in text:
        raise SystemExit(f"probe_torch_gemm_parts: the source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _renamed(text, head, new_body, old_name):
    """`text` with the function that `head` opens answering `new_body`; its
    old body stays, renamed `old_name`."""
    stub = head.replace("{", "{\n" + new_body + "\n}\n")
    return _sub(text, head, stub + "__device__ __forceinline__ uint32_t " + old_name
                + head[head.index("("):])


def variants(csrc):
    """{name: (source file, edited text)}."""
    b2 = open(os.path.join(csrc, "int8_gemm.cu")).read()
    b6 = open(os.path.join(csrc, "wint8_gemm.cu")).read()
    b2_mma = "    wgmma_s8<BN>(acc, a, smem_desc_sw64(st + X_BYTES + 32 * s), accumulate);"
    b6_mma = "    wgmma_bf16<TN>(acc, a, smem_desc(st + 32 * s, 16, 1024), accumulate);"
    b2_epi = "    const uint32_t cols = out + TILE_BYTES;"
    b6_epi = "    const float s0 = pre.s0, s1 = pre.s1;"
    b2_store, b6_store = "      tma_store_2d(&p.out,", "    tma_store_2d(&p.out,"
    no_store = ("      if (0) tma_store_2d(&p.out,", "    if (0) tma_store_2d(&p.out,")
    # the accumulators summed and left, so that the products stay
    keep = ("    {} sum = 0;\n#pragma unroll\n"
            "    for (int i = 0; i < {} / 2; ++i) sum += acc[i];\n"
            "    if (sum == 12345)\n"
            "      asm volatile(\"st.shared.b32 [%0], %1;\" :: \"r\"(out),\n"
            "                   \"r\"(*reinterpret_cast<uint32_t*>(&sum)) : \"memory\");\n"
            "    return;\n")
    b2_noepi = _sub(_sub(b2, b2_epi, keep.format("int", "BN") + b2_epi), b2_store, no_store[0])
    b6_noepi = _sub(_sub(b6, b6_epi, keep.format("float", "TN") + b6_epi), b6_store, no_store[1])
    # the loads alone: no products and no conversion, the epilogue's work gone too
    b2_loads = _sub(_sub(b2, b2_epi, "    return;\n" + b2_epi), b2_store, no_store[0])
    b6_loads = _sub(_sub(b6, b6_epi, "    return;\n" + b6_epi), b6_store, no_store[1])
    b2_loads = _sub(_sub(b2_loads, b2_mma, ""), "    a[0] = quantize4(lds64(row + lo), p.inv_sx);",
                    "    a[0] = 0;\n    return;")
    b6_loads = _sub(_sub(b6_loads, b6_mma, ""), "    a[0] = widen2(lds32(row), sel);",
                    "    a[0] = 0;\n    return;")
    quantize = "__device__ __forceinline__ uint32_t quantize4(uint2 v, float inv_sx) {"
    widen = "__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel) {"
    stub_q, stub_w = "  (void)inv_sx;\n  return v.x ^ v.y;", "  (void)sel;\n  return w;"
    return {
        "b2 whole": ("int8_gemm", b2),
        "b2 no_convert": ("int8_gemm", _renamed(b2, quantize, stub_q, "unused4")),
        "b2 no_epilogue": ("int8_gemm", b2_noepi),
        "b2 loads_only": ("int8_gemm", b2_loads),
        "b6 whole": ("wint8_gemm", b6),
        "b6 no_convert": ("wint8_gemm", _renamed(b6, widen, stub_w, "unused2")),
        "b6 no_epilogue": ("wint8_gemm", b6_noepi),
        "b6 loads_only": ("wint8_gemm", b6_loads),
    }


def build(csrc, out_root, name, source, text):
    from paddlemix_tpu_torch.kernels import build as kbuild

    d = os.path.join(out_root, name.replace(" ", "_"))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, f"{source}.cu"), "w") as fh:
        fh.write(text)
    lib = os.path.join(d, "lib.so")
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return name, ctypes.CDLL(lib)


def cuda_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    from paddlemix_tpu_torch.ops import conv_int8, gemm_tiles, quant

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_gemm_parts: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(repo, "paddlemix_tpu_torch", "csrc")
    out_root = os.path.join(repo, "build", "gemm_parts")
    todo = variants(csrc)
    with ThreadPoolExecutor(len(todo)) as pool:
        libs = dict(pool.map(lambda kv: build(csrc, out_root, kv[0], *kv[1]), todo.items()))
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def stream():  # the capture stream while the graph is captured
        return torch.cuda.current_stream().cuda_stream

    def in_turns(names, time):
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(time(name))
        return ", ".join(f"{name[3:]} {a:.4f} / {b:.4f} ms" for name, (a, b) in times.items())
    clusters = gemm_tiles.max_clusters("int8_gemm", "int8_gemm_max_clusters",
                                       gemm_tiles.A8W8_TILES, 0)
    for m, k, n in B2_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wq, sw = conv_int8.quantize_weight_per_cout(torch.randn((n, k), generator=gen, device=dev))
        bias = torch.randn(n, generator=gen, device=dev)
        out = torch.empty((m, n), dtype=bf16, device=dev)
        sx = x.float().abs().max().item() / 127
        plan = gemm_tiles.a8w8_plan(m, n, k, clusters)

        def time_b2(name):
            fn = libs[name].int8_gemm_bf16
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 \
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            return cuda_ms(torch, lambda: fn(
                x.data_ptr(), wq.data_ptr(), sw.data_ptr(), bias.data_ptr(), out.data_ptr(), m,
                n, k, sx, 1 / sx, plan.tile, plan.grid, stream()))
        print(f"B2 {(m, k, n)} tile {plan.tile}: "
              + in_turns([v for v in libs if v.startswith("b2")], time_b2), flush=True)
    clusters = gemm_tiles.max_clusters("wint8_gemm", "wint8_gemm_max_clusters",
                                       gemm_tiles.WINT8_TILES, 0)
    for m, k, n in B6_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        wq, scale = quant.quantize_weights_int8(torch.randn((n, k), generator=gen, device=dev))
        out = torch.empty((m, n), dtype=bf16, device=dev)
        plan = gemm_tiles.wint8_plan(m, n, k, clusters)

        def time_b6(name):
            fn = libs[name].wint8_gemm_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            return cuda_ms(torch, lambda: fn(
                x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
                plan.tile, plan.grid, stream()))
        print(f"B6 {(m, k, n)} tile {plan.tile}: "
              + in_turns([v for v in libs if v.startswith("b6")], time_b6), flush=True)


if __name__ == "__main__":
    main()
