#!/usr/bin/env python3
"""Where the time of B1's int8 QK^T form and of the decode kernels B7 / B8
goes, by timing edited copies of their sources in one run on one CUDA card.

B1 int8 (csrc/flash_fwd.cu, the wgmma core at head_dim 64 and 128): the core
alone, on operands the activation pass made beforehand, as it is and with one
part changed: its S = Q8 K8^T product left out ("no S"), its dequantization
cut to one multiply by the row scale ("no dequant") or to the row scale
without the key scale ("no key scale"), and its int32 -> fp32 conversion done
on the FP32 pipe by adding to 1.5 * 2^23 ("fp32-pipe conversion"); beside
them the bf16 form (flash_attention) and the activation pass alone. Variants
that change the scores fail the plain version's gate; only their times are
read.

Decode attention (csrc/decode_attention.cu): B8 and B7 at chip_smoke.py's
shapes with 1, 2 (as built) or 4 warps a block, each at 8, 16, 33, 66 and 132
key ranges, the caches cold (passed through copies over three times the L2).

Each variant is an edited copy of the source built with kernels.build's nvcc
flags into the git-ignored build/int8_attn_parts/, and bound in place of the
wrapper's library for its timing. Prints the card's nvidia-smi name and power
limit, then one line a shape, each variant timed twice in turn.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_int8_attn_parts.py
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CSRC = os.path.join(REPO, "paddlemix_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "int8_attn_parts")
# the edits: (text of the source, its replacement)
DQ = ("s[4 * j + 2 * r] = __fmul_rn(__fmul_rn(__int2float_rn(s32[4 * j + 2 * r]), sq[r]), k2.x);",
      "s[4 * j + 2 * r + 1] =\n          __fmul_rn(__fmul_rn(__int2float_rn(s32[4 * j + 2 * r + 1]), "
      "sq[r]), k2.y);")


def dequant(first, second):
    return [(DQ[0], f"s[4 * j + 2 * r] = {first};"), (DQ[1], f"s[4 * j + 2 * r + 1] = {second};")]


FLASH_VARIANTS = {
    "no S": [("        issue_scores_i8<D, BN>(acc_i, q_wg, s_k + s * L::K_BYTES);", "        ;")],
    "no dequant": dequant("__int_as_float(s32[4 * j + 2 * r] & 0x3f7fffff) * sq[r]",
                          "__int_as_float(s32[4 * j + 2 * r + 1] & 0x3f7fffff) * sq[r]"),
    "no key scale": dequant("__int2float_rn(s32[4 * j + 2 * r]) * sq[r]",
                            "__int2float_rn(s32[4 * j + 2 * r + 1]) * sq[r]"),
    "fp32-pipe conversion": [(a, a.replace("__int2float_rn(s32[4 * j + 2 * r]", "__fsub_rn("
                                           "__int_as_float(0x4B400000 + s32[4 * j + 2 * r]), "
                                           "12582912.f").replace(
        "__int2float_rn(s32[4 * j + 2 * r + 1]", "__fsub_rn(__int_as_float(0x4B400000 + "
        "s32[4 * j + 2 * r + 1]), 12582912.f")) for a in DQ],
}
DECODE_WARPS = ("constexpr int WARPS = 2;", "constexpr int WARPS = {};")
FLASH_SHAPES = [(2, 4096, 10, 64), (2, 1024, 20, 64), (2, 1024, 8, 128)]
# (B, Hq, KVH, D, L, lengths, int8): chip_smoke.py's INT8_DECODE_CASES and DECODE_CASES
DECODE_CASES = [(1, 32, 32, 128, 4096, (4095,), True), (2, 32, 8, 128, 4096, (4000, 1500), True),
                (1, 32, 32, 128, 736, (609,), False), (2, 32, 8, 128, 4096, (4000, 1500), False),
                (1, 32, 32, 128, 4096, (4095,), False)]
SPLITS = (8, 16, 33, 66, 132)


def build(name, source, edits):
    from paddlemix_tpu_torch.kernels import build as kbuild

    text = open(os.path.join(CSRC, f"{source}.cu")).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"probe_torch_int8_attn_parts: {name}: the source has changed")
        text = text.replace(old, new)
    src = os.path.join(CSRC, f"_probe_{name.replace(' ', '_')}.cu")  # beside its headers
    out = os.path.join(OUT, f"lib{name.replace(' ', '_')}.so")
    with open(src, "w") as f:
        f.write(text)
    try:
        proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", out, src],
                              capture_output=True, text=True)
    finally:
        os.remove(src)
    if proc.returncode:
        raise SystemExit(f"probe_torch_int8_attn_parts: {name} failed to build:\n{proc.stderr}")
    return name, ctypes.CDLL(out)


def main():
    import torch

    import chip_smoke as cs
    from paddlemix_tpu_torch.kernels import load_library
    from paddlemix_tpu_torch.models.llama.modeling import _quantize_kv
    from paddlemix_tpu_torch.ops import attention as attn
    from paddlemix_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_int8_attn_parts: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    jobs = [(name, "flash_fwd", edits) for name, edits in FLASH_VARIANTS.items()]
    jobs += [(f"{w} warps", "decode_attention", [(DECODE_WARPS[0], DECODE_WARPS[1].format(w))])
             for w in (1, 4)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(lambda job: build(*job), jobs))
    libs["as built"] = load_library("flash_fwd")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int

    def core(lib):
        fn = lib.flash_fwd_int8qk_bf16
        fn.argtypes = [P] * 4 + [I] * 17 + [ctypes.c_float] + [I] * 2 + [P] * 2 + [I] * 2 + [P] * 5
        fn.restype = I
        return fn

    flash = ["as built"] + list(FLASH_VARIANTS)
    for shape in FLASH_SHAPES:
        b, s, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(3))
        scale_log2 = d ** -0.5 * attn.LOG2E
        ops = attn._quantize_qk_cuda(q, k, scale_log2)
        o = torch.empty_like(q)
        times = {}
        for _ in range(2):
            for name in flash:
                fn = core(libs[name])

                def run(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, s, s,
                             d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                             *o.stride()[:3], scale_log2, 1, 0, None, None, 0, 0,
                             *(t.data_ptr() for t in ops),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"probe_torch_int8_attn_parts: launch failed ({err})")
                times.setdefault(name, []).append(cs.cuda_ms(torch, run))
        bf16_ms = cs.cuda_ms(torch, lambda: attn.flash_attention(q, k, v, int8_qk=False))
        pass_ms = cs.cuda_ms(torch, lambda: attn.quantize_qk_int8(q, k, d ** -0.5))
        print(f"B1 int8 core alone {shape}: " + "; ".join(
            f"{n} {t[0]:.4f} / {t[1]:.4f} ms" for n, t in times.items())
            + f" | bf16 form {bf16_ms:.4f} ms | activation pass {pass_ms:.4f} ms", flush=True)

    def decode_fns(lib):
        f8, f16 = lib.decode_attention_int8, lib.decode_attention_bf16
        f8.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_longlong] * 12 + [ctypes.c_float, P]
        f16.argtypes = [P] * 6 + [I] * 7 + [ctypes.c_longlong] * 6 + [ctypes.c_float, P]
        f8.restype = f16.restype = I
        return f8, f16

    warps = {1: libs["1 warps"], 2: load_library("decode_attention"), 4: libs["4 warps"]}
    saved = da._decode_int8_fn, da._decode_fn, da.key_splits
    for b, hq, kvh, d, L, lengths, int8 in DECODE_CASES:
        q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(bf16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if int8:
            cache = _quantize_kv(torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev))

            def call(c):
                return da.decode_attention_int8(q, c[0][0, :, :L], c[0][1, :, :L],
                                                c[1][0, :, :L], c[1][1, :, :L], lens)
        else:
            cache = torch.randn((2, b, L + 1, kvh, d), generator=gen, device=dev).to(bf16)

            def call(c):
                return da.decode_attention(q, c[0, :, :L], c[1, :, :L], lens)
        fn = cs.cold(call, cache, cs.nbytes(*cache) if int8 else cs.nbytes(cache))
        cells = []
        try:
            for w, lib in warps.items():
                f8, f16 = decode_fns(lib)
                da._decode_int8_fn, da._decode_fn = (lambda f=f8: f), (lambda f=f16: f)
                for n in SPLITS:
                    da.key_splits = lambda bb, kk, ll, sms=132, n=n: (n, -(-ll // n))
                    cells.append(f"{w} warps x {n} {cs.cuda_ms(torch, fn):.4f}")
        finally:
            da._decode_int8_fn, da._decode_fn, da.key_splits = saved
        plan = da.key_splits(b, kvh, L)[0]
        print(f"{'B8' if int8 else 'B7'} {(b, hq, kvh, d, L, lengths)} (the plan: 2 warps x {plan}),"
              f" ms: " + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
