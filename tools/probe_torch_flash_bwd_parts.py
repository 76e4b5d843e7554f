#!/usr/bin/env python3
"""Where the time of B14 goes, in the PyTorch port: the flash backward's
dK/dV and dQ kernels (csrc/flash_bwd.cu, namespace `wg`) timed whole, with
one part of a tile's work taken out, and in the other form of a block split
by output.

Builds csrc/flash_bwd.cu as it is and in four variants, one nvcc each, in
parallel, under build/probe_flash_bwd/ (git-ignored): without the exp2 of
the elementwise step (p = s - lse), without a block split by rows' first two
products a tile (S and dP), without its last ones (dV and dK, or dQ), and
with the dK/dV kernel's split blocks (D 192 and 256) in their other form:
the warpgroup that sums dK computes S^T and P^T itself (three products a
tile to the other's two) instead of taking P^T through the exchange tile.
The first three variants compute wrong gradients and are timed only; the
last must give the kernel's gradients bit for bit. Each is timed at the
SD1.5 training path's head-40 and head-160 self-attentions (8, 4096, 8, 40)
and (8, 256, 8, 160), at (1, 1024, 4, 256), and at the LoRA SFT shape (2,
2048, 32, 128) causal with four segments a row, like `chip_smoke.py`: 10
launches captured in a CUDA graph, one replay timed by CUDA events, the
variants in turns (the kernel first and last). A part whose removal saves
little is hidden behind the others.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_flash_bwd_parts.py
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (variant, exact, [(text of csrc/flash_bwd.cu, its replacement), ...])
VARIANTS = [
    ("kernel", True, []),
    ("no exp2", False, [("float p = ex2(s[i] - l);", "float p = s[i] - l;"),
                        ("float p = ex2(s[i] - my_lse[r]);", "float p = s[i] - my_lse[r];")]),
    ("no S, dP", False, [
        ("      issue_rows_t<D, F::OWN>(acc_s, k_wg, ring.walk(0, s));\n"
         "      issue_rows_t<D, F::OWN>(acc_dp, v_wg, ring.walk(1, s));\n", ""),
        ("      issue_rows_t<D, F::OWN>(acc_s, q_wg, ring.walk(0, s));\n"
         "      issue_rows_t<D, F::OWN>(acc_dp, do_wg, ring.walk(1, s));\n", "")]),
    ("no dV dK / dQ", False, [
        ("      issue_acc<D>(acc_dv, pa, ring.walk(1, s));\n"
         "      issue_acc<D>(acc_dk, da, ring.walk(0, s));\n", ""),
        ("      issue_acc<D>(acc_dq, da, ring.walk(0, s));\n", "")]),
    ("dK wg S^T", True, [
        ("      if (sent++) named_sync(XCH_FREE0);  // warpgroup 1 has read the last tile's P^T\n"
         "      xch_put(xch, acc_s, tid);\n      named_arrive(XCH_FULL);\n", ""),
        ("    if (sent) named_sync(XCH_FREE0);  // the last tile's\n", ""),
        ("      zero(acc_dp);\n      wgmma_fence();\n"
         "      issue_rows_t<D, F::OWN>(acc_dp, v_wg, ring.walk(1, s));\n"
         "      wgmma_commit();\n      wgmma_wait<0>();\n      pin(acc_dp);\n"
         "      named_sync(XCH_FULL);\n",
         "      float acc_s[W / 2];\n      zero(acc_s);\n      zero(acc_dp);\n"
         "      wgmma_fence();\n"
         "      issue_rows_t<D, F::OWN>(acc_s, k_wg, ring.walk(0, s));\n"
         "      issue_rows_t<D, F::OWN>(acc_dp, v_wg, ring.walk(1, s));\n"
         "      wgmma_commit();\n      wgmma_wait<0>();\n      pin(acc_s);\n      pin(acc_dp);\n"
         "      probs_t<false>(acc_s, acc_s, st, st.hdr[3] == MASKED, causal, segs, key0, "
         "st.hdr[1], c0, my_seg, ds_scale);\n"),
        ("        const float4 p = xch_get(xch, j, tid);\n",
         "        const float4 p = make_float4(acc_s[4 * j], acc_s[4 * j + 1], acc_s[4 * j + 2], "
         "acc_s[4 * j + 3]);\n"),
        ("      named_arrive(XCH_FREE0);\n", "")]),
]
SHAPES = [(8, 4096, 8, 8, 40, False), (8, 256, 8, 8, 160, False), (1, 1024, 4, 4, 256, False),
          (2, 2048, 32, 32, 128, True)]


def build(name, exact, edits):
    """csrc/flash_bwd.cu with `edits` applied, built into its own library."""
    from paddlemix_tpu_torch.kernels import build as kb

    src = open(os.path.join(kb.CSRC, "flash_bwd.cu")).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} is not in csrc/flash_bwd.cu once")
        src = src.replace(old, new)
    tag = name.replace(" ", "_").replace("/", "")
    out_dir = os.path.join(REPO, "build", "probe_flash_bwd", tag)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "flash_bwd.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libflash_bwd.so")
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name!r} does not build:\n{proc.stderr}")
    fns = ctypes.CDLL(lib)
    dkv, dq = fns.flash_bwd_dkv_bf16, fns.flash_bwd_dq_bf16
    p, i, st = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    dkv.argtypes = [p] * 10 + [i] * 9 + [st, p]
    dq.argtypes = [p] * 9 + [i] * 9 + [st, ctypes.c_float, p]
    dkv.restype = dq.restype = i
    return dkv, dq


def main():
    import torch

    import chip_smoke as cs
    from paddlemix_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip([n for n, _, _ in VARIANTS], pool.map(lambda v: build(*v), VARIANTS)))
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    order = [n for n, _, _ in VARIANTS] + [n for n, _, _ in VARIANTS][::-1]
    for b, s, h, kvh, d, masked in SHAPES:
        q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16) for _ in range(2))
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        kw = {}
        if masked:
            seg = torch.ones((b, s), dtype=torch.int32, device=dev)
            for cut in cs.TRAIN_SEGMENT_CUTS:
                seg[:, int(cut * s):] += 1
            kw = dict(causal=True, segment_ids=attn.SegmentIds(seg, seg))
        scale = d ** -0.5
        qs = (q.float() * (scale * attn.LOG2E)).to(bf16)
        o, lse = attn.flash_fwd_lse(qs, k, v, **kw)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        times, first = {}, None
        for name in order:
            attn._flash_bwd_fns = lambda fns=libs[name]: fns
            if dict((n, e) for n, e, _ in VARIANTS)[name]:  # the kernel's gradients, bit for bit
                grads = (*attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw),
                         attn.flash_bwd_dq(qs, k, v, do, lse, di, scale=scale, **kw))
                first = first or grads
                if not all(torch.equal(a, b_) for a, b_ in zip(grads, first)):
                    raise SystemExit(f"variant {name!r} changes the gradients at {(b, s, d)}")
            dkv_ms = cs.cuda_ms(torch, lambda: attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw))
            dq_ms = cs.cuda_ms(torch, lambda: attn.flash_bwd_dq(qs, k, v, do, lse, di,
                                                                scale=scale, **kw))
            times.setdefault(name, []).append((dkv_ms, dq_ms))
        label = f"{(b, s, h, kvh, d)}{' causal + 4 segments' if masked else ''}"
        for name, runs in times.items():
            print(f"{label} {name:>14}: dkv {' / '.join(f'{r[0]:.3f}' for r in runs)} ms, "
                  f"dq {' / '.join(f'{r[1]:.3f}' for r in runs)} ms", flush=True)


if __name__ == "__main__":
    main()
