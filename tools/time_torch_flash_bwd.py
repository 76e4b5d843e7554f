#!/usr/bin/env python3
"""B14's device time in the PyTorch port, one checkout against another in
one call: the flash backward's dK/dV and dQ kernels (`flash_bwd_dkv`,
`flash_bwd_dq`, csrc/flash_bwd.cu) at the shapes the paths and chip_smoke.py
run them, each timed as chip_smoke.py times a kernel (10 launches captured in
a CUDA graph, one replay between CUDA events), plus SDPA's backward as the
yardstick. The package is imported from the tree given (default: this
checkout), whose kernels build into that tree's own build/ directory, so the
parent commit unpacked into a git-ignored directory can be timed beside this
one:

    git archive HEAD~1 | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 tools/time_torch_flash_bwd.py --tree $t; done

Prints one line a shape: the tree, the card and its power limit, and the
times in ms.
"""

import argparse
import os
import subprocess
import sys

# (B, S, Hq, Hkv, head_dim, causal with 4 segments a row)
SHAPES = [(1, 1024, 4, 4, 256, False), (8, 256, 8, 8, 160, False), (2, 512, 8, 2, 160, True),
          (1, 512, 4, 2, 256, True), (4, 1024, 8, 8, 32, False), (2, 2048, 32, 32, 128, True),
          (1, 2048, 32, 8, 128, True), (8, 1024, 8, 8, 80, False), (8, 4096, 8, 8, 40, False)]
SEGMENT_CUTS = (0.31, 0.58, 0.86)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddlemix_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    assert os.path.dirname(os.path.abspath(attn.__file__)).startswith(tree), attn.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, h, kvh, d, masked in SHAPES:
        q, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16) for _ in range(2))
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        kw = {}
        if masked:
            seg = torch.ones((b, s), dtype=torch.int32, device=dev)
            for cut in SEGMENT_CUTS:
                seg[:, int(cut * s):] += 1
            kw = dict(causal=True, segment_ids=attn.SegmentIds(seg, seg))
        scale = d ** -0.5
        qs = (q.float() * (scale * attn.LOG2E)).to(bf16)
        o, lse = attn.flash_fwd_lse(qs, k, v, **kw)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dkv = cs.cuda_ms(torch, lambda: attn.flash_bwd_dkv(qs, k, v, do, lse, di, **kw))
        dq = cs.cuda_ms(torch, lambda: attn.flash_bwd_dq(qs, k, v, do, lse, di, scale=scale,
                                                         **kw))
        sdpa = cs.backward_ms(torch, lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=masked, enable_gqa=h != kvh),
            tuple(t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)),
            do.transpose(1, 2))
        label = f"{(b, s, h, kvh, d)}{' causal + 4 segments' if masked else ''}"
        print(f"{tree} | {smi} | {label}: dkv {dkv:.4f} ms, dq {dq:.4f} ms, sum "
              f"{dkv + dq:.4f} ms; SDPA's backward {sdpa:.4f} ms", flush=True)
        del q, do, k, v, qs, o, lse, di
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
