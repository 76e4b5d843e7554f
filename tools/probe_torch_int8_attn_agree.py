#!/usr/bin/env python3
"""How far one full-width SDXL UNet forward moves when B1's int8 QK^T kernel
is replaced by its plain version, in the PyTorch port.

Builds the SDXL pipeline of `chip_smoke.py` (seeded random weights, bf16,
static a8w8), records and loads its scales, and runs the UNet once at the
calibration-like 32 x 32 latents of `chip_smoke.py`'s a8w8 agree with
PMIX_INT8_ATTN=1, in these variants: the kernel (twice); the plain version
`flash_attention_int8_ref`; the plain version with P left in fp32 (one bf16
rounding away from it); the plain version quantizing by truncation (the
control of the int8 checks); and, with bf16 QK^T, B1 and its plain version.
Prints the relative L2 between the pairs, on the a8w8 UNet and on the same
UNet before its scales are loaded (the bf16 path). Then runs the a8w8 UNet
once at the request's 1024 px with every int8 attention call held per
element against the plain version on its own inputs (the check
`chip_smoke.py` makes), and prints the least c of the kernel and of the
truncation control at each shape.

Usage (from the root of a checkout, on a machine with a CUDA card):
    python3 tools/probe_torch_int8_attn_agree.py
"""

import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke as cs
    from paddlemix_tpu_torch.diffusers.models import resnet
    from paddlemix_tpu_torch.diffusers.sdxl import calibrate_static_a8w8, random_sdxl_pipeline
    from paddlemix_tpu_torch.kernels import build_all
    from paddlemix_tpu_torch.ops import attention, conv_int8, fused_resnet, norms, quant

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_int8_attn_agree: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    m = types.SimpleNamespace(attn=attention, resnet=resnet, norms=norms, quant=quant,
                              conv_int8=conv_int8, fused=fused_resnet)
    build_all(["flash_fwd", "int8_gemm", "int8_conv3x3"])
    pipe = random_sdxl_pipeline(dev, bf16, seed=0, quant="a8w8_static")
    with torch.inference_mode():
        ctx, added, lat = pipe.prepare_inputs(cs.REQUESTS[0][0], 256, 256, cs.GUIDANCE, seed=0)
    t = pipe.scheduler.set_timesteps(cs.STEPS).timesteps[0].to(dev).expand(2)
    lat = torch.cat([lat, lat]).to(bf16)

    def unet(swaps=(), int8_attn=True):
        os.environ["PMIX_INT8_ATTN"] = "1" if int8_attn else "0"
        try:
            with torch.inference_mode(), cs.swapped(swaps):
                return pipe.unet(lat, t, ctx, added_cond_kwargs=added).float()
        finally:
            del os.environ["PMIX_INT8_ATTN"]

    def unrounded(q, k, v, *, scale=None, causal=False, segment_ids=None):
        """`flash_attention_int8_ref` with P kept in fp32 for P.V."""
        q8, k8, sq, sk = attention.int8_qk_operands(q, k, q.shape[3] ** -0.5 if scale is None
                                                    else scale)
        s = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8.float())
        s = s * sq.transpose(1, 2)[..., None] * sk.transpose(1, 2)[:, :, None, :]
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)

    plain = [(attention, "flash_attention_int8", attention.flash_attention_int8_ref)]
    variants = {
        "int8 kernel": [],
        "int8 plain": plain,
        "int8 plain, P fp32": [(attention, "flash_attention_int8", unrounded)],
        "int8 plain, truncation": plain + [(attention, "quantize_rows_int8",
                                            cs.truncating_quantize(torch))],
    }
    pairs = [("int8 kernel", "int8 kernel (again)"), ("int8 kernel", "int8 plain"),
             ("int8 plain, P fp32", "int8 plain"), ("int8 plain, truncation", "int8 plain"),
             ("bf16 B1", "bf16 plain"), ("int8 kernel", "bf16 B1")]
    for label in ("bf16 UNet", "a8w8 UNet"):
        if label == "a8w8 UNet":
            calibrate_static_a8w8(pipe, cs.REQUESTS[0][0], cs.HEIGHT, cs.WIDTH, cs.STEPS,
                                  cs.GUIDANCE, seed=0)
        outs = {name: unet(swaps) for name, swaps in variants.items()}
        outs["int8 kernel (again)"] = unet()
        outs["bf16 B1"] = unet(int8_attn=False)
        outs["bf16 plain"] = unet(cs.plain_swaps(m, int8=False)[:1], int8_attn=False)
        for a, b in pairs:
            print(f"[{label}] {a} vs {b}: relative L2 {cs.rel_l2(outs[a], outs[b]):.3e}",
                  flush=True)
    # what chip_smoke.py gates instead: each int8 call of a full-size forward
    # per element against the plain version on its own inputs
    with torch.inference_mode():
        ctx, added, lat = pipe.prepare_inputs(cs.REQUESTS[0][0], cs.HEIGHT, cs.WIDTH,
                                              cs.GUIDANCE, seed=cs.REQUESTS[0][1])
    lat = torch.cat([lat, lat]).to(bf16)
    with cs.checked_int8_calls(torch, attention, cs.INT8_ATTN_PATH_SUM) as calls:
        unet()
    for shape in sorted(set(r[0] for r in calls)):
        rows = [r for r in calls if r[0] == shape]
        print(f"[a8w8 UNet, {cs.HEIGHT} px] {len(rows)} int8 calls at {shape}: least c "
              f"{max(r[2] for r in rows):.2e} (gate {cs.INT8_ATTN_PATH_SUM:g}); truncation control "
              f"least c {min(r[4] for r in rows):.2e} .. {max(r[4] for r in rows):.2e}",
              flush=True)


if __name__ == "__main__":
    main()
