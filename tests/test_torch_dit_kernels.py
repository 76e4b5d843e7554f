"""The DiT and PixArt paths' kernel shapes on a CUDA card: B1 at head 72 on
q / k / v that are strided views of a fused projection (DiT's serving
shape, PixArt's), B15 and B14 at DiT's training batch, B12 at DiT's rows and
B11 at T5's caption rows, against their plain versions. No JAX here, so that
the tests run where only the port is installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_dit_kernels.py
"""

import pytest
import torch

from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.ops import norms as tnorms

pytestmark = pytest.mark.torch_port


@pytest.mark.gpu
def test_dit_kernels_match_plain_versions_on_gpu():
    """B1 at DiT's serving shape (16, 256, 16, 72) and PixArt's (2, 1024, 16,
    72), B15 and B14 at the training shape (16, 256, 16, 72), head 72 read in
    place on the D 128 core, against their plain versions (the smoke's gate,
    c 4e-3); B12 at DiT's rows (16, 256, 1152) per element (bf16 ulps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def gate(out, ref, c=4e-3):
        ref = ref.float()
        return bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs()
                     + c * ref.abs().max()).all())

    for shape in ((16, 256, 16, 72), (2, 1024, 16, 72)):
        qkv = torch.randn(shape[:2] + (3 * shape[2], 72), generator=gen, device=dev).to(bf16)
        q, k, v = qkv.split(shape[2], dim=2)
        out = tattn.flash_attention(q, k, v)
        assert gate(out, tattn.flash_attention_ref(q.float(), k.float(), v.float()))
    b, s, h, d = 16, 256, 16, 72
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    scale = d ** -0.5
    qs = (q.float() * scale * tattn.LOG2E).to(bf16)
    o, lse = tattn.flash_fwd_lse(qs, k, v)
    f32 = (qs.float(), k.float(), v.float(), do.float())
    ro, rlse = tattn.flash_fwd_lse_ref(*f32[:3])
    assert gate(o, ro)
    di = (ro * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tattn.flash_bwd_dkv(qs, k, v, do, rlse, di)
    dq = tattn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale)
    rdk, rdv = tattn.flash_bwd_dkv_ref(*f32, rlse, di)
    rdq = tattn.flash_bwd_dq_ref(*f32, rlse, di, scale=scale)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert gate(got, ref)
    x = torch.randn((16, 256, 1152), generator=gen, device=dev).to(bf16)
    mod = torch.randn((16, 6 * 1152), generator=gen, device=dev).to(bf16)
    shift, scale_ = mod[:, :1152], mod[:, 1152:2304]
    y = tnorms.adaptive_layer_norm(x, scale_, shift)
    ref = tnorms.adaptive_layer_norm_ref(x.float(), scale_.float(), shift.float())
    assert (y.float() - ref).abs().max() <= 2.0 ** -7 * ref.abs().max()


@pytest.mark.gpu
def test_pixart_kernels_match_plain_versions_on_gpu():
    """B11 at T5-XXL's caption rows (120, 4096) per element against its
    plain version (the fp32-weight form T5's norms run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 120, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")
    out = tnorms.rms_norm(x, w, 1e-6)
    ref = tnorms.rms_norm_ref(x, w, 1e-6)
    assert (out.float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max()
