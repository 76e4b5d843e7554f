"""The SD3 training path's kernels on a CUDA card: B15 and B14 at the joint
attention of a training batch, (2, 4250, 24, 64), against their plain
versions, and B12 / B13's gradients at SD3's rows against autograd of their
plain versions. No JAX here, so that the test runs where only the port is
installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sd3_train_kernels.py
"""

import pytest
import torch

pytestmark = pytest.mark.torch_port


def _gate(out, ref, c):
    """|out - ref| <= 2**-7 |ref| + c |ref|max: one bf16 rounding of the
    output and P's rounding (chip_smoke.py's flash gate)."""
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.gpu
def test_sd3_training_kernels_match_plain_versions_on_gpu():
    """B15 and B14 at the joint attention's training shape (2, 4250, 24, 64),
    non-causal, its ragged 26-key tail, against their plain versions (c 4e-3),
    the plain version without the last key tile failing the forward's gate;
    B12 and B13's gradients (autograd of their plain versions, as in JAX) at
    SD3's image and context rows against autograd of the plain versions
    themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    from paddlemix_tpu_torch.ops import attention as tattn
    from paddlemix_tpu_torch.ops import norms as tnorms

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, d = 2, 4250, 24, 64
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    scale = d ** -0.5
    qs = (q.float() * scale * tattn.LOG2E).to(bf16)
    o, lse = tattn.flash_fwd_lse(qs, k, v)
    f32 = (qs.float(), k.float(), v.float(), do.float())
    ro, rlse = tattn.flash_fwd_lse_ref(*f32[:3])
    assert _gate(o, ro, 4e-3)
    cut = (s - 1) // 128 * 128  # the last key tile left out
    short, _ = tattn.flash_fwd_lse_ref(f32[0], f32[1][:, :cut], f32[2][:, :cut])
    assert not _gate(short, ro, 4e-3)
    di = (ro * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tattn.flash_bwd_dkv(qs, k, v, do, rlse, di)
    dq = tattn.flash_bwd_dq(qs, k, v, do, rlse, di, scale=scale)
    rdk, rdv = tattn.flash_bwd_dkv_ref(*f32, rlse, di)
    rdq = tattn.flash_bwd_dq_ref(*f32, rlse, di, scale=scale)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _gate(got, ref, 4e-3)
    for rows in (4096, 154):
        x, res = (torch.randn((2, rows, 1536), generator=gen, device=dev).to(bf16)
                  .requires_grad_() for _ in range(2))
        mod = torch.randn((2, 3, 1536), generator=gen, device=dev).to(bf16).requires_grad_()
        g = torch.randn((2, rows, 1536), generator=gen, device=dev).to(bf16)
        for fn, ref_fn, args in (
                (tnorms.adaptive_layer_norm, tnorms.adaptive_layer_norm_ref,
                 lambda: (x, mod[:, 0], mod[:, 1])),
                (tnorms.fused_adaln_scale_residual, tnorms.fused_adaln_scale_residual_ref,
                 lambda: (res, x, mod[:, 2], mod[:, 0], mod[:, 1]))):
            launches = fn.launches
            outs = [fn(*args()), ref_fn(*args())]
            assert fn.launches == launches + 1
            grads = []
            for out in outs:
                out = out[0] if isinstance(out, tuple) else out
                grads.append(torch.autograd.grad(out, (x, mod), g))
            for got, ref in zip(*grads):
                torch.testing.assert_close(got, ref, rtol=0, atol=0)
