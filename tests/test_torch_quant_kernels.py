"""N1 and N2, the dynamic a8w8 and a8w4 GEMMs of csrc/a8w_gemm.cu
(paddlemix_tpu_torch.ops.quant `a8w8_matmul`, `a8w4_matmul`), against their
plain versions on a CUDA card: bit for bit at LLaVA's decode shapes (the
GEMV), a prefill shape and ragged shapes (the activation pass and the tiled
path, at each compiled tile), each with a control that must differ (N1: each
row quantized with its neighbour's sx; N2: the nibble halves swapped); the
activation pass alone; the tile plans against the library's answer; N2's
refusal of packed rows of no whole 16 bytes. Skips where there is no card.
No JAX here:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_quant_kernels.py
"""

import pytest
import torch

from chip_smoke import neighbour_sx_control, swapped_halves_control
from paddlemix_tpu_torch.ops import gemm_tiles as gt
from paddlemix_tpu_torch.ops import quant as tquant

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]

# (M, K, N): the decode's q/k/v/o, gate/up, down and lm_head rows; the
# prefill's gate/up; ragged M, N = 8 mod 16 and K no multiple of a stage
SHAPES = {"a8w8": [(1, 4096, 4096), (1, 4096, 11008), (1, 11008, 4096), (1, 4096, 32000),
                   (608, 4096, 11008), (77, 4112, 4104), (3, 1008, 200)],
          "a8w4": [(1, 4096, 4096), (1, 4096, 11008), (1, 11008, 4096), (1, 4096, 32000),
                   (608, 4096, 11008), (77, 4128, 4104), (3, 1024, 200)]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("kind", ["a8w8", "a8w4"])
def test_kernel_matches_plain_version_bit_for_bit(cuda, kind):
    gen, bf16 = cuda, torch.bfloat16
    wrapper = tquant.a8w4_matmul if kind == "a8w4" else tquant.a8w8_matmul
    plain = tquant.a8w4_matmul_ref if kind == "a8w4" else tquant.a8w8_matmul_ref
    quantizer = tquant.quantize_weights_int4 if kind == "a8w4" else tquant.quantize_weights_int8
    for m, k, n in SHAPES[kind]:
        x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
        if m > 2:
            x[1] = 0  # a zero row
        wq, scale = quantizer(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
        ref = plain(x, wq, scale)
        before = wrapper.launches
        out = wrapper(x, wq, scale)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(out, ref), (kind, m, k, n)
        if m > 1:  # every compiled tile, and the plan the library answers
            for tile in (256, 128):
                assert torch.equal(tquant._a8w_cuda(kind, x, wq, scale, tiles=(tile,)), ref)
                plan = tquant.a8w_tile_plan(kind, m, n, k, 0, (tile,))
                assert gt.a8w_plan_fields(plan) == tquant.a8w_library_plan(kind, m, n, k, tile)
        if kind == "a8w8":
            after = torch.randn((1, k), generator=gen, device="cuda").to(bf16)
            control = neighbour_sx_control(torch, tquant, x, wq, scale, after)
        else:
            control = swapped_halves_control(torch, tquant, x, wq, scale)
        assert not torch.equal(control, out), (kind, m, k, n)


def test_activation_pass_is_bit_exact(cuda):
    for m, k in ((608, 4096), (77, 4112), (2, 11008)):
        x = (4 * torch.randn((m, k), generator=cuda, device="cuda")).to(torch.bfloat16)
        x[1] = 0
        xq, sx = tquant.quantize_rows_int8_cuda(x)
        rq, rs = tquant.quantize_rows_int8(x)
        assert torch.equal(xq, rq) and torch.equal(sx, rs)


def test_refusals_on_the_card(cuda):
    x = torch.zeros((77, 4112), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="K % 32 == 0"):
        tquant.a8w4_matmul(x, torch.zeros((64, 2056), dtype=torch.int8, device="cuda"),
                           torch.ones(64, device="cuda"))
    w = torch.zeros((64, 4112), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # fp32 x
        tquant.a8w8_matmul(x.float(), w, torch.ones(64, device="cuda"))
    with pytest.raises(RuntimeError):  # an inference kernel refuses autograd
        tquant.a8w8_matmul(x, w, torch.ones(64, device="cuda", requires_grad=True))
