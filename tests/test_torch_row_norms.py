"""The plans of csrc/norms.cu's row norms, B11's forward (RMSNorm,
`rms_norm_plan`), B12 (adaLN, `adaln_plan`), B13 (fused adaLN + gated
residual, `fused_adaln_plan`) and B10's forward (LayerNorm,
`layer_norm_plan`), as their Python mirrors in paddlemix_tpu_torch.ops.norms
give them: at the paths' shapes and the card checks' extra cases, and at
ragged ones, each plan covers every row and every column exactly once, a
B12 / B13 block's rows lie within one batch element, and the 16-byte form is
taken only where every pointer, row stride and width allows it. The
wrappers' acceptances and refusals. The moments combined as the adaLN row
form combines them (each warp's sum, mean and squared deviations from that
mean) agree with the plain two-pass variance within fp32 rounding, and B13
and B10's forward computed on the CPU in each form's summation order, in
fp32, agree with their plain versions within the card's gate. On a CUDA
card only, each kernel against its plain version and the library's plans
against the mirrors.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    ADALN_EXTRA_CASES,
    ADALN_SHAPES,
    CLIP_LN_SHAPES,
    LN_EXTRA_CASES,
    RMS_EXTRA_CASES,
    RMS_SHAPES,
)
from paddlemix_tpu_torch.ops import norms as tn

pytestmark = pytest.mark.torch_port

RMS_CASES = sorted(set(RMS_SHAPES + [s for s, _, _, _ in RMS_EXTRA_CASES]
                       + [(1, 8), (3, 320), (700, 100), (5, 16384), (2000, 4104), (70000, 64)]))
ADALN_CASES = sorted(set(ADALN_SHAPES + [s for s, _, _ in ADALN_EXTRA_CASES]
                         + [(1, 7, 320), (2, 2000, 2048), (200, 3, 2048), (1, 5000, 256),
                            (300, 4, 1536), (1, 1, 1)]))


FUSED_CASES = ADALN_CASES + [(2, 600, 1536), (5, 300, 64)]
LN_CASES = sorted(set([(r, h) for r, h, _ in CLIP_LN_SHAPES] + [s for s, _, _ in LN_EXTRA_CASES]
                      + [(1, 1), (1000, 768), (1057, 1280), (2000, 100), (5000, 8), (3, 1280)]))


def _offset(t, elements=1):
    """t's values in a contiguous tensor `elements` past a 64-byte boundary."""
    out = torch.empty(t.numel() + 64, dtype=t.dtype)
    base = (-out.data_ptr() % 64) // t.element_size() + elements
    return out[base:base + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("esize", [2, 4], ids=["16bit", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("rows,h", RMS_CASES)
def test_rms_norm_plan_covers_every_row_and_column_once(rows, h, esize, aligned):
    plan = tn.rms_norm_plan(rows, h, esize, aligned)
    # the 16-byte form only where the pointers allow it and the row is whole chunks
    assert plan.vec == (16 // esize if aligned and h * esize % 16 == 0 else 1)
    assert plan.cpt in (1, 2, 4, 8, 16) and plan.threads % 32 == 0
    assert plan.threads <= (tn.RMS_THREADS if plan.vec > 1 else 1024)
    cols = sorted(c for t in range(plan.threads) for c in plan.thread_columns(t, h))
    assert cols == list(range(h))
    covered = [r for blk in range(plan.blocks) for r in plan.block_rows(blk, rows)]
    assert covered == list(range(rows))
    assert all(len(plan.block_rows(blk, rows)) for blk in range(plan.blocks))
    # a block a row where the rows fit the grid's blocks, else runs of rows
    capacity = tn._SMS * max(1, tn.RMS_THREADS_PER_SM // plan.threads)
    assert (plan.rpb == 1) == (rows <= capacity) and plan.blocks <= capacity


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("b,s,h", ADALN_CASES)
def test_adaln_plan_covers_every_row_once_within_batch_elements(b, s, h, aligned):
    plan = tn.adaln_plan(b, s, h, aligned)
    assert plan.vec == (8 if aligned and h % 8 == 0 else 1)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    many = plan.vec > 1 and b * s > tn._SMS * tn.ADALN_ROW_BLOCKS
    assert plan.form == (tn.ADALN_WARP if many else tn.ADALN_ROW)
    span = 32 if plan.form == tn.ADALN_WARP else plan.threads
    cols = sorted(c for t in range(span) for c in plan.thread_columns(t, h))
    assert cols == list(range(h))
    seen = []
    for blk in range(plan.blocks(b)):
        batches = set()
        for warp in range(plan.threads // 32 if plan.form == tn.ADALN_WARP else 1):
            bb, rows = plan.warp_rows(blk, warp, s)
            batches.add(bb)
            assert all(0 <= r < s for r in rows) and len(rows) <= plan.rpb
            seen += [(bb, r) for r in rows]
        assert len(batches) == 1  # a block's rows are one batch element's
    assert sorted(seen) == [(bb, r) for bb in range(b) for r in range(s)]


def test_plans_take_the_16_byte_form_only_where_the_tensors_allow_it():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(33, 4096).astype(np.float32)).to(torch.bfloat16)
    w = torch.ones(4096)
    assert tn.rms_norm_plan_of(_offset(x, 0), w).vec == 8
    assert tn.rms_norm_plan_of(_offset(x), w).vec == 1  # x one element past a boundary
    assert tn.rms_norm_plan_of(_offset(x, 0), _offset(w)).vec == 1  # the weight
    assert tn.rms_norm_plan_of(_offset(x, 0), w, y=_offset(x)).vec == 1  # the output
    assert tn.rms_norm_plan_of(_offset(x[:, :4092].contiguous(), 0), w[:4092]).vec == 1
    xa = _offset(torch.from_numpy(rs.randn(2, 154, 1536).astype(np.float32)).to(torch.bfloat16), 0)
    mod = _offset(torch.from_numpy(rs.randn(2, 6 * 1536).astype(np.float32)).to(torch.bfloat16), 0)
    shift, scale = mod.chunk(6, dim=-1)[:2]
    assert tn.adaln_plan_of(xa, scale, shift).vec == 8  # chunks of one (B, 6H) projection
    assert tn.adaln_plan_of(_offset(xa), scale, shift).vec == 1
    assert tn.adaln_plan_of(xa, mod[:, 1:1537], shift).vec == 1  # scale misaligned
    assert tn.adaln_plan_of(xa, scale.float(), shift).vec == 8  # both read in fp32
    assert tn.adaln_plan(2, 3, 1532, True).vec == 1  # a row of no whole chunks
    # a modulation row stride of no whole 16 bytes
    m2 = _offset(torch.from_numpy(rs.randn(2, 1540).astype(np.float32)).to(torch.bfloat16), 0)
    assert tn.adaln_plan_of(xa, m2[:, :1536], m2[:, :1536]).vec == 1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64)
    with pytest.raises(ValueError):  # not contiguous
        tn._rms_check(x.t(), torch.ones(4))
    with pytest.raises(ValueError):  # wider than a block takes
        tn._rms_check(torch.zeros(1, tn._RMS_MAX_WIDTH + 8), torch.ones(tn._RMS_MAX_WIDTH + 8))
    with pytest.raises(ValueError):  # an integer tensor
        tn._rms_check(x.to(torch.int32), w)
    with pytest.raises(ValueError):  # a weight of another width
        tn._rms_check(x, torch.ones(32))
    assert tn._rms_check(x, w.double()).dtype == torch.float32  # read as fp32
    xa, m = torch.zeros(1, 2, 64, dtype=torch.bfloat16), torch.zeros(1, 6 * 64)
    with pytest.raises(ValueError):  # x not bf16
        tn._check_adaln("adaptive_layer_norm", (xa.float(),), (m[:, :64], m[:, 64:128]))
    with pytest.raises(ValueError):  # wider than a warp holds
        wide = torch.zeros(1, 2, tn._ADALN_MAX_WIDTH + 8, dtype=torch.bfloat16)
        mw = torch.zeros(1, tn._ADALN_MAX_WIDTH + 8)
        tn._check_adaln("adaptive_layer_norm", (wide,), (mw, mw))
    with pytest.raises(ValueError):  # two row strides
        tn._check_adaln("adaptive_layer_norm", (xa,), (m[:, :64], torch.zeros(1, 64)))
    with pytest.raises(ValueError):
        tn.adaptive_layer_norm(xa.to("meta"), m[:, :64].to("meta"), m[:, 64:128].to("meta"))
    scale, shift = tn._adaln_mods(m[:, :64].half(), m[:, 64:128])
    assert scale.dtype == shift.dtype == torch.float32  # two dtypes: both read in fp32


@pytest.mark.parametrize("b,s,h", [(2, 154, 1536), (3, 50, 100), (1, 7, 320)])
def test_adaln_row_form_moments_match_the_two_pass_variance(b, s, h):
    """The row form's moments, combined as the kernel combines them, in fp32,
    against the plain two-pass variance (in float64, to show both)."""
    rs = np.random.RandomState(1)
    for aligned in (True, False):
        plan = tn.adaln_plan(b, s, h, aligned)
        assert plan.form == tn.ADALN_ROW
        x = (rs.randn(b * s, h) * rs.uniform(0.5, 3, (b * s, 1)) + rs.randn(b * s, 1) * 4)
        x = x.astype(np.float32)
        warps = plan.threads // 32
        sums, counts, means, m2s = [], [], [], []
        for w in range(warps):
            cols = [c for t in range(32 * w, 32 * w + 32) for c in plan.thread_columns(t, h)]
            xs = x[:, cols]
            n = np.float32(len(cols))
            sw = xs.sum(axis=1, dtype=np.float32)
            mw = (sw / n if n else np.zeros_like(sw)).astype(np.float32)
            sums.append(sw), counts.append(n), means.append(mw)
            m2s.append(((xs - mw[:, None]) ** 2).sum(axis=1, dtype=np.float32))
        mean = np.sum(sums, axis=0, dtype=np.float32) * np.float32(1.0 / h)
        m2 = np.zeros_like(mean)
        for w in range(warps):
            if counts[w]:
                m2 += m2s[w] + counts[w] * (means[w] - mean) ** 2
        var = m2 / np.float32(h)
        x64 = x.astype(np.float64)
        ref_mean, ref_var = x64.mean(axis=1), x64.var(axis=1)
        np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=1e-6 * np.abs(x64).max())
        np.testing.assert_allclose(var, ref_var, rtol=2e-6)


def _check_norm_plan(plan, op, b, s, h, esize, aligned):
    """A B13 / B10 plan: its forms where they belong (the warp form
    LayerNorm's alone), and every (batch element, row) and every column taken
    exactly once, a block's rows within one batch element."""
    assert plan.vec == (16 // esize if aligned and h * esize % 16 == 0 else 1)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    many = plan.vec > 1 and b * s > tn._SMS * tn.NORM_ROW_BLOCKS
    warp = op == tn.OP_LN and many and plan.vec * 32 * max(tn.NORM_LANE_CPT) >= h
    assert plan.form == (tn.NORM_WARP if warp else tn.NORM_ROW)
    if warp:  # a row a warp, small blocks
        assert plan.cpt in tn.NORM_LANE_CPT and plan.rpb == plan.threads // 32 <= tn.NORM_WARPS
    else:
        assert plan.rpb == 1
    span = 32 if warp else plan.threads
    assert sorted(c for t in range(span) for c in plan.thread_columns(t, h)) == list(range(h))
    seen = []
    for blk in range(plan.blocks(b)):
        batches = set()
        for w in range(plan.threads // 32 if warp else 1):
            bb, rows = plan.warp_rows(blk, w, s)
            batches.add(bb)
            assert all(0 <= r < s for r in rows) and len(rows) <= (1 if warp else plan.rpb)
            seen += [(bb, r) for r in rows]
        assert len(batches) == 1  # a block's rows are one batch element's
    assert sorted(seen) == [(bb, r) for bb in range(b) for r in range(s)]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("b,s,h", FUSED_CASES)
def test_fused_adaln_plan_covers_every_row_once_within_batch_elements(b, s, h, aligned):
    _check_norm_plan(tn.fused_adaln_plan(b, s, h, aligned), tn.OP_FUSED, b, s, h, 2, aligned)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("rows,h", LN_CASES)
def test_layer_norm_plan_covers_every_row_and_column_once(rows, h, esize, aligned):
    _check_norm_plan(tn.layer_norm_plan(rows, h, esize, aligned), tn.OP_LN, 1, rows, h, esize,
                     aligned)


def test_new_plans_take_the_16_byte_form_only_where_the_tensors_allow_it():
    rs = np.random.RandomState(2)
    bf = torch.bfloat16
    x = _offset(torch.from_numpy(rs.randn(2, 154, 1536).astype(np.float32)).to(bf), 0)
    r = _offset(x.clone(), 0)
    mod = _offset(torch.from_numpy(rs.randn(2, 6 * 1536).astype(np.float32)).to(bf), 0)
    shift, scale, gate = mod.chunk(6, dim=-1)[:3]
    assert tn.fused_adaln_plan_of(r, x, gate, scale, shift).vec == 8  # SD3's chunks, in place
    assert tn.fused_adaln_plan_of(r, _offset(x), gate, scale, shift).vec == 1
    assert tn.fused_adaln_plan_of(_offset(r), x, gate, scale, shift).vec == 1  # the residual
    assert tn.fused_adaln_plan_of(r, x, mod[:, 1:1537], scale, shift).vec == 1  # the gate
    assert tn.fused_adaln_plan_of(r, x, gate.float(), scale, shift).vec == 8  # all read in fp32
    assert tn.fused_adaln_plan_of(r, x, gate, scale, shift, y=_offset(x), resi=x).vec == 1
    m2 = _offset(torch.from_numpy(rs.randn(2, 1540).astype(np.float32)).to(bf), 0)
    assert tn.fused_adaln_plan_of(r, x, *(m2[:, :1536],) * 3).vec == 1  # a stride of 1,540
    assert tn.fused_adaln_plan(2, 3, 1532, True).vec == 1  # a row of no whole chunks
    xl = _offset(torch.from_numpy(rs.randn(256 * 197, 768).astype(np.float32)).to(bf), 0)
    w, b = torch.ones(768), torch.zeros(768)
    assert tn.layer_norm_plan_of(xl, w, b).vec == 8
    assert tn.layer_norm_plan_of(xl.view(256, 197, 768)[:, 0], w, b).vec == 8  # pooled, in place
    odd = xl.as_strided((255, 768), (197 * 768 - 3, 1))  # a row stride of no whole 16 bytes
    assert tn.layer_norm_plan_of(odd, w, b).vec == 1
    assert tn.layer_norm_plan_of(_offset(xl), w, b).vec == 1
    assert tn.layer_norm_plan_of(xl, _offset(w), b).vec == 1
    assert tn.layer_norm_plan_of(xl, w, _offset(b)).vec == 1
    assert tn.layer_norm_plan_of(xl, w, b, y=_offset(xl)).vec == 1
    assert tn.layer_norm_plan_of(xl.float(), w, b).vec == 4  # fp32 rows: 4 a chunk
    assert tn.layer_norm_plan_of(xl.float(), w.double(), b).vec == 4  # w and b read in fp32
    assert tn.layer_norm_plan(10, 100, 2).vec == 1  # a row of no whole 16 bytes


def test_new_wrappers_take_what_the_triton_kernels_took_and_refuse_the_rest():
    bf = torch.bfloat16
    x = torch.zeros(2, 5, 64, dtype=bf)
    m = torch.zeros(2, 6 * 64)
    # modulation rows of any float dtype, mixed: all read in fp32
    mods = tn._adaln_mods(m[:, :64].half(), m[:, 64:128], m[:, 128:192].to(bf))
    assert all(t.dtype == torch.float32 for t in mods)
    mods = tn._adaln_mods(*(t.to(bf) for t in (m[:, :64], m[:, 64:128], m[:, 128:192])))
    assert all(t.dtype == bf for t in mods)  # one kernel dtype: read as they are
    tn._check_adaln("fused_adaln_scale_residual", (x, x.clone()), (m[:, :64], m[:, 64:128],
                                                                   m[:, 128:192]))
    with pytest.raises(ValueError):  # the residual of another shape
        tn._check_adaln("fused_adaln_scale_residual", (x, x[:, :4].contiguous()),
                        (m[:, :64],) * 3)
    with pytest.raises(ValueError):  # x not contiguous
        tn._check_adaln("fused_adaln_scale_residual", (x.transpose(0, 1).contiguous()
                                                      .transpose(0, 1), x), (m[:, :64],) * 3)
    with pytest.raises(ValueError):  # the gate with another row stride
        tn._check_adaln("fused_adaln_scale_residual", (x, x), (torch.zeros(2, 64), m[:, :64],
                                                               m[:, 64:128]))
    with pytest.raises(ValueError):
        tn.fused_adaln_scale_residual(*(t.to("meta") for t in (x, x, m[:, :64], m[:, 64:128],
                                                                m[:, 128:192])))
    # LayerNorm: bf16 or fp32 rows up to 2,048 wide at any row stride; w and b
    # of any float dtype (read as fp32)
    for xx in (torch.zeros(4, 2048, dtype=bf), torch.zeros(4, 3, 8)[:, 0]):
        tn._ln_check("layer_norm", xx, (torch.ones(xx.shape[-1]), torch.zeros(xx.shape[-1])))
    w, b = tn._adaln_mods(torch.ones(8, dtype=torch.float64), torch.zeros(8, dtype=bf))
    assert w.dtype == b.dtype == torch.float32
    for bad in (torch.zeros(4, 8).half(), torch.zeros(4, 2049)):
        with pytest.raises(ValueError):
            tn._ln_check("layer_norm", bad, ())
    with pytest.raises(ValueError):  # a weight of another width
        tn._ln_check("layer_norm", torch.zeros(4, 8), (torch.ones(4),))


def _warp_total(lanes):
    """A warp's xor-shuffle sum of its 32 lanes' partial sums (rows, 32), as
    `warp_sum` takes it: every lane ends with the same total."""
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
    return lanes[:, 0]


def _emulated_moments(plan, v):
    """(mean, rstd) of each row of v (rows, h) fp32 in the order the plan's
    form sums it: the warp form a warp a row (each lane's elements in order,
    then the xor-shuffle tree); the row form a block a row, two-pass (each
    warp's sum, the warps' sums in warp order; then each warp's squared
    deviations from the mean, likewise)."""
    rows, h = v.shape
    inv_h = torch.tensor(1.0 / h, dtype=torch.float32)
    lanes_of = [plan.thread_columns(t, h) for t in range(32 if plan.form == tn.NORM_WARP
                                                          else plan.threads)]

    def warp_totals(t):
        """Each warp's xor-shuffle total of its lanes' sums (in element order)."""
        out = []
        for w in range(len(lanes_of) // 32):
            lanes = torch.zeros(rows, 32)
            for i in range(32):
                for c in lanes_of[32 * w + i]:
                    lanes[:, i] += t[:, c]
            out.append(_warp_total(lanes))
        return out

    def block_total(t):
        total = torch.zeros(rows)
        for wt in warp_totals(t):
            total = total + wt
        return total
    mean = block_total(v) * inv_h
    q = block_total((v - mean[:, None]) ** 2)
    return mean, torch.rsqrt(q * inv_h + 1e-5)


def _within_gate(out, ref, c=1e-6):  # chip_smoke.py's per-element gate
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + c * ref.abs().max()).all())


@pytest.mark.parametrize("b,s,h,aligned", [(2, 600, 1536, True), (2, 154, 1536, True),
                                           (2, 154, 1536, False), (3, 50, 100, True)])
def test_fused_adaln_summation_orders_match_the_plain_version(b, s, h, aligned):
    """B13 in each form's order, in fp32, normalising the unrounded sum
    residual + gate x, rounded once to bf16, against the plain version."""
    rs = np.random.RandomState(3)
    bf = torch.bfloat16
    x, res = (torch.from_numpy((2 * rs.randn(b, s, h)).astype(np.float32)).to(bf) for _ in range(2))
    gate, scale, shift = (torch.from_numpy(rs.randn(b, h).astype(np.float32)).to(bf)
                          for _ in range(3))
    plan = tn.fused_adaln_plan(b, s, h, aligned)
    v = res.float() + gate.float()[:, None, :] * x.float()  # never rounded before the moments
    mean, rstd = _emulated_moments(plan, v.reshape(-1, h))
    y = ((v.reshape(-1, h) - mean[:, None]) * rstd[:, None]).reshape(b, s, h) \
        * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    ref_y, ref_resi = tn.fused_adaln_scale_residual_ref(res, x, gate, scale, shift)
    assert _within_gate(y.to(bf), ref_y) and torch.equal(v.to(bf), ref_resi)
    # the control: the sum rounded to bf16 before the moments fails the gate
    vr = v.to(bf).float()
    mean, rstd = _emulated_moments(plan, vr.reshape(-1, h))
    yr = ((vr.reshape(-1, h) - mean[:, None]) * rstd[:, None]).reshape(b, s, h) \
        * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    assert not _within_gate(yr.to(bf), ref_y)


@pytest.mark.parametrize("rows,h,dtype,aligned", [(2000, 768, "bf16", True),
                                                  (2000, 512, "fp32", True),
                                                  (77, 1280, "bf16", True),
                                                  (577, 1024, "bf16", True),
                                                  (300, 100, "bf16", False)])
def test_layer_norm_summation_orders_match_the_plain_version(rows, h, dtype, aligned):
    """B10's forward in each form's order, in fp32, rounded once to x's
    dtype, against the plain version."""
    rs = np.random.RandomState(4)
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    x = torch.from_numpy((rs.randn(rows, h) * rs.uniform(0.5, 3, (rows, 1))
                          + 4 * rs.randn(rows, 1)).astype(np.float32)).to(dt)
    w = torch.from_numpy((1 + 0.2 * rs.randn(h)).astype(np.float32))
    b = torch.from_numpy((0.2 * rs.randn(h)).astype(np.float32))
    plan = tn.layer_norm_plan(rows, h, x.element_size(), aligned)
    assert plan.form == (tn.NORM_WARP if rows > 1056 and aligned and h * x.element_size() <= 2048
                         else tn.NORM_ROW)
    mean, rstd = _emulated_moments(plan, x.float())
    y = (x.float() - mean[:, None]) * rstd[:, None] * w + b
    assert _within_gate(y.to(dt), tn.layer_norm_ref(x, w, b))


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_row_norm_kernels_match_plain_versions_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU host (see README, PyTorch port)")
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def within(out, ref, c=1e-6):  # one rounding apart, plus fp32 summation order
        ref = ref.float()
        limit = 2.0 ** -7 * ref.abs() + c * ref.abs().max()
        return bool(((out.float() - ref).abs() <= limit).all())

    def off(t):  # t's values one element past a 16-byte boundary
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)

    for rows, h in RMS_CASES:
        for xd, wd in ((bf16, torch.float32), (torch.float32, bf16),
                       (torch.float16, torch.float16)):
            x = (3 * torch.randn((rows, h), generator=gen, device=dev)).to(xd)
            w = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(wd)
            for xx in (x, off(x)):
                before = tn.rms_norm.launches
                out = tn.rms_norm(xx, w, 1e-5)
                torch.cuda.synchronize()
                assert tn.rms_norm.launches == before + 1
                assert within(out, tn.rms_norm_ref(xx.float(), w, 1e-5)), (rows, h, xd, wd)
        for dtype in (bf16, torch.float32):
            for aligned in (True, False):
                es = torch.empty(0, dtype=dtype).element_size()
                assert tn.rms_norm_plan(rows, h, es, aligned) == \
                    tn.rms_norm_plan_library(rows, h, dtype, aligned)
    for b, s, h in ADALN_CASES:
        for md in (bf16, torch.float32):
            x = (2 * torch.randn((b, s, h), generator=gen, device=dev)).to(bf16)
            mod = torch.randn((b, 6 * h), generator=gen, device=dev).to(md)
            shift, scale = mod.chunk(6, -1)[:2]
            for xx in (x, off(x)):
                before = tn.adaptive_layer_norm.launches
                y = tn.adaptive_layer_norm(xx, scale, shift)
                torch.cuda.synchronize()
                assert tn.adaptive_layer_norm.launches == before + 1
                assert within(y, tn.adaptive_layer_norm_ref(xx, scale, shift)), (b, s, h, md)
        for aligned in (True, False):
            assert tn.adaln_plan(b, s, h, aligned) == tn.adaln_plan_library(b, s, h, aligned)
