"""DDIM and UniPC in the port against the JAX package's on the CPU: every
step of 20 on shared seeded inputs (DDIM at eta 0 and, with the noise JAX's
key draws injected, at eta 0.5; UniPC at orders 1 and 2), the timesteps of
each spacing, the explicit-generator noise of DDIM, the order-2 predictor
without a corrector (ROADMAP C.31) and scheduler_config.json both ways.

torch's and JAX's fp32 linspace and cumprod round differently, so the
alphas_cumprod differ in their last bits; the tolerance, 2e-5 of the
sample's largest magnitude after 20 steps, covers that alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.diffusers.schedulers import DDIMScheduler as JDDIM
from paddlemix_tpu.diffusers.schedulers import UniPCMultistepScheduler as JUniPC
from paddlemix_tpu_torch.diffusers import DDIMScheduler, PNDMScheduler, UniPCMultistepScheduler
from paddlemix_tpu_torch.diffusers.sd15 import SD15_SCHEDULER

pytestmark = pytest.mark.torch_port

SD = dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012)
SHAPE = (2, 4, 4, 4)
TOL = 2e-5


def _close(ref, out):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def _run(js, ts, steps, seed, jstate, tstate, noise_key=None):
    """Both schedulers over every step on the same model outputs; the sample
    compared after each."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*SHAPE).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    key = noise_key
    for i in range(steps):
        out = rs.randn(*SHAPE).astype(np.float32)
        kw_j, kw_t = {}, {}
        if key is not None:
            key, sub = jax.random.split(key)
            kw_j["key"] = sub
            kw_t["noise"] = torch.from_numpy(np.array(jax.random.normal(sub, SHAPE, jnp.float32)))
        jx, jstate = js.step(jstate, jnp.asarray(out), i, jx, **kw_j)
        tx, tstate = ts.step(tstate, torch.from_numpy(out), i, tx, **kw_t)
        _close(jx, tx)
    return jx, tx


# -------------------------------------------------------------------- DDIM
@pytest.mark.parametrize("kw", [
    dict(), dict(set_alpha_to_one=False, steps_offset=1),
    dict(prediction_type="v_prediction", clip_sample=True),
    dict(prediction_type="sample", timestep_spacing="trailing"),
    dict(timestep_spacing="linspace")], ids=["default", "offset", "v_clip", "sample_trailing",
                                             "linspace"])
def test_ddim_eta0_matches_jax_every_step(kw):
    js, ts = JDDIM(**SD, **kw), DDIMScheduler(**SD, **kw)
    jstate, tstate = js.set_timesteps(20), ts.set_timesteps(20)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(tstate.prev_timesteps.numpy(),
                                  np.asarray(jstate.prev_timesteps))
    _run(js, ts, 20, 0, jstate, tstate)


def test_ddim_eta_noise_matches_jax_with_injected_noise():
    """At eta 0.5 JAX adds sigma times a normal draw from the step's key;
    the port adds sigma times the noise it is given (here JAX's draws)."""
    js, ts = JDDIM(**SD, eta=0.5), DDIMScheduler(**SD, eta=0.5)
    jx, tx = _run(js, ts, 20, 1, js.set_timesteps(20), ts.set_timesteps(20),
                  noise_key=jax.random.PRNGKey(7))
    jx0, _ = _run(js, ts, 20, 1, js.set_timesteps(20), ts.set_timesteps(20))
    assert float(np.abs(np.asarray(jx) - np.asarray(jx0)).max()) > 1e-2  # the noise is live


def test_ddim_draws_from_an_explicit_generator():
    ts = DDIMScheduler(**SD, eta=0.5)
    state = ts.set_timesteps(10)
    x, out = torch.randn(SHAPE), torch.randn(SHAPE)
    a, _ = ts.step(state, out, 3, x, generator=torch.Generator().manual_seed(1))
    b, _ = ts.step(state, out, 3, x, generator=torch.Generator().manual_seed(1))
    none, _ = ts.step(state, out, 3, x)  # JAX's key=None: no noise
    gen = torch.Generator().manual_seed(1)
    given, _ = ts.step(state, out, 3, x, noise=torch.randn(SHAPE, generator=gen))
    assert torch.equal(a, b) and torch.equal(a, given) and not torch.equal(a, none)
    # at eta 0 neither a generator nor noise changes the step
    t0 = DDIMScheduler(**SD)
    s0 = t0.set_timesteps(10)
    assert torch.equal(t0.step(s0, out, 3, x)[0],
                       t0.step(s0, out, 3, x, generator=torch.Generator().manual_seed(1))[0])


# ------------------------------------------------------------------- UniPC
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_unipc_matches_jax_every_step(order, prediction_type):
    js = JUniPC(**SD, solver_order=order, prediction_type=prediction_type)
    ts = UniPCMultistepScheduler(**SD, solver_order=order, prediction_type=prediction_type)
    jstate, tstate = js.set_timesteps(20, sample_shape=SHAPE), ts.set_timesteps(20)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    for name in ("alpha_t", "sigma_t", "lambda_t"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=1e-5)
    assert float(tstate.alpha_t[-1]) == 1.0 and float(tstate.sigma_t[-1]) == np.float32(1e-9)
    _run(js, ts, 20, 2, jstate, tstate)


def test_unipc_lower_order_final_matches_jax():
    js, ts = JUniPC(**SD, lower_order_final=False), UniPCMultistepScheduler(**SD,
                                                                           lower_order_final=False)
    _run(js, ts, 20, 3, js.set_timesteps(20, sample_shape=SHAPE), ts.set_timesteps(20))


def test_unipc_is_the_predictor_without_corrector_c31():
    """C.31: JAX's UniPC is the order-2 multistep predictor (the first-order
    step corrected by the x0 difference over the lambda-step ratio, with the
    expm1(-h) / 2 coefficient) and no UniC corrector: the second step from
    the sample the first returned is exactly that, whatever the first
    step's model output was (a corrector would revise it)."""
    ts = UniPCMultistepScheduler(**SD)
    state = ts.set_timesteps(20)
    rs = np.random.RandomState(4)
    x, e0, e1 = (torch.from_numpy(rs.randn(*SHAPE).astype(np.float32)) for _ in range(3))
    x1, state1 = ts.step(state, e0, 0, x)
    x2, _ = ts.step(state1, e1, 1, x1)
    a, s, lam = state.alpha_t, state.sigma_t, state.lambda_t
    x0_0 = (x - s[0] * e0) / a[0]
    x0_1 = (x1 - s[1] * e1) / a[1]
    h = lam[2] - lam[1]
    first = (s[2] / s[1]) * x1 - a[2] * torch.expm1(-h) * x0_1
    r = (lam[1] - lam[0]) / h
    want = first - 0.5 * a[2] * torch.expm1(-h) * ((x0_1 - x0_0) / r)
    torch.testing.assert_close(x2, want, rtol=0, atol=1e-6)
    assert torch.equal(x1, (s[1] / s[0]) * x - a[1] * torch.expm1(-(lam[1] - lam[0])) * x0_0)


# -------------------------------------------------------------- config IO
@pytest.mark.parametrize("jcls,cls,kw", [
    (JDDIM, DDIMScheduler, dict(eta=0.3, clip_sample=True, set_alpha_to_one=False)),
    (JUniPC, UniPCMultistepScheduler, dict(solver_order=1, lower_order_final=False))])
def test_scheduler_config_round_trip(jcls, cls, kw, tmp_path):
    js = jcls(**SD, **kw)
    js.save_pretrained(str(tmp_path / "jax"))
    ts = cls.from_pretrained(str(tmp_path / "jax"))
    assert all(getattr(ts.config, k) == v for k, v in dict(SD, **kw).items())
    ts.save_pretrained(str(tmp_path / "port"))
    back = jcls.from_pretrained(str(tmp_path / "port"))
    assert all(getattr(back.config, k) == getattr(js.config, k) for k in dict(SD, **kw))


def test_schedulers_from_the_sd15_pndm_config_keep_their_own_fields():
    """A checkpoint's scheduler_config.json names PNDM: DDIM and UniPC read
    it as JAX's `from_config` does, keeping their own fields' defaults."""
    cfg = PNDMScheduler(**SD15_SCHEDULER).config.to_dict()
    ddim = DDIMScheduler.from_config(cfg)
    unipc = UniPCMultistepScheduler.from_config(cfg)
    jddim, junipc = JDDIM.from_config(cfg), JUniPC.from_config(cfg)
    for t, j in ((ddim, jddim), (unipc, junipc)):
        assert t.config.beta_schedule == "scaled_linear"
        assert t.config.timestep_spacing == j.config.timestep_spacing
        assert "skip_prk_steps" in t.config.unused_kwargs
    assert unipc.config.timestep_spacing == "leading"  # the checkpoint's, as JAX keeps it
    with pytest.raises(NotImplementedError, match="thresholding"):
        DDIMScheduler(thresholding=True)
