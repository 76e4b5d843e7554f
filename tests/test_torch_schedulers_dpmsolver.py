"""DPM-Solver++ multistep in the port against the JAX package's on the CPU:
every step on shared seeded inputs at orders 1 and 2, the three prediction
types, `lower_order_final` on and off (applied at every step count, 25 steps
too: ROADMAP C.38), the refused options and scheduler_config.json both ways.

JAX's step carries x0's history in a buffer of the sample's shape
(`set_timesteps(sample_shape=)`); the port keeps the previous x0 as it comes.
torch's and JAX's fp32 linspace and cumprod round differently, so the
alphas_cumprod differ in their last bits; the tolerance, 2e-5 of the
sample's largest magnitude after every step, covers that alone."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddlemix_tpu.diffusers.schedulers import DPMSolverMultistepScheduler as JDPM
from paddlemix_tpu_torch.diffusers import DPMSolverMultistepScheduler

pytestmark = pytest.mark.torch_port

SHAPE = (2, 4, 4, 4)
TOL = 2e-5


def _close(ref, out):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def _run(kw, steps, seed=0):
    """Both schedulers over every step on the same model outputs; the sample
    compared after each. Returns the port's scheduler and its final state."""
    js, ts = JDPM(**kw), DPMSolverMultistepScheduler(**kw)
    jstate = js.set_timesteps(steps, sample_shape=SHAPE)
    tstate = ts.set_timesteps(steps)
    np.testing.assert_array_equal(np.asarray(jstate.timesteps), tstate.timesteps.numpy())
    for name in ("alpha_t", "sigma_t", "lambda_t"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=1e-6, atol=1e-6)
    rs = np.random.RandomState(seed)
    x = rs.randn(*SHAPE).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        out = rs.randn(*SHAPE).astype(np.float32)
        jx, jstate = js.step(jstate, jnp.asarray(out), i, jx)
        tx, tstate = ts.step(tstate, torch.from_numpy(out), i, tx)
        _close(jx, tx)
    return ts, tstate


@pytest.mark.parametrize("kw", [
    dict(), dict(solver_order=1), dict(prediction_type="v_prediction"),
    dict(prediction_type="sample"), dict(lower_order_final=False),
    dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
         timestep_spacing="leading", steps_offset=1)],
    ids=["default", "order1", "v", "sample", "no_lower_order_final", "sd_leading"])
def test_dpmsolver_steps_match_jax(kw):
    _run(kw, 20)


def test_dpmsolver_lower_order_final_at_every_step_count_c38():
    """C.38: JAX takes the last step at first order whatever the step count
    (upstream's DPM-Solver++ only below 15 steps); the port keeps it. At 25
    steps the last update equals the first-order one from the same x, and
    differs from the second-order one that `lower_order_final=False` takes."""
    steps = 25
    ts, state = _run({}, steps)
    rs = np.random.RandomState(1)
    x, out, x0_prev = (torch.from_numpy(rs.randn(*SHAPE).astype(np.float32)) for _ in range(3))
    last = state._replace(x0_prev=x0_prev, step_count=steps - 1)
    got, _ = ts.step(last, out, steps - 1, x)
    first, _ = ts.step(last._replace(step_count=0), out, steps - 1, x)
    second, _ = DPMSolverMultistepScheduler(lower_order_final=False).step(last, out, steps - 1, x)
    assert torch.equal(got, first)
    assert not torch.allclose(got, second)


def test_dpmsolver_refuses_unported_options():
    for kw in (dict(use_karras_sigmas=True), dict(algorithm_type="dpmsolver")):
        with pytest.raises(NotImplementedError, match="not ported"):
            DPMSolverMultistepScheduler(**kw)


def test_dpmsolver_config_io_both_ways(tmp_path):
    kw = dict(solver_order=1, prediction_type="v_prediction", lower_order_final=False,
              beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012)
    JDPM(**kw).save_pretrained(str(tmp_path / "jax"))
    back = DPMSolverMultistepScheduler.from_pretrained(str(tmp_path / "jax"))
    for k, v in kw.items():
        assert getattr(back.config, k) == v
    DPMSolverMultistepScheduler(**kw).save_pretrained(str(tmp_path / "port"))
    jback = JDPM.from_pretrained(str(tmp_path / "port"))
    for k, v in kw.items():
        assert getattr(jback.config, k) == v
