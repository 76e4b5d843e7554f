"""Per-block gradient checkpointing of the port's UNet (`gradient_checkpointing`:
each down, mid and up block recomputed in the backward, JAX's `nn.remat`
per block) on the CPU: the loss and every gradient with it on equal those
with it off bit for bit, and JAX's under `nn.remat` within fp32 summation
order (1e-4 relative L2), on a tiny SD1.5-layout UNet and on one whose
256-token self-attention takes flash; the calls of a recomputed training
step (each block's forward kernels twice) against the walk; and the
ControlNet, which JAX's ignores the option for, giving the same numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import UNet2DConditionConfig as JUNetConfig
from paddlemix_tpu.diffusers import UNet2DConditionModel as JUNet
from paddlemix_tpu_torch.core import UNET_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.diffusers import (
    DDPMScheduler,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers import training_utils as ttu
from paddlemix_tpu_torch.diffusers.sd15 import expected_launches_sd15_train, train_walk
from test_torch_controlnet import TINY_CN, _counting, _inputs, _rel, jax_controlnet, \
    port_controlnet
from test_torch_sd15 import TINY_UNET_SD15, WIDE_UNET_SD15

pytestmark = pytest.mark.torch_port

CONFIGS = {"tiny": (TINY_UNET_SD15, 8, 32), "wide": (WIDE_UNET_SD15, 16, 24)}


@pytest.fixture(scope="module")
def jax_unets():
    return {name: JUNet.from_config(JUNetConfig.from_dict(cfg)) for name, (cfg, _, _) in
            CONFIGS.items()}


def _port(junet, config, recompute):
    u = UNet2DConditionModel(UNet2DConditionConfig(**dict(config,
                                                           gradient_checkpointing=recompute)))
    u.load_state_dict(flax_to_torch_state_dict(flatten_params(junet.params), u, UNET_KEY_MAP))
    return u.to(memory_format=torch.channels_last)


def _data(seed, hw, ctx_dim):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, hw, hw, 4).astype(np.float32), np.asarray([30, 800]),
            rs.randn(2, 5, ctx_dim).astype(np.float32), rs.randn(2, hw, hw, 4).astype(np.float32))


def _port_loss_and_grads(u, data):
    x, t, ctx, y = (torch.from_numpy(a) for a in data)
    loss = ((u(x, t, ctx) - y) ** 2).mean()
    names, params = zip(*u.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_with_checkpointing_equal_without_and_jax_remat(jax_unets, name):
    cfg, hw, ctx_dim = CONFIGS[name]
    ju = jax_unets[name]
    data = _data(1, hw, ctx_dim)
    loss_on, grads_on = _port_loss_and_grads(_port(ju, cfg, True), data)
    loss_off, grads_off = _port_loss_and_grads(_port(ju, cfg, False), data)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(grads_on[k], grads_off[k]) for k in grads_off)

    # the same module with nn.remat around each block, over the same params
    remat = ju.module.clone(config=JUNetConfig.from_dict(dict(cfg, gradient_checkpointing=True)))
    x, t, ctx, y = (jnp.asarray(a) for a in data)

    def loss_fn(p):
        return jnp.mean((remat.apply({"params": p}, x, t, ctx) - y) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(ju.params)
    assert abs(loss_on.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = flax_to_torch_state_dict(flatten_params(jgrads), _port(ju, cfg, True), UNET_KEY_MAP)
    gaps = {k: _rel(g, want[k]) for k, g in grads_on.items()}
    assert max(gaps.values()) < 1e-4, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


def test_checkpointing_is_per_block_and_off_without_grad(jax_unets, monkeypatch):
    """One recomputed call a down, mid and up block, and none under no_grad."""
    from paddlemix_tpu_torch.diffusers.models import unet_2d_condition as um

    calls = []
    real = um.checkpoint
    monkeypatch.setattr(um, "checkpoint", lambda fn, *a, **kw: calls.append(fn) or real(
        fn, *a, **kw))
    u = _port(jax_unets["tiny"], TINY_UNET_SD15, True)
    data = _data(2, 8, 32)
    _port_loss_and_grads(u, data)
    assert calls == list(u.down_blocks) + [u.mid_block] + list(u.up_blocks)
    calls.clear()
    with torch.no_grad():
        u(*(torch.from_numpy(a) for a in data[:3]))
    assert not calls


def test_recomputed_train_step_calls_match_the_walk(jax_unets, monkeypatch):
    """A training step of the UNet whose 256-token self-attentions take
    flash, checkpointing on: each block's lse forward and GroupNorms run
    twice, the backward kernels once, conv_norm_out's GroupNorm once."""
    counts = dict.fromkeys(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "flash_attention",
                            "group_norm"), 0)
    _counting(monkeypatch, counts)
    u = _port(jax_unets["wide"], WIDE_UNET_SD15, True)
    rs = np.random.RandomState(3)
    batch = {"latents": torch.from_numpy(rs.randn(2, 16, 16, 4).astype(np.float32)),
             "encoder_hidden_states": torch.from_numpy(rs.randn(2, 5, 24).astype(np.float32))}
    loss = ttu.make_sd_loss_fn(u, DDPMScheduler())(None, batch, torch.Generator().manual_seed(0))
    loss.backward()
    walk = train_walk(u, 2, 16, context_len=5)
    assert counts == {k: walk.get(k, 0) for k in counts}
    assert walk["flash_fwd_lse"] == 2 * walk["flash_bwd_dq"] == 2 * 3
    plain = expected_launches_sd15_train(_port(jax_unets["wide"], WIDE_UNET_SD15, False), 2, 16,
                                         context_len=5)
    assert walk["group_norm"] == 2 * plain["group_norm"] - 1  # conv_norm_out's once


def test_controlnet_checkpointing_gives_the_same_gradients():
    """JAX's ControlNet ignores `gradient_checkpointing`; the port's
    recomputes its blocks, with the same loss and gradients bit for bit."""
    jcn = jax_controlnet(TINY_CN, seed=6)
    x = _inputs(4)
    args = [torch.from_numpy(x[k]) for k in ("lat", "t", "ctx", "cond")]
    out = {}
    for recompute in (False, True):
        cn = port_controlnet(jcn, dict(TINY_CN, gradient_checkpointing=recompute))
        down, mid = cn(*args)
        loss = sum((r ** 2).mean() for r in down) + (mid ** 2).mean()
        names, params = zip(*cn.named_parameters())
        out[recompute] = (loss, torch.autograd.grad(loss, params))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
