"""SD1.5 UNet fine-tuning in the port (tools/train_text_to_image.py ->
Trainer -> AdamW over diffusers.training_utils' loss and the DDPM
scheduler's noising), held against the JAX package on the CPU:
add_noise / get_velocity / the min-SNR weights, DDPMScheduler.step with
given noise, the loss and its gradients on tiny SD1.5-layout UNets (one
with a head_dim-160 self-attention that JAX runs on its Pallas flash kernel
in interpret mode) in fp32 and bf16 compute, 3 Trainer steps of the
example's recipe against the JAX Trainer, the port's own draws, the JAX
UNet's fp32 parameters carried over, and the launch walk and flop count at
full width.

torch and jax.random give different numbers from one seed, so the tests
replay JAX's draws (timesteps and noise from the same `jax.random` calls on
the same keys as `make_sd_loss_fn` and the JAX Trainer make them) through
the port's `sd_loss`. Weights come from the JAX modules' seeded init and are
carried over with `flax_to_torch_state_dict`; inputs are made with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.datasets import DataLoader as JDataLoader
from paddlemix_tpu.datasets import MapDataset as JMapDataset
from paddlemix_tpu.diffusers import DDPMScheduler as JDDPM
from paddlemix_tpu.diffusers import UNet2DConditionConfig as JUNetConfig
from paddlemix_tpu.diffusers import UNet2DConditionModel as JUNet
from paddlemix_tpu.diffusers import training_utils as jtu
from paddlemix_tpu.trainer import Trainer as JTrainer
from paddlemix_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlemix_tpu_torch.core import UNET_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.diffusers import DDPMScheduler, UNet2DConditionConfig, UNet2DConditionModel
from paddlemix_tpu_torch.diffusers import training_utils as ttu
from paddlemix_tpu_torch.diffusers.sd15 import (
    SD15_SCHEDULER,
    SD15_UNET,
    expected_launches_sd15_train,
    random_sd15_unet,
    unet_train_flops,
)
from paddlemix_tpu_torch.models.layers import set_compute_dtype
from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.tools import train_text_to_image as t2i
from test_torch_sd15 import TINY_UNET_SD15, WIDE_UNET_SD15

pytestmark = pytest.mark.torch_port

DTYPES = {"fp32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b):
    a, b = (np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)
            for t in (a, b))
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_draws(key, shape, num_train=1000):
    """make_sd_loss_fn's draws from `key`, as numpy: (t (B,) int32, noise fp32)."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, num_train)
    return np.asarray(t), np.asarray(jax.random.normal(rng_n, shape, jnp.float32))


def _port_unet(jparams, config, dtype):
    tu = set_compute_dtype(UNet2DConditionModel(UNet2DConditionConfig(**config)), dtype)
    tu.load_state_dict(flax_to_torch_state_dict(flatten_params(jparams), tu, UNET_KEY_MAP))
    return tu


def _torch_grads(jgrads, module):
    """JAX's gradient tree in the port's names and layouts."""
    return flax_to_torch_state_dict(flatten_params(jgrads), module, UNET_KEY_MAP)


# --------------------------------------------------- noising and the weights
def test_noising_and_snr_weights_match_jax():
    js, ts = JDDPM(**SD15_SCHEDULER), DDPMScheduler.from_config(SD15_SCHEDULER)
    rs = np.random.RandomState(0)
    x0, noise = (rs.randn(6, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.asarray([0, 1, 250, 500, 998, 999], np.int32)
    tt = torch.from_numpy(t).long()
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=2e-6)  # fp32 cumprod over 1,000 steps, two frameworks
    for jout, tout in (
            (js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)),
             ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), tt)),
            (js.get_velocity(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)),
             ts.get_velocity(torch.from_numpy(x0), torch.from_numpy(noise), tt))):
        assert tout.dtype == torch.float32
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ttu.compute_snr(ts.alphas_cumprod, tt).numpy(),
                               np.asarray(jtu.compute_snr(js.alphas_cumprod, jnp.asarray(t))),
                               rtol=5e-5)  # 1 / (1 - a) near t = 0 amplifies a's rounding
    for pred in ("epsilon", "v_prediction", "sample"):
        for gamma in (1.0, 5.0):
            np.testing.assert_allclose(
                ttu.snr_weights(ts.alphas_cumprod, tt, gamma, pred).numpy(),
                np.asarray(jtu.snr_weights(js.alphas_cumprod, jnp.asarray(t), gamma, pred)),
                rtol=5e-5)


@pytest.mark.parametrize("prediction_type,variance_type,clip",
                         [("epsilon", "fixed_small", True), ("v_prediction", "fixed_large", False),
                          ("sample", "fixed_small", True)])
def test_ddpm_step_matches_jax_with_given_noise(prediction_type, variance_type, clip):
    kw = dict(SD15_SCHEDULER, prediction_type=prediction_type, variance_type=variance_type,
              clip_sample=clip)
    js, ts = JDDPM(**kw), DDPMScheduler.from_config(kw)
    steps, shape = 10, (1, 4, 4, 4)
    jstate, tstate = js.set_timesteps(steps), ts.set_timesteps(steps)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_array_equal(tstate.prev_timesteps.numpy(), np.asarray(jstate.prev_timesteps))
    rs = np.random.RandomState(1)
    jx = jnp.asarray(rs.randn(*shape).astype(np.float32))
    tx = torch.from_numpy(np.array(jx))
    key = jax.random.PRNGKey(3)
    for i in range(steps):
        out = rs.randn(*shape).astype(np.float32)
        key, sub = jax.random.split(key)
        noise = jax.random.normal(sub, shape, jnp.float32)  # what JAX's step draws from sub
        jx, jstate = js.step(jstate, jnp.asarray(out), i, jx, key=sub)
        tx, tstate = ts.step(tstate, torch.from_numpy(out), i, tx,
                             noise=torch.from_numpy(np.array(noise)))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-5)
    # without noise (JAX's key=None), and a generator's draw on the sample's device
    st = ts.set_timesteps(steps)
    a = ts.step(st, torch.from_numpy(out), 0, tx)[0]
    b = ts.step(st, torch.from_numpy(out), 0, tx, generator=torch.Generator().manual_seed(0))[0]
    c = ts.step(st, torch.from_numpy(out), 0, tx, generator=torch.Generator().manual_seed(0))[0]
    assert not torch.equal(a, b) and torch.equal(b, c)


# --------------------------------------------------------- the loss, tiny
@pytest.fixture(scope="module")
def jax_tiny():
    return JUNet.from_config(JUNetConfig.from_dict(TINY_UNET_SD15), seed=0)


def _batch(seed, b, hw, ctx_len, ctx_dim):
    rs = np.random.RandomState(seed)
    return {"latents": rs.randn(b, hw, hw, 4).astype(np.float32),
            "encoder_hidden_states": rs.randn(b, ctx_len, ctx_dim).astype(np.float32)}


def _loss_and_grads(jmodel, config, batch, dtype, prediction_type, snr_gamma, seed=7,
                    jit=False):
    """(JAX loss, JAX grads in torch layout, port loss, port grads by name):
    jax.value_and_grad of make_sd_loss_fn on `key` (jitted with `jit`: the
    Pallas kernels' interpret mode runs slowly op by op), and the port's
    sd_loss on the same draws."""
    jdt, tdt = DTYPES[dtype]
    jsched, tsched = JDDPM(**SD15_SCHEDULER), DDPMScheduler.from_config(SD15_SCHEDULER)
    jm = JUNet(jmodel.config, params=jmodel.params, dtype=jdt)  # fp32 params, compute in jdt
    loss_fn = jtu.make_sd_loss_fn(jm, jsched, prediction_type=prediction_type,
                                  snr_gamma=snr_gamma)
    key = jax.random.PRNGKey(seed)
    grad_fn = jax.value_and_grad(loss_fn)
    jloss, jgrads = (jax.jit(grad_fn) if jit else grad_fn)(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    t, noise = _jax_draws(key, batch["latents"].shape)
    tu = _port_unet(jmodel.params, config, tdt)
    assert all(p.dtype == torch.float32 for p in tu.parameters())
    loss = ttu.sd_loss(tu, tsched, {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(t).long(), torch.from_numpy(noise),
                       prediction_type=prediction_type, snr_gamma=snr_gamma)
    loss.backward()
    return (float(jloss), _torch_grads(jgrads, tu), loss.item(),
            {n: p.grad for n, p in tu.named_parameters()})


# fp32: summation order only: the loss within 2.6e-6 relative here, each
# gradient tensor within 6.2e-6 relative L2
FP32_LOSS_REL, FP32_GRAD_REL = 1e-5, 5e-5


@pytest.mark.parametrize("snr_gamma", [None, 5.0], ids=["mse", "min_snr5"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_sd_loss_and_grads_match_jax(jax_tiny, prediction_type, snr_gamma):
    batch = _batch(1, 2, 8, 6, 32)
    jloss, jgrads, loss, grads = _loss_and_grads(jax_tiny, TINY_UNET_SD15, batch, "fp32",
                                                 prediction_type, snr_gamma)
    assert abs(loss - jloss) <= FP32_LOSS_REL * abs(jloss)
    assert sorted(grads) == sorted(jgrads)
    worst = max(((_rel(grads[n], jgrads[n]), n) for n in grads))
    assert worst[0] <= FP32_GRAD_REL, worst


# the head_dim-160 UNet in bf16 compute: both sides round to bf16 at the same
# places but sum in other orders, so a rounding may land the other way and
# carry through the layers: here the loss moves 8.5e-4 relative, the
# gradient tensors 8.5e-3 relative L2 at the median and 2.4e-2 at most
BF16_LOSS_REL, BF16_GRAD_MEDIAN, BF16_GRAD_MAX = 5e-3, 2e-2, 6e-2


@pytest.fixture(scope="module")
def jax_wide():
    return JUNet.from_config(JUNetConfig.from_dict(WIDE_UNET_SD15), seed=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sd_loss_and_grads_on_the_head_160_flash_match_jax(jax_wide, monkeypatch, dtype):
    """The example's recipe (epsilon, min-SNR 5) on a UNet whose 256-token,
    head_dim-160 self-attentions JAX runs on its Pallas flash forward and
    backward (interpret mode; 3 `pallas_call`s each) and the port on
    `_FlashAttention`'s plain versions; fp32 and bf16 compute over fp32
    parameters."""
    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    from paddlemix_tpu.ops import attention as jattn

    calls = []
    pallas_call = jattn.pl.pallas_call
    monkeypatch.setattr(jattn.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    taken = []
    flash = tattn._FlashAttention.apply
    monkeypatch.setattr(tattn._FlashAttention, "apply",
                        lambda q, *a: taken.append(tuple(q.shape)) or flash(q, *a))
    batch = _batch(2, 1, 16, 5, 24)
    jloss, jgrads, loss, grads = _loss_and_grads(jax_wide, WIDE_UNET_SD15, batch, dtype,
                                                 "epsilon", 5.0, jit=True)
    # 3 self-attentions at 256 tokens (1 down, 2 up): forward, dkv, dq each
    assert len(calls) == 9
    assert taken == [(1, 256, 2, 160)] * 3
    rels = sorted(_rel(grads[n], jgrads[n]) for n in grads)
    if dtype == "fp32":
        assert abs(loss - jloss) <= FP32_LOSS_REL * abs(jloss) and rels[-1] <= FP32_GRAD_REL
    else:
        assert abs(loss - jloss) <= BF16_LOSS_REL * abs(jloss), (loss, jloss)
        assert rels[len(rels) // 2] <= BF16_GRAD_MEDIAN and rels[-1] <= BF16_GRAD_MAX, \
            (rels[len(rels) // 2], rels[-1])


def test_sdxl_added_cond_loss_matches_jax():
    """added_cond_fn carries SDXL's text_time conditioning into the UNet."""
    from test_pipelines import tiny_unet

    jmodel = tiny_unet(ctx_dim=32, sdxl=True)
    cfg = {f: getattr(jmodel.config, f) for f in (
        "sample_size", "block_out_channels", "down_block_types", "up_block_types",
        "layers_per_block", "cross_attention_dim", "attention_head_dim", "norm_num_groups",
        "addition_embed_type", "addition_time_embed_dim",
        "projection_class_embeddings_input_dim")}
    batch = dict(_batch(3, 2, 8, 6, 32), text_embeds=np.random.RandomState(4).randn(
        2, 16).astype(np.float32), time_ids=np.tile(np.asarray([64, 64, 0, 0, 64, 64],
                                                               np.float32), (2, 1)))
    jsched, tsched = JDDPM(**SD15_SCHEDULER), DDPMScheduler.from_config(SD15_SCHEDULER)
    added = lambda b: {"text_embeds": b["text_embeds"], "time_ids": b["time_ids"]}  # noqa: E731
    key = jax.random.PRNGKey(5)
    jloss = jax.jit(jtu.make_sd_loss_fn(jmodel, jsched, snr_gamma=5.0, added_cond_fn=added))(
        jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    t, noise = _jax_draws(key, batch["latents"].shape)
    tu = _port_unet(jmodel.params, cfg, None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = ttu.sd_loss(tu, tsched, tb, torch.from_numpy(t).long(),
                           torch.from_numpy(noise), snr_gamma=5.0, added_cond_kwargs=added(tb))
    assert abs(float(loss) - float(jloss)) <= FP32_LOSS_REL * abs(float(jloss))


# ----------------------------------------------------------------- the draws
def test_loss_fn_draws_from_its_generator(monkeypatch):
    """make_sd_loss_fn draws t uniformly from [0, num_train) and normal noise
    of the latents' shape, both from the generator it is handed: the same
    seed gives the same draws, the next call fresh ones."""
    seen = []
    monkeypatch.setattr(ttu, "sd_loss", lambda unet, sched, batch, t, noise, **kw:
                        seen.append((t, noise, kw)) or noise.sum())
    sched = DDPMScheduler.from_config(SD15_SCHEDULER)
    loss_fn = ttu.make_sd_loss_fn(None, sched, snr_gamma=5.0)
    batch = {"latents": torch.zeros(64, 8, 8, 4)}
    gen = torch.Generator().manual_seed(11)
    loss_fn(None, batch, gen)
    loss_fn(None, batch, gen)
    loss_fn(None, batch, torch.Generator().manual_seed(11))
    (t0, n0, kw), (t1, n1, _), (t2, n2, _) = seen
    assert t0.shape == (64,) and t0.dtype == torch.int64 and 0 <= int(t0.min()) \
        and int(t0.max()) < 1000 and len(set(t0.tolist())) > 32
    assert n0.shape == (64, 8, 8, 4) and n0.dtype == torch.float32
    assert abs(float(n0.mean())) < 0.1 and abs(float(n0.std()) - 1) < 0.1
    assert torch.equal(t0, t2) and torch.equal(n0, n2)
    assert not torch.equal(t0, t1) and not torch.equal(n0, n1)
    assert kw == {"prediction_type": "epsilon", "snr_gamma": 5.0, "added_cond_kwargs": None}


def test_trainer_hands_each_step_a_seeded_generator():
    """The Trainer's rng: a torch.Generator on the params' device seeded from
    args.seed at each train call, drawn from by the steps in turn."""
    from paddlemix_tpu_torch.trainer import Trainer, TrainingArguments

    w = torch.nn.Parameter(torch.zeros(3))
    draws = []

    def loss_fn(params, batch, rng):
        draws.append(torch.rand(2, generator=rng))
        return (params["w"] * batch["x"]).sum()

    data = [{"x": np.ones(3, np.float32)}] * 8
    args = TrainingArguments(max_steps=3, logging_steps=1, save_steps=0, seed=5)
    trainer = Trainer(args=args, loss_fn=loss_fn, params={"w": w},
                      train_dataloader=[{"x": np.stack([d["x"]])} for d in data])
    trainer.train()
    want = torch.Generator().manual_seed(5)
    assert all(torch.equal(d, torch.rand(2, generator=want)) for d in draws) and len(draws) == 3
    trainer.train(6)  # a second call seeds anew, as JAX's train does
    assert torch.equal(draws[3], draws[0])


# ---------------------------------------------- the example's recipe, 3 steps
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_text_to_image_matches_jax_trainer(jax_tiny, tmp_path, dtype):
    """3 optimizer steps of examples/train_text_to_image.py's recipe (min-SNR
    5, epsilon, lr 1e-5 under a 1,000-step cosine schedule, clip 1.0) at
    batch 4 over 16 samples drawn as the example draws them (at the tiny
    UNet's widths): the JAX Trainer (`data_parallel_degree` 1: the suite's
    8-device CPU would build a mesh) against `build_trainer`, the JAX draws
    of each step (PRNGKey(seed), split a step) replayed through sd_loss.
    Both hold fp32 params and compute in `dtype`."""
    jdt, tdt = DTYPES[dtype]
    steps, batch, lr = 3, 4, 1e-5
    samples = t2i.sd_samples(16, 0, latent_hw=8, context_len=6, context_dim=32)
    jm = JUNet(jax_tiny.config, params=jax.tree_util.tree_map(jnp.array, jax_tiny.params),
               dtype=jdt)
    jsched = JDDPM(**SD15_SCHEDULER)
    seen = []
    args = JTrainingArguments(output_dir=str(tmp_path), learning_rate=lr, max_steps=1000,
                              logging_steps=1, save_steps=1000, benchmark=True,
                              data_parallel_degree=1)
    jtrainer = JTrainer(model=jm, args=args, loss_fn=jtu.make_sd_loss_fn(jm, jsched,
                                                                         snr_gamma=5.0),
                        train_dataloader=JDataLoader(JMapDataset(samples), batch_size=batch,
                                                     shuffle=True),
                        callbacks=[lambda step, metrics: seen.append(
                            (float(metrics["loss"]), float(metrics["grad_norm"])))])
    jtrainer.train(steps)

    tu = _port_unet(jax_tiny.params, TINY_UNET_SD15, tdt)
    sched = DDPMScheduler.from_config(SD15_SCHEDULER)
    trainer = t2i.build_trainer(tu, sched, samples, batch_size=batch)
    assert (trainer.args.learning_rate, trainer.args.max_steps, trainer.args.save_steps) == \
        (lr, 1000, 0)
    keys, rng = [], jax.random.PRNGKey(trainer.args.seed)
    for _ in range(steps):  # the JAX Trainer's keys
        rng, sub = jax.random.split(rng)
        keys.append(sub)

    def replayed(params, batch_, gen):
        t, noise = _jax_draws(keys.pop(0), tuple(batch_["latents"].shape))
        return ttu.sd_loss(tu, sched, batch_, torch.from_numpy(t).long(),
                           torch.from_numpy(noise), snr_gamma=5.0)

    trainer.loss_fn = replayed
    init = {n: p.detach().clone() for n, p in tu.named_parameters()}
    result = trainer.train(steps)
    assert result["final_step"] == steps and not keys
    got = np.asarray([(float(h["loss"]), float(h["grad_norm"])) for h in trainer.history])
    final = flax_to_torch_state_dict(flatten_params(jtrainer.state.params), tu, UNET_KEY_MAP)
    state = dict(tu.named_parameters())
    # every tensor moved on both sides
    assert all(not torch.equal(state[k], init[k]) and not torch.equal(final[k], init[k])
               for k in final)
    errs = np.concatenate([(state[k].detach() - final[k]).abs().numpy().ravel() for k in final])
    moves = np.concatenate([(final[k] - init[k]).abs().numpy().ravel() for k in final])
    if dtype == "fp32":
        # losses and gradient norms within 1.6e-7 relative here
        np.testing.assert_allclose(got, np.asarray(seen), rtol=1e-5, atol=0)
        # Adam's steps are ~lr an element whatever the gradient's size: where
        # a gradient element is near 0 the two sides' rounding moves a share
        # of a step (3e-3 of lr at most here); the bulk agrees far below a
        # step (1.4e-6 of the mean move)
        assert errs.max() <= 0.05 * lr and errs.mean() <= 1e-4 * moves.mean(), \
            (errs.max(), errs.mean(), moves.mean())
    else:
        # losses within 9.6e-4, gradient norms 1.9e-3 relative here
        np.testing.assert_allclose(got[:, 0], np.asarray(seen)[:, 0], rtol=BF16_LOSS_REL, atol=0)
        np.testing.assert_allclose(got[:, 1], np.asarray(seen)[:, 1], rtol=1e-2, atol=0)
        # bf16 rounding can flip a near-0 gradient element's sign: at most
        # twice the largest step JAX took (1.54x here), and a few percent on
        # average (2.1% here)
        assert errs.max() <= 2 * moves.max() and errs.mean() <= 0.1 * moves.mean(), \
            (errs.max(), moves.max(), errs.mean(), moves.mean())


def test_main_raises_where_it_would_read_a_checkpoint():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        t2i.main(["runwayml/stable-diffusion-v1-5"])


def test_sd_samples_are_the_examples():
    """examples/train_text_to_image.py's data: RandomState(0), latents then
    hidden states, sample by sample."""
    rng = np.random.RandomState(0)
    want = [(rng.randn(64, 64, 4), rng.randn(77, 768)) for _ in range(3)]
    got = t2i.sd_samples(3)
    for (lat, ctx), s in zip(want, got):
        assert s["latents"].dtype == np.float32 and s["encoder_hidden_states"].shape == (77, 768)
        np.testing.assert_array_equal(s["latents"], lat.astype(np.float32))
        np.testing.assert_array_equal(s["encoder_hidden_states"], ctx.astype(np.float32))


# ------------------------------------------------------ carrying the weights
def test_jax_fp32_params_carry_into_fp32_masters(jax_tiny):
    """The JAX UNet's fp32 parameters land in the port's fp32 masters bit for
    bit (no bf16 round trip), the model computing in bf16 all the same."""
    tu = random_sd15_unet("cpu", seed=1, unet=TINY_UNET_SD15)
    assert tu.dtype == torch.bfloat16 and tu.conv_in.compute_dtype == torch.bfloat16
    flat = flatten_params(jax_tiny.params)
    tu.load_state_dict(flax_to_torch_state_dict(flat, tu, UNET_KEY_MAP))
    sd = dict(tu.named_parameters())
    assert all(p.dtype == torch.float32 for p in sd.values())
    conv = np.asarray(flat["down_blocks_0.resnets_0.conv1.kernel"])  # HWIO
    np.testing.assert_array_equal(sd["down_blocks.0.resnets.0.conv1.weight"].detach().numpy(),
                                  conv.transpose(3, 2, 0, 1))
    dense = np.asarray(flat["down_blocks_0.attentions_0.transformer_blocks_0.attn1.to_q.kernel"])
    np.testing.assert_array_equal(
        sd["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"].detach().numpy(),
        dense.T)
    norm = np.asarray(flat["down_blocks_0.attentions_0.transformer_blocks_0.norm1.scale"])
    np.testing.assert_array_equal(
        sd["down_blocks.0.attentions.0.transformer_blocks.0.norm1.weight"].detach().numpy(), norm)
    # values that bf16 cannot hold came through
    assert not torch.equal(sd["conv_in.weight"], sd["conv_in.weight"].bfloat16().float())


def test_cast_training_params_makes_fp32_masters():
    """cast_training_params: the trainable floating parameters to fp32 in
    place, values kept, the compute dtype untouched; frozen ones stay."""
    tu = random_sd15_unet("cpu", seed=2, param_dtype=torch.bfloat16, unet=TINY_UNET_SD15)
    tu.conv_out.weight.requires_grad_(False)
    before = {n: p.detach().clone() for n, p in tu.named_parameters()}
    assert ttu.cast_training_params(tu) is tu
    for n, p in tu.named_parameters():
        assert p.dtype == (torch.bfloat16 if n == "conv_out.weight" else torch.float32), n
        assert torch.equal(p.detach().float(), before[n].float()), n
    assert tu.dtype == torch.bfloat16


# ----------------------------------------------------- launches and flops
def test_expected_launches_sd15_train_full_width():
    with torch.device("meta"):  # shapes only: nothing of the model's size is allocated
        unet = UNet2DConditionModel(UNet2DConditionConfig(**SD15_UNET))
    # a micro-batch of 8 at 64x64 latents: the 15 self-attentions at 4,096,
    # 1,024 and 256 tokens (head_dim 40, 80, 160) take flash, forward (B15)
    # and backward (B14); the mid block's 64 tokens and the 77-key
    # cross-attentions take math; 61 GroupNorm forwards (B4)
    assert expected_launches_sd15_train(unet, 8, 64) == {
        "flash_fwd_lse": 15, "flash_bwd_dkv": 15, "flash_bwd_dq": 15, "group_norm": 61,
        "flash_by_dim": {40: 5, 80: 5, 160: 5}}
    assert expected_launches_sd15_train(unet, 8, 64, steps=4)["flash_by_dim"] == \
        {40: 20, 80: 20, 160: 20}


def test_train_step_calls_match_the_walk(monkeypatch):
    """One training micro-batch of a tiny UNet whose 256-token
    self-attentions take flash: the calls of the lse forward, the two
    backward functions and GroupNorm, counted on the CPU (where the kernels'
    counters stay 0), equal the walk's launches."""
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod

    counts = dict.fromkeys(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "group_norm"), 0)

    def counted(mod, name):
        fn = getattr(mod, name)

        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)

    kernels = (tattn.flash_fwd_lse, tattn.flash_bwd_dkv, tattn.flash_bwd_dq)
    for name in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        counted(tattn, name)
    counted(resnet_mod, "group_norm")
    unet = random_sd15_unet("cpu", seed=0, compute_dtype=None, unet=WIDE_UNET_SD15)
    batch = {k: torch.from_numpy(v) for k, v in _batch(5, 2, 16, 5, 24).items()}
    loss = ttu.make_sd_loss_fn(unet, DDPMScheduler.from_config(SD15_SCHEDULER), snr_gamma=5.0)(
        None, batch, torch.Generator().manual_seed(0))
    loss.backward()
    want = expected_launches_sd15_train(unet, 2, 16, context_len=5)
    assert want.pop("flash_by_dim") == {160: 3}
    assert counts == want
    assert [fn.launches for fn in kernels] == [0, 0, 0]


def test_unet_train_flops_count_every_product(monkeypatch):
    """unet_train_flops / 3 equals the forward's conv, Linear and attention
    flops counted on a tiny UNet as it runs (hooks on every module)."""
    from paddlemix_tpu_torch.diffusers.models import attention as attn_mod

    unet = random_sd15_unet("cpu", seed=0, compute_dtype=None, unet=TINY_UNET_SD15)
    total = []

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.Conv2d):
            kh, kw = m.kernel_size
            total.append(2 * out.numel() * m.in_channels // m.groups * kh * kw)
        elif isinstance(m, torch.nn.Linear):
            total.append(2 * out.numel() * m.in_features)
        elif isinstance(m, attn_mod.CrossAttention):
            hidden = inputs[0]
            ctx = inputs[1] if len(inputs) > 1 and inputs[1] is not None else hidden
            total.append(4 * hidden.shape[0] * hidden.shape[1] * ctx.shape[1]
                         * m.num_heads * m.head_dim)

    for m in unet.modules():
        m.register_forward_hook(hook)
    b = _batch(6, 3, 8, 6, 32)
    with torch.no_grad():
        unet(torch.from_numpy(b["latents"]), torch.tensor([10, 500, 900]),
             torch.from_numpy(b["encoder_hidden_states"]))
    assert unet_train_flops(unet, 3, 8, context_len=6) == 3 * sum(total)
