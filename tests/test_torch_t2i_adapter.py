"""The T2I-Adapter slice of the port against the JAX package on the CPU: the
adapter's features at 1 and 3 input channels, the pipeline's latents over 3
steps (DDIM and UniPC, under classifier-free guidance), the training step of
examples/train_t2i_adapter.py (its loss and gradient at fixed draws),
`main` on a tiny pipeline directory, the faults C.29, C.30 and C.32 (ROADMAP),
the directory round trip (C.33) and the launch walk of a training step.

Weights come from the JAX modules' seeded init and are carried over with
`flax_to_torch_state_dict`; inputs are made with numpy. Everything runs in
fp32, so the tolerances (1e-4 of the output's largest magnitude, 1e-4
relative L2 for gradients) cover summation order only."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import DDIMScheduler as JDDIM
from paddlemix_tpu.diffusers import DDPMScheduler as JDDPM
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers.models import AutoencoderKL as JVAE
from paddlemix_tpu.diffusers.models import AutoencoderKLConfig as JVAEConfig
from paddlemix_tpu.diffusers.models import T2IAdapter as JAdapter
from paddlemix_tpu.diffusers.models import T2IAdapterConfig as JAdapterConfig
from paddlemix_tpu.diffusers.models.adapter import pixel_unshuffle as jax_pixel_unshuffle
from paddlemix_tpu.diffusers.pipelines import StableDiffusionAdapterPipeline as JPipe
from paddlemix_tpu.diffusers.pipelines.stable_diffusion import _JitCache
from paddlemix_tpu.diffusers.schedulers import UniPCMultistepScheduler as JUniPC
from paddlemix_tpu_torch.core import T2I_ADAPTER_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    DDIMScheduler,
    DDPMScheduler,
    DiffusionPipeline,
    StableDiffusionAdapterPipeline,
    T2IAdapter,
    T2IAdapterConfig,
    UNet2DConditionConfig,
    UNet2DConditionModel,
    UniPCMultistepScheduler,
)
from paddlemix_tpu_torch.diffusers.models.adapter import pixel_unshuffle
from paddlemix_tpu_torch.diffusers.sd15 import load_flax_sd15_pipeline
from paddlemix_tpu_torch.diffusers.sd15_control import expected_launches_adapter_train
from paddlemix_tpu_torch.models import layers
from paddlemix_tpu_torch.models.clip import CLIPTextModel, CLIPTokenizer
from paddlemix_tpu_torch.tools import train_t2i_adapter as tta
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet
from test_torch_controlnet import _assert_close, _counting, _rel
from test_torch_sd15 import TINY_UNET_SD15, WIDE_UNET_SD15, _text_config

pytestmark = pytest.mark.torch_port

# a four-level tiny VAE: latents at 1/8 of the image, as the example's
# adapter (downscale 8) needs them
VAE8 = dict(block_out_channels=(8, 8, 8, 8), down_block_types=("DownEncoderBlock2D",) * 4,
            up_block_types=("UpDecoderBlock2D",) * 4, layers_per_block=1, latent_channels=4,
            norm_num_groups=4)
SCHED = dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012)


def jax_adapter(in_channels=3, num_res_blocks=1, seed=1, channels=(16, 32)):
    return JAdapter.from_config(JAdapterConfig(in_channels=in_channels, channels=channels,
                                               num_res_blocks=num_res_blocks,
                                               downscale_factor=8), seed=seed)


def port_adapter(jad):
    c = jad.config
    ad = T2IAdapter(T2IAdapterConfig(in_channels=c.in_channels, channels=tuple(c.channels),
                                     num_res_blocks=c.num_res_blocks,
                                     downscale_factor=c.downscale_factor)).eval()
    ad.load_state_dict(flax_to_torch_state_dict(flatten_params(jad.params), ad,
                                                T2I_ADAPTER_KEY_MAP))
    return ad.to(memory_format=torch.channels_last)


# --------------------------------------------------------------- the adapter
@pytest.mark.parametrize("in_channels,num_res_blocks", [(1, 2), (3, 1)])
def test_adapter_features_match_jax(in_channels, num_res_blocks):
    jad = jax_adapter(in_channels, num_res_blocks)
    ad = port_adapter(jad)
    image = np.random.RandomState(0).rand(2, 64, 64, in_channels).astype(np.float32)
    ref = jad(jnp.asarray(image))
    with torch.no_grad():
        out = ad(torch.from_numpy(image))
    assert [tuple(f.shape) for f in out] == [(2, 8, 8, 16), (2, 4, 4, 32)]
    for r, o in zip(ref, out):
        _assert_close(r, o)


@pytest.mark.parametrize("c", [1, 3])
def test_pixel_unshuffle_keeps_jax_channel_order_c29(c):
    """C.29: JAX lays the unshuffled channels out (fh, fw, c), diffusers'
    nn.PixelUnshuffle (c, fh, fw): the port keeps JAX's, which differs from
    torch's for 3 channels and matches it for 1."""
    x = np.random.RandomState(1).randn(2, 16, 16, c).astype(np.float32)
    ref = np.asarray(jax_pixel_unshuffle(jnp.asarray(x), 8))
    out = pixel_unshuffle(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(out, ref)
    torch_order = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
    assert np.array_equal(torch_order.numpy(), out) == (c == 1)


@pytest.mark.parametrize("adapter_type", ["full_adapter_xl", "light_adapter"])
def test_other_adapter_types_are_refused_c30(adapter_type):
    """C.30: JAX's config takes `adapter_type` and its module never reads it
    (the same full adapter's parameters); the port refuses it by name."""
    full = jax_adapter(seed=2)
    other = JAdapter.from_config(JAdapterConfig(channels=(16, 32), num_res_blocks=1,
                                                downscale_factor=8, adapter_type=adapter_type),
                                 seed=2)
    a, b = flatten_params(full.params), flatten_params(other.params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(NotImplementedError, match=adapter_type):
        T2IAdapterConfig(adapter_type=adapter_type)
    with pytest.raises(NotImplementedError, match=adapter_type):
        T2IAdapterConfig.from_dict({"adapter_type": adapter_type})


# ------------------------------------------------------------- the pipeline
@pytest.fixture(scope="module")
def pipes():
    jtok = tiny_tokenizer()
    jad = jax_adapter(seed=4)
    jpipe = JPipe(vae=JVAE.from_config(JVAEConfig(**VAE8)), text_encoder=tiny_text_encoder(jtok),
                  tokenizer=jtok, unet=tiny_unet(ctx_dim=32), adapter=jad, scheduler=JDDIM())
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    pipe = StableDiffusionAdapterPipeline(
        vae=AutoencoderKL(AutoencoderKLConfig(**VAE8)),
        text_encoder=CLIPTextModel(_text_config(tok)), tokenizer=tok,
        unet=UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SD15)),
        adapter=port_adapter(jad), scheduler=DDIMScheduler())
    load_flax_sd15_pipeline(pipe, {"unet": jpipe.unet.params, "vae": jpipe.vae.params,
                                   "text_encoder": jpipe.text_encoder.params})
    rs = np.random.RandomState(0)
    latents = rs.randn(1, 8, 8, 4).astype(np.float32)
    image = (rs.rand(64, 64, 3) > 0.8).astype(np.float32) * 255  # an edge map in 0-255
    return jpipe, pipe, latents, image


CALL = dict(prompt="a cat", negative_prompt="blurry", height=64, width=64,
            num_inference_steps=3, guidance_scale=7.5, adapter_conditioning_scale=0.8)


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_pipeline_latents_match_jax(pipes, scheduler):
    jpipe, pipe, latents, image = pipes
    if scheduler == "unipc":
        jpipe.scheduler, pipe.scheduler = JUniPC(**SCHED), UniPCMultistepScheduler(**SCHED)
    jpipe._jit = _JitCache()  # JAX's cache keeps the loop it built, scheduler and all
    try:
        ref = jpipe(image=image, latents=jnp.asarray(latents), output_type="latent", **CALL)[0]
        out = pipe(image=image, latents=latents, output_type="latent", **CALL)[0]
        plain = pipe(image=image, latents=latents, output_type="latent",
                     **dict(CALL, adapter_conditioning_scale=0.0))[0]
    finally:
        jpipe.scheduler, pipe.scheduler = JDDIM(), DDIMScheduler()
    _assert_close(ref, out)
    assert _rel(plain, out) > 1e-3  # the features reach the latents


def test_directory_round_trip_c33(pipes, tmp_path):
    """C.33: JAX's pipeline replaces its components by the adapter alone, so
    its save_pretrained writes the adapter and nothing else; the port's
    writes every component, which JAX's from_pretrained reads back."""
    jpipe, pipe, _, _ = pipes
    jpipe.save_pretrained(str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "model_index.json") as f:
        assert set(json.load(f)) == {"_class_name", "adapter"}
    pipe.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "model_index.json") as f:
        index = json.load(f)
    assert {"vae", "text_encoder", "tokenizer", "unet", "scheduler", "adapter"} <= set(index)
    back = DiffusionPipeline.from_pretrained(str(tmp_path / "port"), device="cpu")
    assert isinstance(back, StableDiffusionAdapterPipeline)
    assert all(torch.equal(v, back.adapter.state_dict()[k])
               for k, v in pipe.adapter.state_dict().items())
    jback = JDiffusionPipeline.from_pretrained(str(tmp_path / "port"))
    want, got = flatten_params(jpipe.adapter.params), flatten_params(jback.adapter.params)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)


def test_pipeline_feeds_the_adapter_0_1_c32(pipes):
    """C.32: the pipeline feeds the adapter [0, 1] (an image over 1.5 divided
    by 255), where the example's trainer feeds it [-1, 1]."""
    _, pipe, latents, image = pipes
    seen = []
    hook = pipe.adapter.register_forward_pre_hook(lambda m, inp: seen.append(inp[0]))
    try:
        pipe(image=image, latents=latents, output_type="latent", **CALL)
    finally:
        hook.remove()
    assert float(seen[0].min()) == 0.0 and float(seen[0].max()) == 1.0


# ---------------------------------------------------------------- training
def _jax_step_loss(jpipe, jad_params, jad, images, controls, key, ctx_one):
    """The example's loss_fn (examples/train_t2i_adapter.py's `step`), as it
    is written there, over the adapter's params."""
    vae, unet, sched = jpipe.vae, jpipe.unet, jpipe.scheduler
    kz, kt, kn = jax.random.split(key, 3)
    lat = vae.encode(images * 2 - 1).sample(kz) * vae.config.scaling_factor
    t = jax.random.randint(kt, (lat.shape[0],), 0, 1000)
    noise = jax.random.normal(kn, lat.shape)
    noisy = sched.add_noise(lat, noise, t)
    feats = jad.module.apply({"params": jad_params}, (controls * 2 - 1).astype(jad.dtype))
    ctx = jnp.broadcast_to(ctx_one, (lat.shape[0],) + ctx_one.shape[1:])
    pred = unet.module.apply({"params": unet.params}, noisy.astype(unet.dtype),
                             t.astype(jnp.float32), ctx.astype(unet.dtype),
                             down_intrablock_additional_residuals=[f.astype(jnp.float32)
                                                                   for f in feats]
                             ).astype(jnp.float32)
    return jnp.mean((pred - noise) ** 2)


def test_training_step_loss_and_grads_match_jax(pipes):
    jpipe, pipe, _, _ = pipes
    jpipe.scheduler, pipe.scheduler = JDDPM(**SCHED), DDPMScheduler(**SCHED)
    try:
        img, ctl = tta.synthetic_pair(np.random.default_rng(0), 2, 64)
        ids = jpipe.tokenizer(["a square"])["input_ids"]
        ctx_one = jpipe.text_encoder(jnp.asarray(ids))[0]
        key = jax.random.PRNGKey(3)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: _jax_step_loss(jpipe, p, jpipe.adapter, jnp.asarray(img), jnp.asarray(ctl),
                                     key, ctx_one)))(jpipe.adapter.params)
        # JAX's draws, replayed
        kz, kt, kn = jax.random.split(key, 3)
        post = jpipe.vae.encode(jnp.asarray(img) * 2 - 1)
        z = np.array(jax.random.normal(kz, post.mean.shape, post.mean.dtype))
        t = np.array(jax.random.randint(kt, (2,), 0, 1000))
        noise = np.array(jax.random.normal(kn, post.mean.shape))
        with torch.no_grad():
            context = pipe.text_encoder(torch.as_tensor(ids))[0]
        ad = pipe.adapter
        params = list(ad.parameters())
        loss = tta.adapter_loss(pipe, ad, torch.from_numpy(img), torch.from_numpy(ctl), context,
                                torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(noise))
        grads = torch.autograd.grad(loss, params)
    finally:
        jpipe.scheduler, pipe.scheduler = JDDIM(), DDIMScheduler()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = flax_to_torch_state_dict(flatten_params(jgrads), ad, T2I_ADAPTER_KEY_MAP)
    gaps = {n: _rel(g, want[n]) for (n, _), g in zip(ad.named_parameters(), grads)}
    assert max(gaps.values()) < 1e-4, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]


def test_synthetic_pair_is_the_examples():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "train_t2i_adapter.py")
    spec = importlib.util.spec_from_file_location("train_t2i_adapter", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    a = mod.synthetic_pair(np.random.default_rng(5), 3, 64)
    b = tta.synthetic_pair(np.random.default_rng(5), 3, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_main_trains_and_saves_the_adapter(pipes, tmp_path):
    """main --pretrained on a tiny directory: the adapter at the UNet's
    widths (downscale 8), trained 3 steps with finite losses, every
    parameter moved, saved and read back by both packages; the trainer feeds
    it controls in [-1, 1] (C.32)."""
    _, pipe, _, _ = pipes
    pipe.save_pretrained(str(tmp_path / "pipe"))
    seen = []
    real = tta.adapter_loss

    def spy(pipe_, adapter, images, controls, *a):
        seen.append(controls * 2 - 1)
        return real(pipe_, adapter, images, controls, *a)

    tta.adapter_loss = spy
    try:
        adapter, losses, _ = tta.main(["--pretrained", str(tmp_path / "pipe"), "--steps", "3",
                                       "--batch", "2", "--resolution", "64", "--output",
                                       str(tmp_path / "out")], device="cpu")
    finally:
        tta.adapter_loss = real
    assert adapter.config.channels == (16, 32) and adapter.config.downscale_factor == 8
    assert len(losses) == 3 and all(np.isfinite(float(x)) for x in losses)
    first = tta.adapter_for(pipe.unet, 0, "cpu")
    assert all(not torch.equal(p, first.state_dict()[n]) for n, p in adapter.state_dict().items())
    back = T2IAdapter.from_pretrained(str(tmp_path / "out"), device="cpu")
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in adapter.state_dict().items())
    jback = JAdapter.from_pretrained(str(tmp_path / "out"))
    ours = flax_to_torch_state_dict(flatten_params(jback.params), back, T2I_ADAPTER_KEY_MAP)
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in ours.items())
    assert all(float(c.min()) == -1.0 and float(c.max()) == 1.0 for c in seen)


def test_main_without_pretrained_is_refused():
    with pytest.raises(NotImplementedError, match="--pretrained"):
        tta.main(["--steps", "1"], device="cpu")


def test_train_step_calls_match_the_walk(monkeypatch, tmp_path):
    """One training step over a UNet whose 256-token self-attentions take
    flash: down block 0's attention sees no gradient (B1), the up block's
    two train (B15, B14); the VAE encoder's GroupNorms and the prompt's text
    tower once; the calls counted on the CPU equal the walk."""
    tok = CLIPTokenizer(tiny_tokenizer().encoder, [], model_max_length=16)
    gen = torch.Generator().manual_seed(0)
    from paddlemix_tpu_torch.core import init_weights_

    pipe = StableDiffusionAdapterPipeline(
        vae=init_weights_(AutoencoderKL(AutoencoderKLConfig(**VAE8)), gen),
        text_encoder=init_weights_(CLIPTextModel(_text_config(tok, dim=24)), gen), tokenizer=tok,
        unet=init_weights_(UNet2DConditionModel(UNet2DConditionConfig(**WIDE_UNET_SD15)), gen),
        adapter=None, scheduler=DDPMScheduler(**SCHED))
    counts = dict.fromkeys(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "flash_attention",
                            "group_norm"), 0)
    _counting(monkeypatch, counts)
    ln = []
    pipe.save_pretrained(str(tmp_path / "pipe"))  # adapter None: main builds its own
    read = []
    real = tta.DiffusionPipeline.from_pretrained

    def counted_read(*a, **kw):  # the pipeline main reads, its text tower's B10 counted
        read.append(real(*a, **kw))
        for m in read[0].text_encoder.modules():
            if isinstance(m, layers.FusedLayerNorm):
                m.register_forward_pre_hook(lambda mod, inp: ln.append(1))
        return read[0]

    monkeypatch.setattr(tta.DiffusionPipeline, "from_pretrained", counted_read)
    tta.main(["--pretrained", str(tmp_path / "pipe"), "--steps", "1", "--batch", "2",
              "--resolution", "128", "--output", str(tmp_path / "out")], device="cpu")
    want = expected_launches_adapter_train(pipe, 2, 128)
    # B1: the UNet's down block 0 and the VAE encoder's mid-block attention (256 tokens)
    assert want["by_dim"]["flash_fwd_lse"] == {160: 2} and want["flash_attention"] == 2
    assert counts == {k: want.get(k, 0) for k in counts}
    assert len(ln) == want["layer_norm"]
