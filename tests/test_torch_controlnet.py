"""The ControlNet slice of the port against the JAX package on the CPU: the
ControlNet's residuals (its zero-initialised convs filled with seeded
values, so that no residual is zero; also the SDXL `text_time` form), the
UNet under each residual kind, with the channels_last format of every map
its GroupNorms read, the pipeline's latents over 3 steps (DDIM through JAX's
pipeline, UniPC through JAX's modules stepped as the pipeline steps them),
the loss of examples/train_controlnet.py and its gradient at fixed draws,
the directory round trip both ways, the faults C.13 and C.30 (ROADMAP), and
the launch walks of the pipeline and of a training step.

Weights come from the JAX modules' seeded init and are carried over with
`flax_to_torch_state_dict`; inputs are made with numpy. Everything runs in
fp32, so the tolerances (1e-4 of the output's largest magnitude, 1e-4
relative L2 for gradients) cover summation order only."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params, unflatten_params
from paddlemix_tpu.diffusers import ControlNetConfig as JCNConfig
from paddlemix_tpu.diffusers import ControlNetModel as JCN
from paddlemix_tpu.diffusers import DDIMScheduler as JDDIM
from paddlemix_tpu.diffusers import DDPMScheduler as JDDPM
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers import StableDiffusionControlNetPipeline as JPipe
from paddlemix_tpu.diffusers.pipelines.stable_diffusion import _JitCache
from paddlemix_tpu.diffusers.schedulers import UniPCMultistepScheduler as JUniPC
from paddlemix_tpu_torch.core import CONTROLNET_KEY_MAP, UNET_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.core import safetensors as st
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    ControlNetConfig,
    ControlNetModel,
    DDIMScheduler,
    DDPMScheduler,
    DiffusionPipeline,
    StableDiffusionControlNetPipeline,
    UNet2DConditionConfig,
    UNet2DConditionModel,
    UniPCMultistepScheduler,
)
from paddlemix_tpu_torch.diffusers.models.resnet import GroupNormAct, n_group_norms
from paddlemix_tpu_torch.diffusers.sd15 import SD15_UNET, load_flax_sd15_pipeline
from paddlemix_tpu_torch.diffusers.sd15_control import (
    SD15_CONTROLNET,
    expected_launches_controlnet,
    expected_launches_controlnet_train,
)
from paddlemix_tpu_torch.models.clip import CLIPTextModel, CLIPTokenizer
from paddlemix_tpu_torch.models.clip.tokenizer import byte_level_tokenizer
from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.tools import train_controlnet as tcn
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae
from test_torch_sd15 import TINY_UNET_SD15, WIDE_UNET_SD15, _text_config
from test_torch_sdxl_modules import TINY_VAE

pytestmark = pytest.mark.torch_port

# the tiny SD1.5-layout UNet's encoder, its control image at 2x the latents'
# side (the tiny two-level VAE's factor)
TINY_CN = dict(TINY_UNET_SD15, conditioning_embedding_out_channels=(8, 16))
TEXT_TIME = dict(addition_embed_type="text_time", addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=16 + 6 * 8)
ZERO_CONVS = ("controlnet_down_blocks_", "controlnet_mid_block",
              "controlnet_cond_embedding.conv_out")


def _assert_close(ref, out, tol=1e-4):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _rel(a, b):
    a, b = (np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)
            for t in (a, b))
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_controlnet(config, seed=1):
    """The JAX ControlNet of `config` from its seeded init, its
    zero-initialised convs filled with seeded fan-in-scaled normals."""
    jcn = JCN.from_config(JCNConfig.from_dict(config), seed=seed)
    flat = flatten_params(jcn.params)
    rs = np.random.RandomState(seed + 1)
    for k, v in flat.items():
        if k.startswith(ZERO_CONVS):
            shape = np.asarray(v).shape
            fan = int(np.prod(shape[:-1])) if len(shape) > 1 else 4
            flat[k] = jnp.asarray((rs.randn(*shape) / np.sqrt(fan)).astype(np.float32))
    jcn.params = unflatten_params(flat)
    return jcn


def port_controlnet(jcn, config):
    cn = ControlNetModel(ControlNetConfig.from_dict(config)).eval()
    cn.load_state_dict(flax_to_torch_state_dict(flatten_params(jcn.params), cn,
                                                CONTROLNET_KEY_MAP))
    return cn.to(memory_format=torch.channels_last)


def port_unet(junet, config):
    u = UNet2DConditionModel(UNet2DConditionConfig(**config)).eval()
    u.load_state_dict(flax_to_torch_state_dict(flatten_params(junet.params), u, UNET_KEY_MAP))
    return u.to(memory_format=torch.channels_last)


def _inputs(seed, b=2, hw=8, ctx_len=5, ctx_dim=32, factor=2):
    rs = np.random.RandomState(seed)
    return dict(lat=rs.randn(b, hw, hw, 4).astype(np.float32),
                t=np.asarray([10, 700][:b]),
                ctx=rs.randn(b, ctx_len, ctx_dim).astype(np.float32),
                cond=rs.rand(b, hw * factor, hw * factor, 3).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    jcn = jax_controlnet(TINY_CN)
    ju = tiny_unet(ctx_dim=32)
    return jcn, port_controlnet(jcn, TINY_CN), ju, port_unet(ju, TINY_UNET_SD15)


# ------------------------------------------------------------ the ControlNet
@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_controlnet_residuals_match_jax(models, scale):
    jcn, cn, _, _ = models
    x = _inputs(0)
    jd, jm = jcn.module.apply({"params": jcn.params}, *(jnp.asarray(x[k]) for k in
                                                         ("lat", "t", "ctx", "cond")), scale)
    with torch.no_grad():
        td, tm = cn(*(torch.from_numpy(x[k]) for k in ("lat", "t", "ctx", "cond")), scale)
    # conv_in's skip, down block 0's layer and downsampler, down block 1's layer
    assert [tuple(r.shape) for r in td] == [(2, 8, 8, 16), (2, 8, 8, 16), (2, 4, 4, 16),
                                            (2, 4, 4, 32)]
    for ref, out in zip(list(jd) + [jm], list(td) + [tm]):
        assert float(np.abs(np.asarray(ref)).std()) > 0.1  # the filled zero convs: no zero residual
        _assert_close(ref, out)


def test_text_time_controlnet_matches_jax():
    config = dict(TINY_CN, **TEXT_TIME)
    jcn = jax_controlnet(config, seed=3)
    cn = port_controlnet(jcn, config)
    x = _inputs(1)
    rs = np.random.RandomState(9)
    added = {"text_embeds": rs.randn(2, 16).astype(np.float32),
             "time_ids": np.asarray([[32, 32, 0, 0, 32, 32], [64, 48, 4, 0, 32, 32]],
                                    np.float32)}
    jd, jm = jcn.module.apply({"params": jcn.params}, *(jnp.asarray(x[k]) for k in
                                                         ("lat", "t", "ctx", "cond")),
                              added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        td, tm = cn(*(torch.from_numpy(x[k]) for k in ("lat", "t", "ctx", "cond")),
                    added_cond_kwargs={k: torch.from_numpy(v) for k, v in added.items()})
    for ref, out in zip(list(jd) + [jm], list(td) + [tm]):
        _assert_close(ref, out)
    # the addition embedding moves the residuals: without it they differ
    with torch.no_grad():
        _, tm_plain = cn(*(torch.from_numpy(x[k]) for k in ("lat", "t", "ctx", "cond")))
    assert _rel(tm_plain, tm) > 1e-3


# ------------------------------------------------------------ the UNet hooks
def _residuals(seed):
    """NHWC residuals of the tiny UNet's shapes: four skips, the mid block,
    one intrablock a down block."""
    rs = np.random.RandomState(seed)
    down = [rs.randn(*s).astype(np.float32) for s in
            ((2, 8, 8, 16), (2, 8, 8, 16), (2, 4, 4, 16), (2, 4, 4, 32))]
    return {"down_block_additional_residuals": down,
            "mid_block_additional_residual": rs.randn(2, 4, 4, 32).astype(np.float32),
            "down_intrablock_additional_residuals": [rs.randn(2, 8, 8, 16).astype(np.float32),
                                                     rs.randn(2, 4, 4, 32).astype(np.float32)]}


KINDS = {"down": ("down_block_additional_residuals",),
         "mid": ("mid_block_additional_residual",),
         "intrablock": ("down_intrablock_additional_residuals",),
         "all": ("down_block_additional_residuals", "mid_block_additional_residual",
                 "down_intrablock_additional_residuals")}


def _as(fn, v):
    return [fn(a) for a in v] if isinstance(v, list) else fn(v)


@pytest.mark.parametrize("kind", list(KINDS))
def test_unet_residual_kinds_match_jax(models, kind):
    _, _, ju, u = models
    x, res = _inputs(2), _residuals(4)
    kw = {k: res[k] for k in KINDS[kind]}
    ref = ju.module.apply({"params": ju.params}, jnp.asarray(x["lat"]), jnp.asarray(x["t"]),
                          jnp.asarray(x["ctx"]), **{k: _as(jnp.asarray, v) for k, v in kw.items()})
    plain = ju.module.apply({"params": ju.params}, jnp.asarray(x["lat"]), jnp.asarray(x["t"]),
                            jnp.asarray(x["ctx"]))
    with torch.no_grad():
        out = u(torch.from_numpy(x["lat"]), torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]),
                **{k: _as(torch.from_numpy, v) for k, v in kw.items()})
    assert _rel(plain, ref) > 1e-2  # the residuals reach the output
    _assert_close(ref, out)


def test_unet_residual_sums_keep_channels_last(models):
    """Every map a GroupNorm (B4) reads stays channels_last under the
    residuals, so its kernel takes the map in place; the residuals are
    contiguous NHWC tensors, as the ControlNet and the adapter give them."""
    _, _, _, u = models
    x, res = _inputs(3), _residuals(5)
    formats = []
    hooks = [m.register_forward_pre_hook(lambda mod, inp: formats.append(
        inp[0].is_contiguous(memory_format=torch.channels_last)))
        for m in u.modules() if isinstance(m, GroupNormAct)]
    try:
        with torch.no_grad():
            u(torch.from_numpy(x["lat"]), torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]),
              **{k: _as(torch.from_numpy, v) for k, v in res.items()})
    finally:
        for h in hooks:
            h.remove()
    assert len(formats) == n_group_norms(u) and all(formats)


# ------------------------------------------------------------- the pipeline
@pytest.fixture(scope="module")
def pipes():
    jtok = tiny_tokenizer()
    jcn = jax_controlnet(TINY_CN, seed=5)
    jpipe = JPipe(vae=tiny_vae(), text_encoder=tiny_text_encoder(jtok), tokenizer=jtok,
                  unet=tiny_unet(ctx_dim=32), controlnet=jcn, scheduler=JDDIM())
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    pipe = StableDiffusionControlNetPipeline(
        vae=AutoencoderKL(AutoencoderKLConfig(**TINY_VAE)),
        text_encoder=CLIPTextModel(_text_config(tok)), tokenizer=tok,
        unet=UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SD15)),
        controlnet=port_controlnet(jcn, TINY_CN), scheduler=DDIMScheduler())
    load_flax_sd15_pipeline(pipe, {"unet": jpipe.unet.params, "vae": jpipe.vae.params,
                                   "text_encoder": jpipe.text_encoder.params})
    rs = np.random.RandomState(0)
    latents = rs.randn(1, 16, 16, 4).astype(np.float32)
    control = (rs.rand(32, 32, 3) * 255).astype(np.float32)  # 0-255: divided by 255
    return jpipe, pipe, latents, control


CALL = dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=3, guidance_scale=7.5, controlnet_conditioning_scale=0.8)


def test_pipeline_latents_match_jax_ddim(pipes):
    jpipe, pipe, latents, control = pipes
    ref = jpipe(image=control, latents=jnp.asarray(latents), output_type="latent", **CALL)[0]
    out = pipe(image=control, latents=latents, output_type="latent", **CALL)[0]
    _assert_close(ref, out)
    # without the ControlNet's residuals the latents differ
    with torch.no_grad():
        zero = pipe(image=control, latents=latents, output_type="latent",
                    **dict(CALL, controlnet_conditioning_scale=0.0))[0]
    assert _rel(zero, out) > 1e-3


def test_pipeline_latents_match_jax_unipc(pipes):
    """UniPC, the scheduler of diffusers' ControlNet guide: JAX's pipeline
    sets its timesteps without the latents' shape, so its compiled loop
    cannot carry UniPC's history (ROADMAP C.34); the reference here is JAX's
    modules and scheduler stepped in the pipeline's order."""
    jpipe, pipe, latents, control = pipes
    js = JUniPC(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012)
    jpipe.scheduler, jpipe._jit = js, _JitCache()  # JAX's cache keeps the loop it built
    try:
        with pytest.raises(TypeError, match="x0_prev"):
            jpipe(image=control, latents=jnp.asarray(latents), output_type="latent", **CALL)
    finally:
        jpipe.scheduler, jpipe._jit = JDDIM(), _JitCache()
    cond, uncond = jpipe.encode_prompt(CALL["prompt"], CALL["negative_prompt"])
    context = jnp.concatenate([uncond, cond])
    ctl = jnp.asarray(control / 255.0)[None]
    ctl = jnp.concatenate([ctl, ctl])
    state = js.set_timesteps(3, sample_shape=latents.shape)
    lat = jnp.asarray(latents)
    g = CALL["guidance_scale"]
    for i in range(3):
        lat_in = jnp.concatenate([lat, lat])
        t_in = jnp.broadcast_to(state.timesteps[i], (2,))
        down, mid = jpipe.controlnet.module.apply({"params": jpipe.controlnet.params}, lat_in,
                                                  t_in, context, ctl, 0.8)
        pred = jpipe.unet.module.apply({"params": jpipe.unet.params}, lat_in, t_in, context,
                                       down_block_additional_residuals=down,
                                       mid_block_additional_residual=mid)
        un, co = jnp.split(pred, 2)
        lat, state = js.step(state, un + g * (co - un), i, lat)
    pipe.scheduler = UniPCMultistepScheduler(beta_schedule="scaled_linear", beta_start=0.00085,
                                             beta_end=0.012)
    try:
        out = pipe(image=control, latents=latents, output_type="latent", **CALL)[0]
    finally:
        pipe.scheduler = DDIMScheduler()
    _assert_close(lat, out)


def test_pipeline_refuses_a_control_image_of_another_size(pipes):
    _, pipe, latents, control = pipes
    with pytest.raises(ValueError, match="32 x 32"):
        pipe(image=control[:16, :16], latents=latents, output_type="latent", **CALL)


# ---------------------------------------------------------------- training
def _example(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_controlnet_loss_and_grads_match_jax(models):
    """make_controlnet_loss_fn of examples/train_controlnet.py and the
    gradient over the ControlNet's parameters, the frozen UNet's activations
    carrying it; the port's `controlnet_loss` replays JAX's draws."""
    jcn, cn, ju, u = models
    mod = _example("train_controlnet.py")
    x = _inputs(6)
    batch = {"latents": x["lat"], "encoder_hidden_states": x["ctx"], "conditioning": x["cond"]}
    key = jax.random.PRNGKey(11)
    jloss, jgrads = jax.jit(jax.value_and_grad(mod.make_controlnet_loss_fn(ju, jcn, JDDPM())))(
        jcn.params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_t, k_n = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (2,), 0, 1000))
    noise = np.array(jax.random.normal(k_n, x["lat"].shape, jnp.float32))
    for p in u.parameters():
        p.requires_grad_(False)
    params = [p for p in cn.parameters()]
    loss = tcn.controlnet_loss(u, cn, DDPMScheduler(), {k: torch.from_numpy(v)
                                                         for k, v in batch.items()},
                               torch.from_numpy(t), torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = flax_to_torch_state_dict(flatten_params(jgrads), cn, CONTROLNET_KEY_MAP)
    names = [n for n, _ in cn.named_parameters()]
    gaps = {n: _rel(g, want[n]) for n, g in zip(names, grads)}
    assert max(gaps.values()) < 1e-4, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    # the zero convs' gradients are live: the UNet's activations carry them
    assert all(float(g.abs().max()) > 0 for n, g in zip(names, grads)
               if n.startswith("controlnet_down_blocks"))


def test_loss_fn_draws_from_its_generator(models):
    _, cn, _, u = models
    x = _inputs(7)
    batch = {"latents": torch.from_numpy(x["lat"]),
             "encoder_hidden_states": torch.from_numpy(x["ctx"]),
             "conditioning": torch.from_numpy(x["cond"])}
    fn = tcn.make_controlnet_loss_fn(u, cn, DDPMScheduler())
    assert not any(p.requires_grad for p in u.parameters())  # the UNet frozen
    with torch.no_grad():
        a = fn(None, batch, torch.Generator().manual_seed(0))
        b = fn(None, batch, torch.Generator().manual_seed(0))
        c = fn(None, batch, torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(0)
        t = torch.randint(0, 1000, (2,), generator=gen)
        noise = torch.randn(x["lat"].shape, generator=gen)
        want = tcn.controlnet_loss(u, cn, DDPMScheduler(), batch, t, noise)
    assert torch.equal(a, b) and torch.equal(a, want) and not torch.equal(a, c)


def test_controlnet_samples_are_the_examples():
    rng = np.random.RandomState(0)
    first = {"latents": rng.randn(64, 64, 4), "encoder_hidden_states": rng.randn(77, 768),
             "conditioning": rng.rand(512, 512, 3)}
    got = tcn.controlnet_samples(n=2)
    assert len(got) == 2 and all(np.array_equal(got[0][k], first[k].astype(np.float32))
                                 for k in first)


def test_main_trains_the_controlnet_of_a_directory(pipes, tmp_path):
    """train_controlnet.main on a tiny pipeline directory: the Trainer holds
    the ControlNet's parameters alone, every one moves, the UNet's do not."""
    _, pipe, _, _ = pipes
    pipe.save_pretrained(str(tmp_path / "pipe"))
    trainer, result = tcn.main([str(tmp_path / "pipe")], device="cpu", max_steps=2,
                               output_dir=str(tmp_path / "out"), save_steps=0,
                               weight_decay=0.01)
    assert result["final_step"] == 2 and np.isfinite(result["loss"])
    cn = trainer.model
    assert isinstance(cn, ControlNetModel) and set(trainer.params) == {
        n for n, _ in cn.named_parameters()}
    before = ControlNetModel.from_pretrained(str(tmp_path / "pipe"), subfolder="controlnet",
                                             device="cpu")
    moved = [not torch.equal(p, before.state_dict()[n]) for n, p in cn.state_dict().items()]
    assert all(moved)
    # the weight-decay mask is JAX's, on the flax names: no decay for the
    # time embedding's Dense kernels ("embedding" in the name), decay for a conv
    mask = trainer.tx.decay_mask
    assert not mask("time_embedding.linear_1.weight", cn.time_embedding.linear_1.weight)
    assert mask("controlnet_down_blocks.0.weight", cn.controlnet_down_blocks[0].weight)


# ------------------------------------------------------ directories and C.13
def test_directory_round_trip_both_ways(pipes, tmp_path):
    jpipe, pipe, _, _ = pipes
    jpipe.save_pretrained(str(tmp_path / "jax"))
    back = DiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back, StableDiffusionControlNetPipeline)
    assert isinstance(back.scheduler, DDIMScheduler)
    mine, theirs = pipe.controlnet.state_dict(), back.controlnet.state_dict()
    assert mine.keys() == theirs.keys() and all(torch.equal(v, theirs[k]) for k, v in mine.items())
    pipe.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "model_index.json") as f:
        index = json.load(f)
    assert index["controlnet"] == ["paddlemix_tpu_torch", "ControlNetModel"]
    jback = JDiffusionPipeline.from_pretrained(str(tmp_path / "port"))
    assert type(jback).__name__ == "StableDiffusionControlNetPipeline"
    want, got = flatten_params(jpipe.controlnet.params), flatten_params(jback.controlnet.params)
    assert want.keys() == got.keys()
    assert all(np.array_equal(np.asarray(want[k]), np.asarray(got[k])) for k in want)


def test_square_time_embedding_linear_2_reads_transposed_c13(models, tmp_path):
    """C.13 reaches the ControlNet: in a diffusers-keyed file JAX takes every
    `.weight` under a path naming an embedding for a table, so it leaves the
    square `time_embedding.linear_2.weight` untransposed; the port asks the
    owning module and reads every tensor as written."""
    _, cn, _, _ = models
    sub = tmp_path / "controlnet"
    os.makedirs(sub)
    cfg = dict(cn.config.to_dict(), _class_name="ControlNetModel")
    with open(sub / "config.json", "w") as f:
        json.dump(cfg, f, default=list)
    st.save_file({k: v.contiguous() for k, v in cn.state_dict().items()},
                 str(sub / "diffusion_pytorch_model.safetensors"))
    back = ControlNetModel.from_pretrained(str(tmp_path), subfolder="controlnet", device="cpu")
    mine, theirs = cn.state_dict(), back.state_dict()
    assert all(torch.equal(v, theirs[k]) for k, v in mine.items())
    w = cn.time_embedding.linear_2.weight.detach().numpy()
    assert w.shape[0] == w.shape[1] and not np.allclose(w, w.T)
    jback = JCN.from_pretrained(str(tmp_path), subfolder="controlnet")
    kernel = np.asarray(flatten_params(jback.params)["time_embedding.linear_2.kernel"])
    np.testing.assert_array_equal(kernel, w)  # JAX's: the (out, in) matrix as its kernel


# ---------------------------------------------------------------- C.30
@pytest.mark.parametrize("key,value", [("global_pool_conditions", True),
                                       ("controlnet_conditioning_channel_order", "bgr")])
def test_options_jax_drops_unread_are_refused_c30(key, value):
    """JAX's config drops the key (it has no field) and computes as without
    it; the port refuses the value by name and takes the default."""
    jcfg = JCNConfig.from_dict(dict(TINY_CN, **{key: value}))
    assert jcfg.unused_kwargs == {key: value} and not hasattr(jcfg, key)
    with pytest.raises(NotImplementedError, match=key):
        ControlNetConfig.from_dict(dict(TINY_CN, **{key: value}))
    default = {"global_pool_conditions": False, "controlnet_conditioning_channel_order": "rgb"}
    assert ControlNetConfig.from_dict(dict(TINY_CN, **{key: default[key]})).unused_kwargs == {
        key: default[key]}


# ---------------------------------------------------------------- the walks
def _meta_pipe():
    tok = byte_level_tokenizer()
    from paddlemix_tpu_torch.diffusers.sd15 import SD15_TEXT_ENCODER, SD15_VAE
    from paddlemix_tpu_torch.models.clip import CLIPTextConfig

    with torch.device("meta"):
        return StableDiffusionControlNetPipeline(
            vae=AutoencoderKL(AutoencoderKLConfig(**SD15_VAE)),
            text_encoder=CLIPTextModel(CLIPTextConfig(
                **SD15_TEXT_ENCODER, eos_token_id=tok.eos_token_id,
                max_position_embeddings=tok.model_max_length)),
            tokenizer=tok, unet=UNet2DConditionModel(UNet2DConditionConfig(**SD15_UNET)),
            controlnet=ControlNetModel(ControlNetConfig.from_dict(SD15_CONTROLNET)),
            scheduler=UniPCMultistepScheduler())


def test_controlnet_walks_at_full_width():
    """A 512 px request of 20 UniPC steps under CFG: the UNet's 15 flash
    self-attentions and the ControlNet's 6 every step (4,096, 1,024 and 256
    tokens at head_dim 40, 80 and 160), the ControlNet's 27 GroupNorms every
    step; a training step at batch 4: the ControlNet's 6 attentions and the
    UNet's 9 in its mid and up blocks train (B15, B14), the UNet's 6 down
    ones run B1."""
    pipe = _meta_pipe()
    assert n_group_norms(pipe.controlnet) == 27
    sd = expected_launches_controlnet(pipe, 512, 512, 20, 7.5)
    assert sd["flash_attention"] == 21 * 20
    assert sd["flash_attention_by_dim"] == {40: 140, 80: 140, 160: 140}
    assert sd["group_norm"] == (61 + 27) * 20 + n_group_norms(pipe.vae.decoder)
    tr = expected_launches_controlnet_train(pipe.unet, pipe.controlnet, 4, 64)
    assert {k: tr[k] for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                               "flash_attention", "group_norm")} == {
        "flash_fwd_lse": 15, "flash_bwd_dkv": 15, "flash_bwd_dq": 15, "flash_attention": 6,
        "group_norm": 61 + 27}
    assert tr["by_dim"]["flash_bwd_dq"] == {40: 5, 80: 5, 160: 5}
    assert tr["by_dim"]["flash_attention"] == {40: 2, 80: 2, 160: 2}


def _counting(monkeypatch, counts):
    from paddlemix_tpu_torch.diffusers.models import resnet as resnet_mod

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def run(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)

    for name in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        counted(tattn, name, name)
    # B1's inference form, whose CPU path is its plain version
    counted(tattn, "flash_attention_ref", "flash_attention")
    counted(resnet_mod, "group_norm", "group_norm")


def test_train_step_calls_match_the_walk(monkeypatch):
    """One training step of a ControlNet and a UNet whose 256-token
    self-attentions (2 heads of 160) take flash: the calls of the lse
    forward, the backward functions, the inference form and GroupNorm,
    counted on the CPU, equal the walk's launches."""
    counts = dict.fromkeys(("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "flash_attention",
                            "group_norm"), 0)
    _counting(monkeypatch, counts)
    gen = torch.Generator().manual_seed(0)
    from paddlemix_tpu_torch.core import init_weights_

    u = init_weights_(UNet2DConditionModel(UNet2DConditionConfig(**WIDE_UNET_SD15)), gen)
    cn = init_weights_(ControlNetModel(ControlNetConfig.from_dict(
        dict(WIDE_UNET_SD15, conditioning_embedding_out_channels=(8, 16)))), gen)
    x = _inputs(8, hw=16, ctx_dim=24)
    batch = {"latents": torch.from_numpy(x["lat"]),
             "encoder_hidden_states": torch.from_numpy(x["ctx"]),
             "conditioning": torch.from_numpy(x["cond"])}
    loss = tcn.make_controlnet_loss_fn(u, cn, DDPMScheduler())(None, batch,
                                                               torch.Generator().manual_seed(0))
    loss.backward()
    want = expected_launches_controlnet_train(u, cn, 2, 16, context_len=5)
    # the ControlNet's one at 256 tokens and the UNet's up block's two train;
    # the UNet's down block's one runs the inference form
    assert want["by_dim"]["flash_fwd_lse"] == {160: 3} and want["flash_attention"] == 1
    assert counts == {k: want.get(k, 0) for k in counts}
