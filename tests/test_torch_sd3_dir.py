"""SD3-medium from its published directory, and its training, in the port
against the JAX package on the CPU (fp32; the JAX side on its XLA paths,
its default on the CPU).

A tiny SD3 pipeline of the port (seeded random weights) is written by
`diffusers.sd3.save_published_sd3` in the published layout (diffusers' and
transformers' keys and configs, T5 in shards) and read by both packages'
`DiffusionPipeline.from_pretrained`. Held here:
- T5: a tiny transformers `T5EncoderModel` saved in shards, read by the port
  equal to transformers' forward and to JAX's `from_pretrained` (atol 1e-5
  of the largest output), and the port's `save_pretrained` round trip;
- the SD3 transformer in diffusers' keys read bit-equal to the weights that
  wrote it; JAX's read equal on every tensor it reads, and its five C.27
  Linears left at random init; a missing tensor refused by name;
- C.25 (diffusers' cropped position table against JAX's, which the port
  keeps) and C.26 (the VAE without quant convs read exactly, against JAX's
  random 1x1 convs);
- the pipeline: refused without a `tokenizer_3` by both packages, and with
  it its latents after 2 steps equal to JAX's (atol 1e-4 of the largest);
- the FlowMatch scheduler config round trip;
- `flow_match_loss` at JAX's own draws: the loss and every parameter's
  gradient against JAX's `value_and_grad` (rtol 1e-5 on the loss, atol 1e-5
  of each gradient's largest element), and gradient checkpointing on and off
  giving the same loss and gradients. The kernels of the training path on
the card are tests/test_torch_sd3_train_kernels.py's.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params, unflatten_params
from paddlemix_tpu.diffusers import AutoencoderKL as JAutoencoderKL
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers import FlowMatchEulerDiscreteScheduler as JFlowMatch
from paddlemix_tpu.diffusers import SD3Transformer2DModel as JSD3
from paddlemix_tpu.diffusers import SD3TransformerConfig as JSD3Config
from paddlemix_tpu.diffusers.models.embeddings import get_2d_sincos_pos_embed as j_pos_embed
from paddlemix_tpu.diffusers.training_utils import make_flow_match_loss_fn as j_make_loss_fn
from paddlemix_tpu.models.t5 import T5EncoderModel as JT5
from paddlemix_tpu_torch.core import SD3_KEY_MAP, flatten_flax, flax_to_torch_state_dict
from paddlemix_tpu_torch.core.convert import torch_to_flax_state_dict
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    DiffusionPipeline,
    FlowMatchEulerDiscreteScheduler,
    SD3Transformer2DModel,
    SD3TransformerConfig,
    StableDiffusion3Pipeline,
)
from paddlemix_tpu_torch.diffusers.models.embeddings import get_2d_sincos_pos_embed
from paddlemix_tpu_torch.diffusers.sd3 import (
    SD3_SCHEDULER_CONFIG,
    SD3_TRANSFORMER,
    expected_launches_sd3_train,
    random_sd3_pipeline,
    save_published_sd3,
    sd3_trainer,
    seeded_t5_tokenizer,
)
from paddlemix_tpu_torch.diffusers.training_utils import flow_match_loss, make_flow_match_loss_fn
from paddlemix_tpu_torch.models.clip import CLIPTokenizer
from paddlemix_tpu_torch.models.t5 import T5Config, T5EncoderModel
from test_pipelines import tiny_tokenizer
from test_torch_sdxl_modules import TINY_VAE

pytestmark = pytest.mark.torch_port

# tests/test_torch_sd3.py's widths: 2 heads x 64, joint width 128
TINY_SD3 = dict(sample_size=16, patch_size=2, in_channels=4, out_channels=4, num_layers=2,
                attention_head_dim=64, num_attention_heads=2, joint_attention_dim=128,
                pooled_projection_dim=32, pos_embed_max_size=24)
TINY_T5 = dict(vocab_size=64, d_model=128, d_kv=32, d_ff=192, num_layers=2, num_heads=4)
TINY_SD3_VAE = dict(TINY_VAE, scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False,
                    use_post_quant_conv=False)
T5_LEN = 24
# the tensors JAX's map leaves under diffusers' names (C.27), by flax key
C27_PREFIXES = ("timestep_embedder.", "text_embedder.", "norm_out_linear.")
CALL = dict(prompt="a photo of a cat", negative_prompt="blurry", height=32, width=32,
            num_inference_steps=2, guidance_scale=7.0)


def _close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _t5_tokenizer():
    return seeded_t5_tokenizer(0, vocab_size=64, length=T5_LEN)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """(the port's tiny pipeline, its published-layout directory): text
    towers 16 wide over tests/test_pipelines.py's tokenizer, T5 in shards."""
    jtok = tiny_tokenizer()
    tok = CLIPTokenizer(jtok.encoder, [], model_max_length=jtok.model_max_length)
    text = dict(vocab_size=tok.vocab_size, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2, projection_dim=16)
    pipe = random_sd3_pipeline("cpu", torch.float32, seed=3, transformer=TINY_SD3,
                               vae=TINY_SD3_VAE, text_encoder=dict(text, hidden_act="quick_gelu"),
                               text_encoder_2=dict(text, hidden_act="gelu"),
                               text_encoder_3=TINY_T5, tokenizer=tok,
                               tokenizer_3=_t5_tokenizer())
    with torch.no_grad():  # biases and norms off their init, so that errors show
        gen = torch.Generator().manual_seed(4)
        for name in ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3"):
            for p in getattr(pipe, name).parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    path = str(tmp_path_factory.mktemp("sd3") / "published")
    save_published_sd3(pipe, path, max_shard_bytes=400_000)
    return pipe, path


@pytest.fixture(scope="module")
def jax_pipe(published):
    _, path = published
    return JDiffusionPipeline.from_pretrained(path, tokenizer_3=_t5_tokenizer())


def _equal_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        v.dtype == sb[k].dtype and torch.equal(v, sb[k]) for k, v in sa.items())


# ------------------------------------------------------------------ T5
def test_t5_transformers_checkpoint_reads_as_transformers_and_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
        feed_forward_proj="gated-gelu")).eval()
    hf.save_pretrained(str(tmp_path / "hf"), max_shard_size="20KB")
    assert os.path.exists(tmp_path / "hf" / "model.safetensors.index.json")
    model = T5EncoderModel.from_pretrained(str(tmp_path / "hf"), device="cpu")
    assert model.config.d_model == 32 and model.config.feed_forward_proj == "gated-gelu"
    ids = np.random.RandomState(0).randint(0, 64, (2, 11))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))[0]
        ref = hf(torch.from_numpy(ids)).last_hidden_state
    _close(ref, out, 1e-5)
    jmodel = JT5.from_pretrained(str(tmp_path / "hf"))
    _close(jmodel(jnp.asarray(ids, jnp.int32))[0], out, 1e-5)
    model.save_pretrained(str(tmp_path / "port"))
    assert _equal_state(model, T5EncoderModel.from_pretrained(str(tmp_path / "port"),
                                                              device="cpu"))
    _close(JT5.from_pretrained(str(tmp_path / "port"))(jnp.asarray(ids, jnp.int32))[0], out, 1e-5)
    bf16 = T5EncoderModel.from_pretrained(str(tmp_path / "hf"), device="cpu",
                                          dtype=torch.bfloat16)
    assert bf16.shared.weight.dtype == torch.bfloat16
    assert bf16.encoder.final_layer_norm.weight.dtype == torch.float32  # the norms stay fp32
    with pytest.raises(NotImplementedError, match="feed_forward_proj"):
        T5Config.from_dict(dict(TINY_T5, feed_forward_proj="relu"))


# --------------------------------------------------------- transformer
def test_transformer_in_diffusers_keys_reads_exactly_and_as_jax(published, jax_pipe, caplog):
    pipe, path = published
    with caplog.at_level("WARNING"):
        model = SD3Transformer2DModel.from_pretrained(path, subfolder="transformer",
                                                      device="cpu")
    assert "C.25" in caplog.text  # diffusers' stored table dropped
    assert _equal_state(model, pipe.transformer)
    ours = {k: v.numpy() for k, v in torch_to_flax_state_dict(model, SD3_KEY_MAP).items()}
    theirs = flatten_params(jax_pipe.transformer.params)
    assert ours.keys() == theirs.keys()
    c27 = sorted(k for k in ours if k.startswith(C27_PREFIXES))
    assert len(c27) == 10  # five Linears' kernels and biases
    for k, v in theirs.items():
        if k in c27:  # JAX's read left them at its seed-0 init
            assert not np.allclose(np.asarray(v), ours[k]), k
        else:
            np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)
    # with those five filled in, JAX's forward equals the port's
    jmodel = JSD3(jax_pipe.transformer.config,
                  params=unflatten_params(dict(theirs, **{k: ours[k] for k in c27})))
    rs = np.random.RandomState(1)
    args = (rs.randn(2, 16, 16, 4).astype(np.float32), np.array([980.0, 3.5], np.float32),
            rs.randn(2, 40, 128).astype(np.float32), rs.randn(2, 32).astype(np.float32))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in args))
    _close(jmodel(*(jnp.asarray(a) for a in args)), out, 1e-4)


def test_transformer_save_pretrained_round_trip_and_refusals(published, tmp_path):
    pipe, path = published
    pipe.transformer.save_pretrained(str(tmp_path / "port"))
    back = SD3Transformer2DModel.from_pretrained(str(tmp_path / "port"), device="cpu")
    assert _equal_state(back, pipe.transformer)
    jback = flatten_params(JSD3.from_pretrained(str(tmp_path / "port")).params)
    for k, v in torch_to_flax_state_dict(back, SD3_KEY_MAP).items():
        np.testing.assert_array_equal(np.asarray(jback[k]), v.numpy(), err_msg=k)
    # a tensor short: refused by name
    from paddlemix_tpu_torch.core import safetensors as st

    short = tmp_path / "short"
    shutil.copytree(os.path.join(path, "transformer"), short)
    f = short / "diffusion_pytorch_model.safetensors"
    flat = {k: v.clone() for k, v in st.load_file(str(f)).items()
            if k != "transformer_blocks.1.ff.net.2.weight"}
    st.save_file(flat, str(f))
    with pytest.raises(KeyError, match=r"transformer_blocks\.1\.ff_fc2\.weight"):
        SD3Transformer2DModel.from_pretrained(str(short), device="cpu")
    for key, value in (("qk_norm", "rms_norm"), ("dual_attention_layers", [0])):
        with pytest.raises(NotImplementedError, match=key):
            SD3TransformerConfig.from_dict(dict(TINY_SD3, **{key: value}))


def _diffusers_cropped_table(embed_dim, grid, max_size, base_size):
    """diffusers' PatchEmbed table with `pos_embed_max_size`, in numpy as
    diffusers computes it: the sincos table of a max_size grid at positions
    i / (max_size / base_size), its centre grid x grid crop."""
    def sincos_1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(max_size, dtype=np.float32) / (max_size / base_size)
    w, h = np.meshgrid(g, g)
    table = np.concatenate([sincos_1d(embed_dim // 2, w), sincos_1d(embed_dim // 2, h)], axis=1)
    top = (max_size - grid) // 2
    table = table.reshape(max_size, max_size, embed_dim)[top:top + grid, top:top + grid]
    return table.reshape(grid * grid, embed_dim).astype(np.float32)


@pytest.mark.parametrize("cfg", [(128, 8, 24, 8), (1536, 64, 192, 64)], ids=["tiny", "sd3"])
def test_fault25_position_table(cfg):
    """ROADMAP C.25: diffusers crops the centre of a pos_embed_max_size grid
    (SD3-medium: positions 21.33 to 42.33 in steps of 1/3) where JAX computes
    the grid's own (0 to 63); the port keeps JAX's (atol 1e-5, as
    tests/test_torch_sd3_kernels.py holds the table: fp32 sines of angles up
    to 63 differ in the last bits)."""
    dim, grid, max_size, base = cfg
    diffusers = _diffusers_cropped_table(dim, grid, max_size, base)
    jtable = np.asarray(j_pos_embed(dim, grid, grid, base_size=base)).reshape(grid * grid, dim)
    assert np.abs(diffusers - jtable).max() > 0.5
    np.testing.assert_allclose(get_2d_sincos_pos_embed(dim, grid, grid, base).numpy(), jtable,
                               rtol=0, atol=1e-5)


def test_fault26_vae_without_quant_convs(published):
    """ROADMAP C.26: SD3's VAE has no quant_conv / post_quant_conv. The port
    builds none and reads the directory exactly; JAX builds both and keeps
    them at random init. With JAX's post_quant_conv made the identity, JAX's
    decode equals the port's (atol 1e-4 of the largest)."""
    pipe, path = published
    vae = AutoencoderKL.from_pretrained(path, subfolder="vae", device="cpu")
    assert vae.quant_conv is None and vae.post_quant_conv is None
    assert _equal_state(vae, pipe.vae)
    jvae = JAutoencoderKL.from_pretrained(os.path.join(path, "vae"))
    flat = flatten_params(jvae.params)
    kernel = np.asarray(flat["post_quant_conv.kernel"])[0, 0]
    assert kernel.shape == (4, 4) and not np.allclose(kernel, np.eye(4))
    z = np.random.RandomState(2).randn(1, 4, 4, 4).astype(np.float32)
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert np.abs(np.asarray(jvae.decode(jnp.asarray(z))) - out.numpy()).max() > 1e-2
    flat["post_quant_conv.kernel"] = np.eye(4, dtype=np.float32)[None, None]
    flat["post_quant_conv.bias"] = np.zeros(4, np.float32)
    jvae.params = unflatten_params(flat)
    _close(jvae.decode(jnp.asarray(z)), out, 1e-4)


# ------------------------------------------------------------ pipeline
def test_published_dir_needs_tokenizer_3_as_in_jax(published):
    _, path = published
    with pytest.raises(NotImplementedError, match=r"no implementation for component tokenizer_3 "
                                                  r"\(T5TokenizerFast\)"):
        DiffusionPipeline.from_pretrained(path, device="cpu")
    with pytest.raises(ValueError, match=r"no implementation for component tokenizer_3 "
                                         r"\(T5TokenizerFast\)"):
        JDiffusionPipeline.from_pretrained(path)


def test_published_dir_latents_match_jax(published, jax_pipe):
    pipe, path = published
    back = DiffusionPipeline.from_pretrained(path, device="cpu", tokenizer_3=_t5_tokenizer())
    assert isinstance(back, StableDiffusion3Pipeline)
    assert isinstance(back.scheduler, FlowMatchEulerDiscreteScheduler)
    assert back.scheduler.config.shift == 3.0
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3"):
        assert _equal_state(getattr(back, name), getattr(pipe, name)), name
    latents = np.random.RandomState(5).randn(1, 16, 16, 4).astype(np.float32)
    out = back(**CALL, latents=latents, output_type="latent")[0]
    assert torch.equal(out, pipe(**CALL, latents=latents, output_type="latent")[0])
    # JAX's read, with its five C.27 Linears filled in from the directory
    ours = torch_to_flax_state_dict(back.transformer, SD3_KEY_MAP)
    theirs = flatten_params(jax_pipe.transformer.params)
    jax_pipe.transformer.params = unflatten_params(dict(theirs, **{
        k: ours[k].numpy() for k in theirs if k.startswith(C27_PREFIXES)}))
    try:
        ref = jax_pipe(**CALL, latents=jnp.asarray(latents), output_type="latent")[0]
    finally:
        jax_pipe.transformer.params = unflatten_params(theirs)
    _close(ref, out, 1e-4)


def test_pipeline_save_pretrained_writes_a_callable_tokenizer_as_jax(published, jax_pipe,
                                                                     tmp_path):
    pipe, _ = published
    pipe.save_pretrained(str(tmp_path / "port"))
    jax_pipe.save_pretrained(str(tmp_path / "jax"))
    index = json.loads((tmp_path / "port" / "model_index.json").read_text())
    jindex = json.loads((tmp_path / "jax" / "model_index.json").read_text())
    assert index["tokenizer_3"] == ["paddlemix_tpu_torch", "function"]
    assert jindex["tokenizer_3"] == ["paddlemix_tpu", "function"]
    assert not (tmp_path / "port" / "tokenizer_3").exists()
    assert not (tmp_path / "jax" / "tokenizer_3").exists()
    with pytest.raises(NotImplementedError, match="tokenizer_3"):
        DiffusionPipeline.from_pretrained(str(tmp_path / "port"), device="cpu")
    back = DiffusionPipeline.from_pretrained(str(tmp_path / "port"), device="cpu",
                                             tokenizer_3=_t5_tokenizer())
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3"):
        assert _equal_state(getattr(back, name), getattr(pipe, name)), name


def test_flow_match_scheduler_config_round_trip(tmp_path):
    sched = FlowMatchEulerDiscreteScheduler(shift=2.5, num_train_timesteps=900)
    sched.save_pretrained(str(tmp_path / "port"))
    jsched = JFlowMatch.from_pretrained(str(tmp_path / "port"))
    assert (jsched.config.shift, jsched.config.num_train_timesteps) == (2.5, 900)
    JFlowMatch(shift=1.5).save_pretrained(str(tmp_path / "jax"))
    back = FlowMatchEulerDiscreteScheduler.from_pretrained(str(tmp_path / "jax"))
    assert back.config == FlowMatchEulerDiscreteScheduler(shift=1.5).config
    os.makedirs(tmp_path / "published")
    (tmp_path / "published" / "scheduler_config.json").write_text(
        json.dumps(SD3_SCHEDULER_CONFIG))
    pub = FlowMatchEulerDiscreteScheduler.from_pretrained(str(tmp_path / "published"))
    assert pub.config.shift == 3.0 and "_diffusers_version" in pub.config.unused_kwargs
    np.testing.assert_array_equal(
        pub.set_timesteps(4).sigmas.numpy(),
        np.asarray(JFlowMatch.from_pretrained(str(tmp_path / "published")).set_timesteps(4)
                   .sigmas))
    with pytest.raises(NotImplementedError, match="use_dynamic_shifting"):
        FlowMatchEulerDiscreteScheduler(use_dynamic_shifting=True)


# ------------------------------------------------------------ training
@pytest.fixture(scope="module")
def train_pair():
    """JAX's tiny transformer (seed-0 init moved by seeded noise) and the
    port's with its weights, and a batch."""
    cfg = JSD3Config(**TINY_SD3)
    rs = np.random.RandomState(6)
    jmodel = JSD3.from_config(cfg, seed=0)
    jmodel = JSD3(cfg, params=jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32), jmodel.params))
    model = SD3Transformer2DModel(SD3TransformerConfig(**TINY_SD3))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(jmodel.params), model,
                                                   SD3_KEY_MAP))
    batch = {"latents": rs.randn(2, 16, 16, 4).astype(np.float32),
             "encoder_hidden_states": rs.randn(2, 40, 128).astype(np.float32),
             "pooled_projections": rs.randn(2, 32).astype(np.float32)}
    return jmodel, model, batch


def _grads(model, batch, u, noise):
    model.zero_grad()
    loss = flow_match_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.as_tensor(u), torch.as_tensor(noise))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_flow_match_loss_and_gradients_equal_jax_at_its_draws(train_pair):
    jmodel, model, batch = train_pair
    key = jax.random.PRNGKey(7)
    jloss_fn = j_make_loss_fn(jmodel, JFlowMatch(shift=3.0))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jmodel.params,
                                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                                 key)
    rng_t, rng_n = jax.random.split(key)  # JAX's loss_fn draws u, then the noise
    u = np.asarray(jax.random.uniform(rng_t, (2,)))
    noise = np.asarray(jax.random.normal(rng_n, batch["latents"].shape, jnp.float32))
    loss, grads = _grads(model, batch, u, noise)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = flax_to_torch_state_dict(flatten_flax(jgrads), model, SD3_KEY_MAP)
    assert ref.keys() == grads.keys()
    for name, g in grads.items():
        _close(ref[name], g, 1e-5)


def test_gradient_checkpointing_gives_the_same_loss_and_gradients(train_pair):
    _, model, batch = train_pair
    rs = np.random.RandomState(8)
    u, noise = rs.rand(2).astype(np.float32), rs.randn(2, 16, 16, 4).astype(np.float32)
    loss, grads = _grads(model, batch, u, noise)
    model.config.gradient_checkpointing = True
    try:
        loss_ckpt, grads_ckpt = _grads(model, batch, u, noise)
    finally:
        model.config.gradient_checkpointing = False
    assert torch.equal(loss, loss_ckpt)
    for name, g in grads.items():
        torch.testing.assert_close(grads_ckpt[name], g, rtol=0, atol=0)


def test_make_flow_match_loss_fn_draws_u_then_noise(train_pair):
    _, model, batch = train_pair
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = make_flow_match_loss_fn(model, FlowMatchEulerDiscreteScheduler(shift=3.0))
    with torch.no_grad():
        got = loss_fn(None, tbatch, torch.Generator().manual_seed(9))
        gen = torch.Generator().manual_seed(9)
        u = torch.rand((2,), generator=gen)
        noise = torch.randn((2, 16, 16, 4), generator=gen)
        assert torch.equal(got, flow_match_loss(model, tbatch, u, noise))


def test_sd3_trainer_steps_and_launch_walk():
    gen = torch.Generator().manual_seed(0)
    from paddlemix_tpu_torch.core.init import build_random

    model = build_random(lambda: SD3Transformer2DModel(SD3TransformerConfig(**TINY_SD3)),
                         device="cpu", dtype=torch.float32, generator=gen)
    model.config.gradient_checkpointing = True
    rs = np.random.RandomState(10)
    samples = [{"latents": rs.randn(16, 16, 4).astype(np.float32),
                "encoder_hidden_states": rs.randn(40, 128).astype(np.float32),
                "pooled_projections": rs.randn(32).astype(np.float32)} for _ in range(4)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = sd3_trainer(model, FlowMatchEulerDiscreteScheduler(shift=3.0), samples,
                          max_steps=2, logging_steps=1, output_dir="unused")
    trainer.train()
    losses = [float(h["loss"]) for h in trainer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert trainer.args.learning_rate == 1e-5
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    with torch.device("meta"):
        full = SD3Transformer2DModel(SD3TransformerConfig(**SD3_TRANSFORMER,
                                                          gradient_checkpointing=True))
    # a step at batch 2, 1024 px, 154 context tokens: 24 joint attentions over
    # 4,250 tokens on flash, each block's forward kernels run twice
    assert expected_launches_sd3_train(full, 2, 128, 154) == {
        "adaptive_layer_norm": 97, "fused_adaln_scale_residual": 94, "flash_fwd_lse": 48,
        "flash_bwd_dkv": 24, "flash_bwd_dq": 24}
