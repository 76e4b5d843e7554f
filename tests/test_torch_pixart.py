"""The port's PixArt-alpha slice (paddlemix_tpu_torch.diffusers PixArt
transformer, PixArtAlphaPipeline over the port's T5 and DPM-Solver++)
against the JAX package on shared weights, in fp32 on the CPU.

One tiny JAX PixArt (also with the 1024 model's micro-conditions, whose
embedders JAX's `from_config` does not create: drawn in the shapes its
module infers) and one tiny JAX T5 are built for the module, their
parameters moved by seeded noise and carried over through
`PIXART_KEY_MAP` / `T5_KEY_MAP`, every key consumed. The JAX side runs its
XLA forms. Compared: the forward with and without the micro-conditions, the
pipeline's latents (the setup of tests/test_more_models.py's PixArt test: a
tiny T5, DPM-Solver++; a seeded stand-in tokenizer on both sides) at JAX's
seeded noise, and the directories each package writes read by the other;
JAX's registry has no PixArt transformer (C.40)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers import DPMSolverMultistepScheduler as JDPM
from paddlemix_tpu.diffusers.models import PixArtConfig as JPixArtConfig
from paddlemix_tpu.diffusers.models import PixArtTransformer2DModel as JPixArt
from paddlemix_tpu.diffusers.pipelines import PixArtAlphaPipeline as JPixArtPipeline
from paddlemix_tpu.models.t5 import T5Config as JT5Config
from paddlemix_tpu.models.t5 import T5EncoderModel as JT5
from paddlemix_tpu_torch.core import (
    PIXART_KEY_MAP,
    T5_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
    torch_to_flax_state_dict,
)
from paddlemix_tpu_torch.diffusers import (
    DiffusionPipeline,
    DPMSolverMultistepScheduler,
    PixArtAlphaPipeline,
    PixArtConfig,
    PixArtTransformer2DModel,
)
from paddlemix_tpu_torch.diffusers.pixart import expected_launches_pixart
from paddlemix_tpu_torch.diffusers.sd3 import seeded_t5_tokenizer
from paddlemix_tpu_torch.models.t5 import T5Config, T5EncoderModel
from paddlemix_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.torch_port

TINY_PIXART = dict(sample_size=8, patch_size=2, in_channels=4, out_channels=8, num_layers=2,
                   num_attention_heads=2, attention_head_dim=8, caption_channels=16)
TINY_T5 = dict(vocab_size=64, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2)
CAPTION = 12
TOL = 2e-5


def _assert_close(ref, out, tol=TOL):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _jittered(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32), params)


def _load(module, params, key_map):
    module.load_state_dict(flax_to_torch_state_dict(flatten_flax(params), module, key_map))
    return module.eval()


def _cond_inputs(b=2):
    return (np.tile(np.asarray([[512.0, 512.0]], np.float32), (b, 1)),
            np.ones((b, 1), np.float32))


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, port model)} for "pixart", "pixart_cond" (the same
    parameters and the micro-conditions' two embedders, which JAX's
    `from_config` does not create: drawn here in the shapes its module
    infers from a (B, 2) resolution and a (B, 1) aspect ratio) and "t5".
    JAX's inits go through `from_config`, whose compiled init the directory
    test's reads reuse."""
    jplain = JPixArt.from_config(JPixArtConfig(**TINY_PIXART), seed=0)
    jplain.params = _jittered(jplain.params, 1)
    d = TINY_PIXART["num_attention_heads"] * TINY_PIXART["attention_head_dim"]
    rs = np.random.RandomState(3)
    cond = dict(jplain.params, **{
        name: {f"linear_{i}": {"kernel": rs.randn(n_in, d).astype(np.float32) / np.sqrt(n_in),
                               "bias": 0.05 * rs.randn(d).astype(np.float32)}
               for i, n_in in ((1, width), (2, d))}
        for name, width in (("res_embedder", 512), ("ar_embedder", 256))})
    jcond = JPixArt(JPixArtConfig(**TINY_PIXART, use_additional_conditions=True), params=cond)
    jt5 = JT5.from_config(JT5Config(**TINY_T5), seed=0)
    jt5.params = _jittered(jt5.params, 2)
    return {
        "pixart": (jplain, _load(PixArtTransformer2DModel(PixArtConfig(**TINY_PIXART)),
                                 jplain.params, PIXART_KEY_MAP)),
        "pixart_cond": (jcond, _load(PixArtTransformer2DModel(PixArtConfig(
            **TINY_PIXART, use_additional_conditions=True)), cond, PIXART_KEY_MAP)),
        "t5": (jt5, _load(T5EncoderModel(T5Config(**TINY_T5)), jt5.params, T5_KEY_MAP))}


@pytest.mark.parametrize("name", ["pixart", "pixart_cond"])
def test_pixart_forward_matches_jax(models, name):
    jmodel, model = models[name]
    rs = np.random.RandomState(0)
    lat = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([10.0, 900.0], np.float32)
    ctx = rs.randn(2, 5, 16).astype(np.float32)
    extra = _cond_inputs() if name == "pixart_cond" else ()
    ref = jax.jit(jmodel.module.apply)({"params": jmodel.params},
                                       *map(jnp.asarray, (lat, t, ctx) + extra))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (lat, t, ctx) + extra))
    _assert_close(ref, out)
    if name == "pixart_cond":  # the branch moves the output; without its inputs it is off
        with torch.no_grad():
            plain = model(*map(torch.from_numpy, (lat, t, ctx)))
        assert not torch.allclose(plain, out, atol=1e-3)
        assert {"res_embedder", "ar_embedder"} <= set(jmodel.params)


def _pipes(models, tok):
    (jtf, tf), (jt5, t5) = models["pixart"], models["t5"]
    return (JPixArtPipeline(tokenizer=tok, text_encoder=jt5, vae=None, transformer=jtf,
                            scheduler=JDPM()),
            PixArtAlphaPipeline(tokenizer=tok, text_encoder=t5, vae=None, transformer=tf,
                                scheduler=DPMSolverMultistepScheduler()))


def test_pixart_pipeline_matches_jax(models):
    """The latents of 3 DPM-Solver++ steps at CFG 4.5 over two prompts, the
    port given JAX's seeded noise."""
    tok = seeded_t5_tokenizer(0, TINY_T5["vocab_size"], length=CAPTION)
    jpipe, pipe = _pipes(models, tok)
    prompts, seed = ["a red square", "a small blue house by a lake"], 5
    ref = jpipe(prompts, num_inference_steps=3, seed=seed, output_type="latent")[0]
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), (2, 8, 8, 4), jnp.float32))
    out = pipe(prompts, num_inference_steps=3, latents=noise, output_type="latent")[0]
    _assert_close(ref, out, 1e-4)
    _assert_close(jpipe.encode_prompt(prompts), pipe.encode_prompt(prompts))


def test_pixart_directories_both_ways(models, tmp_path):
    """The port's PixArt directory read by JAX's DiffusionPipeline.from_pretrained,
    which refuses it without the transformer given (C.40: its registry has no
    PixArtTransformer2DModel), and JAX's by the port's; the tokenizer, a
    callable, is an override on both sides."""
    tok = seeded_t5_tokenizer(0, TINY_T5["vocab_size"], length=CAPTION)
    jpipe, pipe = _pipes(models, tok)
    pipe.save_pretrained(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="PixArtTransformer2DModel"):
        JDiffusionPipeline.from_pretrained(str(tmp_path / "port"), tokenizer=tok)
    jtf = JPixArt.from_pretrained(str(tmp_path / "port" / "transformer"))
    back = JDiffusionPipeline.from_pretrained(str(tmp_path / "port"), tokenizer=tok,
                                              transformer=jtf)
    assert type(back).__name__ == "PixArtAlphaPipeline" and back.vae is None
    assert type(back.scheduler).__name__ == "DPMSolverMultistepScheduler"
    for mine, theirs, key_map in ((pipe.transformer, back.transformer, PIXART_KEY_MAP),
                                  (pipe.text_encoder, back.text_encoder, T5_KEY_MAP)):
        flat = flatten_flax(theirs.params)
        got = torch_to_flax_state_dict(mine, key_map)
        assert got.keys() == flat.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(flat[k]), v.numpy())

    jpipe.save_pretrained(str(tmp_path / "jax"))
    port = DiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu", tokenizer=tok)
    assert isinstance(port, PixArtAlphaPipeline)
    assert isinstance(port.scheduler, DPMSolverMultistepScheduler)
    for mine, theirs, key_map in ((port.transformer, jpipe.transformer, PIXART_KEY_MAP),
                                  (port.text_encoder, jpipe.text_encoder, T5_KEY_MAP)):
        flat = flatten_flax(theirs.params)
        for k, v in torch_to_flax_state_dict(mine, key_map).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(flat[k]))


def test_pixart_launch_walk():
    """At PixArt-XL-2-512x512's widths (on the meta device) with T5-XXL over
    120 tokens: 28 flash self-attentions at (2, 1024, 16, 72) a CFG step, the
    cross-attention over 120 keys math; T5's 49 RMSNorms for the prompt and
    the negative prompt; the VAE decoder's 30 GroupNorms."""
    from paddlemix_tpu_torch.diffusers.models import AutoencoderKL, AutoencoderKLConfig
    from paddlemix_tpu_torch.diffusers.pixart import PIXART_CAPTION_TOKENS, PIXART_XL_2_512
    from paddlemix_tpu_torch.diffusers.sd3 import SD3_TEXT_ENCODER_3

    with torch.device("meta"):
        pipe = PixArtAlphaPipeline(
            tokenizer=seeded_t5_tokenizer(length=PIXART_CAPTION_TOKENS),
            text_encoder=T5EncoderModel(T5Config(**SD3_TEXT_ENCODER_3)),
            vae=AutoencoderKL(AutoencoderKLConfig()),
            transformer=PixArtTransformer2DModel(PixArtConfig(**PIXART_XL_2_512)),
            scheduler=DPMSolverMultistepScheduler())
    assert not tattn.use_flash((2, 1024, 16, 72), (2, PIXART_CAPTION_TOKENS, 16, 72))
    assert expected_launches_pixart(pipe, 1, 20) == {
        "flash_attention": 28 * 20, "rms_norm": 2 * 49, "group_norm": 30}


def test_pixart_gradient_checkpointing_bit_equal(models):
    """Per-block recompute (JAX's nn.remat): the loss and every gradient
    bit-equal with checkpointing on and off."""
    _, model = models["pixart_cond"]
    rs = np.random.RandomState(6)
    lat, ctx = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
                for shape in ((2, 8, 8, 4), (2, 5, 16)))
    extra = tuple(map(torch.from_numpy, _cond_inputs()))
    params = list(model.parameters())
    out = []
    try:
        for on in (False, True):
            model.config.gradient_checkpointing = on
            loss = model(lat, torch.tensor([10.0, 900.0]), ctx, *extra).square().mean()
            out.append((loss, torch.autograd.grad(loss, params)))
    finally:
        model.config.gradient_checkpointing = False
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_seeded_t5_draws_at_t5_init():
    """The seeded T5 (core.init) draws q at (d_model * d_kv) ** -0.5 and the
    relative-position table at d_model ** -0.5, as transformers' T5 init (its
    attention has no 1/sqrt(d)); k keeps the fan-in std d_model ** -0.5."""
    from paddlemix_tpu_torch.core.init import build_random
    from paddlemix_tpu_torch.models.t5 import T5LayerNorm

    cfg = T5Config(vocab_size=64, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=16)
    t5 = build_random(lambda: T5EncoderModel(cfg), device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0), fp32_modules=(T5LayerNorm,))
    attn0 = t5.encoder.block[0].layer[0].SelfAttention
    for p, std in ((attn0.q.weight, (64 * 16) ** -0.5), (attn0.k.weight, 64 ** -0.5),
                   (attn0.relative_attention_bias.weight, 64 ** -0.5)):
        assert abs(p.std().item() / std - 1) < 0.1
