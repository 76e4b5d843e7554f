"""Diffusers checkpoints in the port against the JAX package: pipeline
directories written by the JAX package's `save_pretrained`, by the port's,
and in diffusers' own layout (HF names, (out, in) Linears, OIHW convs,
`diffusion_pytorch_model.safetensors` / `.bin`, built here by inverting the
key maps as tests/test_diffusion_models.py does), read by
`DiffusionPipeline.from_pretrained` on both sides; the VAE encoder; the
scheduler configs; AutoModel over `unet/` and `vae/`; and the refusals (a
missing or mis-shaped tensor, an unported component class). The tiny
components are tests/test_pipelines.py's, fp32 on the CPU; the models come
from the JAX modules' seeded init and the inputs from numpy."""

import json
import logging
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import AutoencoderKL as JVAE
from paddlemix_tpu.diffusers import AutoencoderKLConfig as JVAEConfig
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers import StableDiffusionPipeline as JSDPipeline
from paddlemix_tpu.diffusers import StableDiffusionXLPipeline as JSDXLPipeline
from paddlemix_tpu.diffusers import UNet2DConditionConfig as JUNetConfig
from paddlemix_tpu.diffusers import UNet2DConditionModel as JUNet
from paddlemix_tpu.diffusers.schedulers import DDPMScheduler as JDDPM
from paddlemix_tpu.diffusers.schedulers import EulerDiscreteScheduler as JEuler
from paddlemix_tpu.diffusers.schedulers import PNDMScheduler as JPNDM
from paddlemix_tpu_torch.auto import AutoModel
from paddlemix_tpu_torch.core import VAE_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.core import safetensors as st
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    DDPMScheduler,
    DiffusionPipeline,
    EulerDiscreteScheduler,
    PNDMScheduler,
    StableDiffusionPipeline,
    StableDiffusionXLPipeline,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers.models.resnet import n_group_norms
from paddlemix_tpu_torch.diffusers.sd15 import SD15_SCHEDULER, SD15_VAE
from test_pipelines import tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae
from test_torch_sdxl_modules import TINY_VAE

pytestmark = pytest.mark.torch_port

STEPS = 2
CALLS = {"sd": dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
                    num_inference_steps=STEPS, guidance_scale=7.5),
         "sdxl": dict(prompt="a cat", negative_prompt="blurry", height=32, width=32,
                      num_inference_steps=STEPS, guidance_scale=5.0)}
# test_pipelines.tiny_unet(ctx_dim=32)'s widths
TINY_UNET_SD = dict(sample_size=8, block_out_channels=(16, 32),
                    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                    cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8)
MODELS = {"sd": ("unet", "vae", "text_encoder"),
          "sdxl": ("unet", "vae", "text_encoder", "text_encoder_2")}


def _assert_close(ref, out, tol):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def jax_pipeline(kind: str, unet_seed: int = 0):
    """The tiny JAX pipeline of `kind`: SD (one tower, PNDM) or SDXL (two
    towers, the second with projection, Euler)."""
    tok = tiny_tokenizer()
    if kind == "sd":
        unet = tiny_unet(ctx_dim=32)
        if unet_seed:
            unet = JUNet.from_config(unet.config, seed=unet_seed)
        return JSDPipeline(vae=tiny_vae(), text_encoder=tiny_text_encoder(tok), tokenizer=tok,
                           unet=unet, scheduler=JPNDM(**SD15_SCHEDULER))
    return JSDXLPipeline(vae=tiny_vae(), text_encoder=tiny_text_encoder(tok, dim=16),
                         text_encoder_2=tiny_text_encoder(tok, with_projection=True, dim=16),
                         tokenizer=tok, tokenizer_2=tok, unet=tiny_unet(ctx_dim=32, sdxl=True),
                         scheduler=JEuler())


def latents_for(pipe_kind: str):
    # the tiny two-level VAE scales by 2: 32 px -> 16 x 16 latents
    return np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{kind: (JAX pipeline, the directory its save_pretrained wrote)}."""
    out = {}
    for kind in ("sd", "sdxl"):
        jpipe = jax_pipeline(kind)
        path = str(tmp_path_factory.mktemp(f"jax_{kind}"))
        jpipe.save_pretrained(path)
        out[kind] = (jpipe, path)
    return out


def _jax_latents(jpipe, kind):
    return np.asarray(jpipe(**CALLS[kind], latents=latents_for(kind), output_type="latent")[0])


# ------------------------------------------------ diffusers' own layout
def _hf_unet_vae_key(k: str) -> str:
    """A flax UNet / VAE key -> diffusers' name: the inverse of the key map
    (`time_embedding.linear_1` keeps its `_1`)."""
    k = re.sub(r"\.(kernel|scale)$", ".weight", k)
    k = re.sub(r"(?<!linear)_(\d+)\.", r".\1.", k)
    return k.replace(".to_out.", ".to_out.0.")


def _hf_clip_key(k: str) -> str:
    """A flax CLIP text tower key -> transformers' name."""
    k = k.replace("text_model.token_embedding.embedding",
                  "text_model.embeddings.token_embedding.weight")
    k = re.sub(r"^text_model\.position_embedding$",
               "text_model.embeddings.position_embedding.weight", k)
    k = re.sub(r"\.layers_(\d+)\.", r".encoder.layers.\1.", k)
    k = k.replace(".attn.", ".self_attn.").replace(".norm1.", ".layer_norm1.")
    k = k.replace(".norm2.", ".layer_norm2.")
    return re.sub(r"\.(kernel|scale)$", ".weight", k)


def _hf_layout(k: str, v: np.ndarray) -> np.ndarray:
    if k.endswith(".kernel") and v.ndim == 2:
        return v.T
    if k.endswith(".kernel") and v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
    return v


def write_diffusers_layout(jax_dir: str, out: str, binary: bool):
    """The pipeline of `jax_dir` rewritten as diffusers writes it: HF keys and
    layouts in `diffusion_pytorch_model.*` (UNet, VAE) and `model.*` /
    `pytorch_model.bin` (text towers, with transformers' `position_ids`
    buffer), diffusers' config.json (`_class_name` the model class) and
    model_index.json (["diffusers", class], a null safety_checker)."""
    with open(os.path.join(jax_dir, "model_index.json")) as f:
        index = json.load(f)
    hf_index = {"_class_name": index["_class_name"], "_diffusers_version": "0.27.0"}
    for name, entry in index.items():
        if name.startswith("_") or entry[1] is None:
            continue
        cls = entry[1]
        hf_index[name] = ["diffusers" if "Scheduler" in cls or "UNet" in cls or "Auto" in cls
                          else "transformers", cls]
        src, dst = os.path.join(jax_dir, name), os.path.join(out, name)
        if name not in ("unet", "vae") and not name.startswith("text_encoder"):
            shutil.copytree(src, dst)
            continue
        os.makedirs(dst)
        flat = {k: t.numpy()
                for k, t in st.load_file(os.path.join(src, "model.safetensors")).items()}
        with open(os.path.join(src, "config.json")) as f:
            cfg = json.load(f)
        if name.startswith("text_encoder"):
            hf = {_hf_clip_key(k): _hf_layout(k, v) for k, v in flat.items()}
            n_pos = cfg["max_position_embeddings"]
            hf["text_model.embeddings.position_ids"] = np.arange(n_pos, dtype=np.int64)[None]
            cfg.update(architectures=[cls], model_type="clip_text_model", bos_token_id=0)
            fname = "pytorch_model.bin" if binary else "model.safetensors"
        else:
            hf = {_hf_unet_vae_key(k): _hf_layout(k, v) for k, v in flat.items()}
            cfg = {k: v for k, v in cfg.items() if k != "model_type"}
            cfg.update(_class_name=cls, _diffusers_version="0.27.0", act_fn="silu")
            fname = "diffusion_pytorch_model." + ("bin" if binary else "safetensors")
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()}
        if binary:
            torch.save(tensors, os.path.join(dst, fname))
        else:
            st.save_file(tensors, os.path.join(dst, fname))
        with open(os.path.join(dst, "config.json"), "w") as f:
            json.dump(cfg, f)
    hf_index["safety_checker"] = [None, None]
    with open(os.path.join(out, "model_index.json"), "w") as f:
        json.dump(hf_index, f)


# --------------------------------------------------- JAX-written directories
@pytest.mark.parametrize("kind", ["sd", "sdxl"])
def test_port_reads_a_jax_written_pipeline(written, kind):
    jpipe, path = written[kind]
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu")
    assert type(pipe) is {"sd": StableDiffusionPipeline, "sdxl": StableDiffusionXLPipeline}[kind]
    assert isinstance(pipe.scheduler, PNDMScheduler if kind == "sd" else EulerDiscreteScheduler)
    assert pipe.tokenizer.encoder == jpipe.tokenizer.encoder
    assert pipe.tokenizer.model_max_length == jpipe.tokenizer.model_max_length
    ref = _jax_latents(jpipe, kind)
    out = pipe(**CALLS[kind], latents=latents_for(kind), output_type="latent")[0]
    # fp32 on both sides; the two steps amplify summation-order differences a little
    _assert_close(ref, out, tol=1e-4)


@pytest.mark.parametrize("kind", ["sd", "sdxl"])
def test_jax_reads_a_port_written_pipeline_bit_for_bit(written, kind, tmp_path):
    jpipe, path = written[kind]
    DiffusionPipeline.from_pretrained(path, device="cpu").save_pretrained(str(tmp_path))
    with open(tmp_path / "model_index.json") as f:
        assert json.load(f)["_class_name"] == type(jpipe).__name__
    back = JDiffusionPipeline.from_pretrained(str(tmp_path))
    assert type(back) is type(jpipe)
    for name in MODELS[kind]:
        want, got = flatten_params(getattr(jpipe, name).params), \
            flatten_params(getattr(back, name).params)
        assert sorted(want) == sorted(got), name
        for k in want:  # tolerance 0: the same fp32 bits
            assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), f"{name}: {k}"
    assert type(back.scheduler) is type(jpipe.scheduler)
    assert back.scheduler.config == jpipe.scheduler.config
    assert back.tokenizer.encoder == jpipe.tokenizer.encoder


# ------------------------------------------------------ diffusers' layout
def jax_untransposed(flat):
    """JAX takes a `.weight` under any module named "...embedding..." for a
    table and leaves it untransposed: the UNet's square time / add-embedding
    Linears then load transposed (ROADMAP C, faults of the reference; SD1.5's
    and SDXL's linear_2, 1280 x 1280); the others are put right by their
    shape."""
    return sorted(k for k, v in flat.items()
                  if re.fullmatch(r"(time|add)_embedding\.linear_\d\.kernel", k)
                  and v.shape[0] == v.shape[1])


@pytest.mark.parametrize("kind,binary", [("sd", False), ("sd", True), ("sdxl", False),
                                         ("sdxl", True)])
def test_diffusers_layout_reads_alike_in_jax_and_the_port(written, kind, binary, tmp_path):
    jpipe, path = written[kind]
    write_diffusers_layout(path, str(tmp_path), binary)
    if binary:
        assert os.path.isfile(tmp_path / "unet" / "diffusion_pytorch_model.bin")
    # the port: the same tensors as from the flax-keyed directory, bit for bit
    pipe = DiffusionPipeline.from_pretrained(str(tmp_path), device="cpu")
    flax_keyed = DiffusionPipeline.from_pretrained(path, device="cpu")
    for name in MODELS[kind]:
        a, b = getattr(pipe, name).state_dict(), getattr(flax_keyed, name).state_dict()
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), name
    out = pipe(**CALLS[kind], latents=latents_for(kind), output_type="latent")[0]
    _assert_close(_jax_latents(jpipe, kind), out, tol=1e-4)
    # JAX: every parameter as the flax-keyed directory has it but the square
    # time / add-embedding Linears, which it loads transposed
    jhf = JDiffusionPipeline.from_pretrained(str(tmp_path))
    for name in MODELS[kind]:
        want, got = flatten_params(getattr(jpipe, name).params), \
            flatten_params(getattr(jhf, name).params)
        diff = sorted(k for k in want if not np.array_equal(np.asarray(want[k]),
                                                            np.asarray(got[k])))
        assert diff == (jax_untransposed(want) if name == "unet" else []), name
        assert name != "unet" or "time_embedding.linear_2.kernel" in diff
        for k in diff:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]).T)


# ------------------------------------------------------------ VAE encoder
def test_vae_encoder_matches_jax():
    jvae = JVAE.from_config(JVAEConfig.from_dict(TINY_VAE))
    vae = AutoencoderKL(AutoencoderKLConfig(**TINY_VAE))
    vae.load_state_dict(flax_to_torch_state_dict(flatten_params(jvae.params), vae, VAE_KEY_MAP))
    x = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = jvae.encode(jnp.asarray(x))
    with torch.no_grad():
        post = vae.encode(torch.from_numpy(x))
        kl = post.kl()
        z = post.sample(torch.Generator().manual_seed(0))
    assert tuple(post.mean.shape) == (2, 16, 16, 4)
    for r, o in ((ref.mean, post.mean), (ref.logvar, post.logvar), (ref.kl(), kl),
                 (ref.mode(), post.mode())):
        _assert_close(r, o, tol=1e-5)  # fp32, summation order only
    # a draw: mean + exp(logvar / 2) * noise, the noise from the generator
    noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(z, post.mean + torch.exp(0.5 * post.logvar) * noise)


def test_vae_encoder_walk_at_sd15_width():
    """22 GroupNorm launches an encode at SD1.5's widths (2 a resnet, the
    mid attention's, conv_norm_out) and no flash: the 512-wide single head
    goes to math."""
    with torch.device("meta"):
        vae = AutoencoderKL(AutoencoderKLConfig(**SD15_VAE))
    assert n_group_norms(vae.encoder) == 22
    assert vae.encode_flash_launches(512, 512) == 0


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_automodel_reads_a_component_directory(written, kind):
    jpipe, path = written["sd"]
    cls = {"unet": UNet2DConditionModel, "vae": AutoencoderKL}[kind]
    a = AutoModel.from_pretrained(os.path.join(path, kind), device="cpu")
    b = AutoModel.from_pretrained(path, subfolder=kind, device="cpu")
    assert type(a) is cls and type(b) is cls
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())


# ------------------------------------------------------------- schedulers
@pytest.mark.parametrize("jcls,cls,kw", [
    (JPNDM, PNDMScheduler, dict(SD15_SCHEDULER, steps_offset=1)),
    (JEuler, EulerDiscreteScheduler, dict(beta_schedule="scaled_linear", beta_start=0.00085,
                                          beta_end=0.012, timestep_spacing="leading")),
    (JDDPM, DDPMScheduler, dict(beta_schedule="scaled_linear", prediction_type="v_prediction"))])
def test_scheduler_config_round_trip(jcls, cls, kw, tmp_path):
    jcls(**kw).save_pretrained(str(tmp_path / "jax"))
    port = cls.from_pretrained(str(tmp_path), subfolder="jax")
    ref = jcls(**kw)
    for k in kw:
        assert getattr(port.config, k) == getattr(ref.config, k), k
    np.testing.assert_array_equal(port.set_timesteps(10).timesteps.numpy(),
                                  np.asarray(ref.set_timesteps(10).timesteps))
    port.save_pretrained(str(tmp_path / "port"))
    assert jcls.from_pretrained(str(tmp_path / "port")).config == ref.config
    # a checkpoint's config of another scheduler: its keys set aside, as JAX does
    ddpm = DDPMScheduler.from_pretrained(str(tmp_path), subfolder="port")
    assert ddpm.config.beta_schedule == ref.config.beta_schedule


# --------------------------------------------------------------- refusals
def _copy_unet_without(src: str, dst: str, drop: str = None, reshape: str = None):
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "config.json"), dst)
    flat = st.load_file(os.path.join(src, "model.safetensors"))
    if drop:
        del flat[drop]
    if reshape:
        flat[reshape] = flat[reshape][..., :-1].contiguous()
    st.save_file(flat, os.path.join(dst, "model.safetensors"))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_a_checkpoint_short_of_a_parameter_is_refused(tmp_path, fault):
    """JAX's default (strict=False) keeps the random init of a missing
    parameter; the port refuses the directory, naming the key."""
    jpipe = jax_pipeline("sd", unet_seed=1)  # weights other than from_pretrained's seed-0 init
    jpipe.unet.save_pretrained(str(tmp_path / "saved"))
    key = "down_blocks_0.resnets_0.conv1.kernel"
    _copy_unet_without(str(tmp_path / "saved"), str(tmp_path / "unet"),
                       drop=key if fault == "missing" else None,
                       reshape=key if fault == "shape" else None)
    with pytest.raises(KeyError, match=r"down_blocks\.0\.resnets\.0\.conv1\.weight"):
        UNet2DConditionModel.from_pretrained(str(tmp_path), subfolder="unet", device="cpu")
    if fault == "missing":
        loose = JUNet.from_pretrained(str(tmp_path), subfolder="unet")
        kept = np.asarray(flatten_params(loose.params)[key])
        saved = np.asarray(flatten_params(jpipe.unet.params)[key])
        assert kept.shape == saved.shape and not np.allclose(kept, saved)


@pytest.mark.parametrize("cls", ["DPMSolverMultistepScheduler", "FancyScheduler"])
def test_an_unported_component_class_raises_naming_it(written, tmp_path, cls):
    _, path = written["sd"]
    shutil.copytree(path, tmp_path / "pipe")
    with open(tmp_path / "pipe" / "model_index.json") as f:
        index = json.load(f)
    index["scheduler"] = ["diffusers", cls]
    with open(tmp_path / "pipe" / "model_index.json", "w") as f:
        json.dump(index, f)
    with pytest.raises(NotImplementedError, match=cls):
        DiffusionPipeline.from_pretrained(str(tmp_path / "pipe"), device="cpu")


def test_optional_components_are_skipped(written, tmp_path, caplog):
    _, path = written["sd"]
    shutil.copytree(path, tmp_path / "pipe")
    with open(tmp_path / "pipe" / "model_index.json") as f:
        index = json.load(f)
    index.update(safety_checker=["stable_diffusion", "StableDiffusionSafetyChecker"],
                 feature_extractor=["transformers", "CLIPImageProcessor"],
                 requires_safety_checker=True)
    with open(tmp_path / "pipe" / "model_index.json", "w") as f:
        json.dump(index, f)
    with caplog.at_level(logging.WARNING):
        pipe = DiffusionPipeline.from_pretrained(str(tmp_path / "pipe"), device="cpu")
    assert isinstance(pipe, StableDiffusionPipeline)
    assert "safety_checker" in caplog.text and "feature_extractor" in caplog.text
    with pytest.raises(ValueError, match="NoSuchPipeline"):
        index["_class_name"] = "NoSuchPipeline"
        with open(tmp_path / "pipe" / "model_index.json", "w") as f:
            json.dump(index, f)
        DiffusionPipeline.from_pretrained(str(tmp_path / "pipe"), device="cpu")


@pytest.mark.parametrize("make,name", [
    (lambda: UNet2DConditionConfig.from_dict(dict(TINY_UNET_SD, tome_ratio=0.5)), "tome_ratio"),
    (lambda: UNet2DConditionConfig.from_dict(dict(TINY_UNET_SD, num_class_embeds=10)),
     "num_class_embeds"),
    (lambda: EulerDiscreteScheduler(use_karras_sigmas=True), "use_karras_sigmas"),
    (lambda: PNDMScheduler(prediction_type="v_prediction"), "prediction_type")])
def test_unported_config_options_raise(make, name):
    """A JAX config option the port has not ported, at another value than
    its default, raises naming it (the JAX-written configs carry them all)."""
    with pytest.raises(NotImplementedError, match=name):
        make()
