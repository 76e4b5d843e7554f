"""DreamBooth and the diffusion entry points of the port against the JAX
package: the DreamBooth loss at JAX's draws (examples/train_dreambooth.py's
`make_dreambooth_loss_fn`, imported by path), LoRA over the UNet (JAX's
`lora_init` targets, the forward with the same factors against JAX's
`merge_params`, the adapter read back by JAX's `load_lora`), and the four
mains (text_to_image, train_text_to_image, train_dreambooth_lora,
train_dreambooth) at tiny size on a directory the JAX package writes, two
steps each. fp32 on the CPU; the models come from the JAX modules' seeded
init, the inputs and images from numpy."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.diffusers import UNet2DConditionModel as JUNet
from paddlemix_tpu.diffusers.schedulers import DDPMScheduler as JDDPM
from paddlemix_tpu.peft import LoraConfig as JLoraConfig
from paddlemix_tpu.peft import load_lora as jload_lora
from paddlemix_tpu.peft import lora_init as jlora_init
from paddlemix_tpu.peft import merge_params as jmerge_params
from paddlemix_tpu_torch.core import (
    UNET_KEY_MAP,
    flax_to_torch_state_dict,
    lora_from_flax,
    lora_to_flax,
    torch_to_flax_state_dict,
)
from paddlemix_tpu_torch.diffusers import (
    DDPMScheduler,
    UNet2DConditionConfig,
    UNet2DConditionModel,
)
from paddlemix_tpu_torch.diffusers.sd15 import SD15_SCHEDULER, SD15_UNET
from paddlemix_tpu_torch.peft import LoraConfig, lora_init, lora_params, save_lora
from paddlemix_tpu_torch.tools import text_to_image, train_dreambooth, train_dreambooth_lora
from paddlemix_tpu_torch.tools import train_text_to_image
from test_pipelines import tiny_unet
from test_torch_diffusers_io import jax_pipeline

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_UNET_SD15 = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8,
)


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def unets():
    """The tiny SD1.5-layout UNet in JAX and in the port, on the same weights."""
    junet = tiny_unet(ctx_dim=32)
    unet = UNet2DConditionModel(UNet2DConditionConfig(**TINY_UNET_SD15))
    unet.load_state_dict(flax_to_torch_state_dict(flatten_params(junet.params), unet,
                                                  UNET_KEY_MAP))
    return junet, unet.eval()


def _batch(seed=0, b=4):
    rs = np.random.RandomState(seed)
    return {"latents": rs.randn(b, 8, 8, 4).astype(np.float32),
            "encoder_hidden_states": rs.randn(b, 6, 32).astype(np.float32),
            "is_prior": np.array([0, 1, 0, 1][:b], np.float32)}


# -------------------------------------------------------- the loss
@pytest.mark.parametrize("prior_w", [1.0, 0.3])
def test_dreambooth_loss_matches_jax(unets, prior_w):
    junet, unet = unets
    jsched, sched = JDDPM(**SD15_SCHEDULER), DDPMScheduler(**SD15_SCHEDULER)
    batch = _batch()
    key = jax.random.PRNGKey(7)
    ref = _example("train_dreambooth").make_dreambooth_loss_fn(junet, jsched, prior_w)(
        junet.params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    # the JAX loss's own draws (its body splits the key, then randint / normal)
    rng_t, rng_n = jax.random.split(key)
    t = np.array(jax.random.randint(rng_t, (4,), 0, 1000))
    noise = np.array(jax.random.normal(rng_n, (4, 8, 8, 4), jnp.float32))
    with torch.no_grad():
        out = train_dreambooth.dreambooth_loss(
            unet, sched, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(t).long(), torch.from_numpy(noise), prior_w)
    assert abs(float(out) - float(ref)) <= 1e-5 * abs(float(ref))  # fp32 summation order


# ------------------------------------------------------ LoRA over the UNet
def _port_lora(unet_cfg, flax_params, jlora=None):
    unet = UNet2DConditionModel(UNet2DConditionConfig(**unet_cfg))
    unet.load_state_dict(flax_to_torch_state_dict(flatten_params(flax_params), unet,
                                                  UNET_KEY_MAP))
    lcfg = LoraConfig(r=8, lora_alpha=16)
    lora_init(unet, lcfg, torch.Generator().manual_seed(0), key_map=unet.flax_key_map)
    if jlora is not None:
        lora_from_flax(jlora, unet, UNET_KEY_MAP)
    return unet.eval(), lcfg


def test_lora_targets_are_jaxs(unets):
    junet, _ = unets
    jlora = jlora_init(junet.params, JLoraConfig(r=8, lora_alpha=16), jax.random.PRNGKey(0))
    unet, _ = _port_lora(TINY_UNET_SD15, junet.params)
    assert sorted(lora_to_flax(unet, UNET_KEY_MAP)) == sorted(jlora)
    # to_q / to_k / to_v / to_out of both attentions of each of the 4
    # transformer blocks (down, mid, and the up level's 2)
    assert len(jlora) == 4 * 2 * 4 and all(p[-2] in ("to_q", "to_k", "to_v", "to_out")
                                       for p in jlora)


def test_lora_targets_at_sd15_width():
    """SD1.5: 16 transformer blocks x 2 attentions x 4 projections."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNet2DConditionConfig(**SD15_UNET))
        lora_init(unet, LoraConfig(r=8, lora_alpha=16), key_map=unet.flax_key_map)
    assert len(lora_params(unet)) == 2 * 128


def test_lora_forward_and_adapter_match_jax(unets, tmp_path):
    junet, _ = unets
    jcfg = JLoraConfig(r=8, lora_alpha=16)
    jlora = jlora_init(junet.params, jcfg, jax.random.PRNGKey(0))
    # b drawn non-zero, so that the delta shows
    keys = iter(jax.random.split(jax.random.PRNGKey(1), len(jlora)))
    jlora = {p: {"a": ab["a"], "b": 0.05 * jax.random.normal(next(keys), ab["b"].shape)}
             for p, ab in jlora.items()}
    unet, lcfg = _port_lora(TINY_UNET_SD15, junet.params, jlora)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 6, 32).astype(np.float32)
    t = np.array([10, 500])
    merged = jmerge_params(junet.params, jlora, jcfg)
    ref = np.asarray(junet.apply(merged, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    base = np.asarray(junet.apply(junet.params, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx)))
    with torch.no_grad():
        out = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert _rel(out, ref) <= 1e-5  # fp32, summation order only
    assert _rel(base, ref) > 1e-3  # the factors change the output
    path = save_lora(lora_params(unet), lcfg, str(tmp_path / "lora"), key_map=UNET_KEY_MAP)
    assert os.path.isfile(path)
    back, bcfg = jload_lora(str(tmp_path / "lora"))
    assert sorted(back) == sorted(jlora) and bcfg.r == 8 and bcfg.lora_alpha == 16
    assert bcfg.target_modules == jcfg.target_modules
    for p in jlora:  # the same fp32 factors, bit for bit
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[p][k]), np.asarray(jlora[p][k]))


# ------------------------------------------------------------- the mains
@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny SD directory written by the JAX package's save_pretrained, and
    dirs of seeded jpegs."""
    root = tmp_path_factory.mktemp("dreambooth")
    jpipe = jax_pipeline("sd")
    jpipe.save_pretrained(str(root / "ckpt"))
    rs = np.random.RandomState(0)
    for sub, n in (("instance", 2), ("class", 2)):
        os.makedirs(root / sub)
        for i in range(n):
            pixels = (rs.rand(40, 48, 3) * 255).astype(np.uint8)
            Image.fromarray(pixels).save(root / sub / f"{i}.jpg", quality=90)
    return jpipe, root


def test_text_to_image_main_writes_a_png(ckpt):
    _, root = ckpt
    out = text_to_image.main([str(root / "ckpt"), "a cat", str(root / "cat.png")],
                             device="cpu", height=32, width=32, num_inference_steps=2)
    with Image.open(out) as im:
        assert im.size == (32, 32) and im.mode == "RGB"


def test_train_text_to_image_main_runs(ckpt, tmp_path):
    _, root = ckpt
    trainer, result = train_text_to_image.main([str(root / "ckpt")], device="cpu", max_steps=2,
                                               output_dir=str(tmp_path))
    assert result["final_step"] == 2 and np.isfinite(result["loss"])
    assert trainer.model.config.sample_size == 8  # the example's data at the UNet's widths


def test_train_dreambooth_lora_main_writes_an_adapter(ckpt, tmp_path):
    jpipe, root = ckpt
    trainer, result, out = train_dreambooth_lora.main(
        [str(root / "ckpt"), str(root / "instance"), "a sks dog"], device="cpu", resolution=32,
        max_steps=2, output_dir=str(tmp_path))
    assert result["final_step"] == 2 and np.isfinite(result["loss"])
    factors, cfg = jload_lora(out)
    jlora = jlora_init(jpipe.unet.params, JLoraConfig(r=8, lora_alpha=16),
                       jax.random.PRNGKey(0))
    assert sorted(factors) == sorted(jlora) and (cfg.r, cfg.lora_alpha) == (8, 16)
    # lr 1e-4 over two steps moves every b off its zero init
    assert all(np.abs(np.asarray(ab["b"])).max() > 0 for ab in factors.values())


def test_train_dreambooth_main_writes_a_unet_jax_reads(ckpt, tmp_path):
    jpipe, root = ckpt
    trainer, result, out = train_dreambooth.main(
        [str(root / "ckpt"), str(root / "instance"), "a sks dog", str(root / "class"),
         "a dog", "1.0"], device="cpu", resolution=32, max_steps=2, output_dir=str(tmp_path))
    assert result["final_step"] == 2 and np.isfinite(result["loss"])
    # two instance and two class samples, marked apart
    assert sorted(float(s["is_prior"]) for s in trainer.train_dataloader.dataset.data[:4]) == \
        [0.0, 0.0, 1.0, 1.0]
    got = flatten_params(JUNet.from_pretrained(out).params)
    mine = torch_to_flax_state_dict(trainer.model, UNET_KEY_MAP)
    assert sorted(got) == sorted(mine)
    for k in got:  # the trained fp32 weights, bit for bit
        np.testing.assert_array_equal(np.asarray(got[k]), mine[k].numpy())
    start = flatten_params(jpipe.unet.params)
    assert any(not np.array_equal(np.asarray(start[k]), np.asarray(got[k])) for k in got)
