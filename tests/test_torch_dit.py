"""The port's DiT slice (paddlemix_tpu_torch.diffusers DiT model, DiTPipeline,
tools.train_dit) against the JAX package on shared weights, in fp32 on the
CPU.

One tiny JAX DiT is initialised for the module, its parameters moved by
seeded noise (JAX zero-initialises the adaLN Linears: with zero gates every
block is the identity) and carried over through `DIT_KEY_MAP`, every key
consumed. The JAX side runs its XLA forms (its adaLN's plain reference; at
16 tokens both packages route the attention to math). Compared: the
forward, `LabelEmbedding` with forced drops, DiTPipeline's latents under
DDIM and DPM-Solver++ at JAX's seeded noise, the directories each package
writes read by the other (transformer and scheduler: the VAE's directory IO
is the SD1.5 tests'), and the trainer's loss and gradients at JAX's draws.
The port alone: gradient checkpointing bit-equal, q / k / v reaching the
flash route as views of the fused projection, and the launch walks. The
card's cases are in tests/test_torch_dit_kernels.py."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.diffusers import DDIMScheduler as JDDIM
from paddlemix_tpu.diffusers import DDPMScheduler as JDDPM
from paddlemix_tpu.diffusers import DiffusionPipeline as JDiffusionPipeline
from paddlemix_tpu.diffusers import DiTPipeline as JDiTPipeline
from paddlemix_tpu.diffusers import DPMSolverMultistepScheduler as JDPM
from paddlemix_tpu.diffusers.models import DiTConfig as JDiTConfig
from paddlemix_tpu.diffusers.models import DiTModel as JDiT
from paddlemix_tpu.diffusers.models.embeddings import LabelEmbedding as JLabelEmbedding
from paddlemix_tpu_torch.core import (
    DIT_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
    torch_to_flax_state_dict,
)
from paddlemix_tpu_torch.diffusers import (
    AutoencoderKL,
    AutoencoderKLConfig,
    DDIMScheduler,
    DDPMScheduler,
    DiffusionPipeline,
    DiTConfig,
    DiTModel,
    DiTPipeline,
    DPMSolverMultistepScheduler,
)
from paddlemix_tpu_torch.diffusers.dit import (
    dit_forward_launches,
    expected_launches_dit,
    expected_launches_dit_train,
)
from paddlemix_tpu_torch.diffusers.models import LabelEmbedding
from paddlemix_tpu_torch.diffusers.models import dit as dit_mod
from paddlemix_tpu_torch.ops import attention as tattn
from paddlemix_tpu_torch.tools import train_dit

pytestmark = pytest.mark.torch_port

TINY_DIT = dict(sample_size=8, patch_size=2, in_channels=4, out_channels=8, hidden_size=64,
                num_layers=2, num_attention_heads=2, num_classes=10)
LABELS = [3, 7]
TOL = 2e-5


def _assert_close(ref, out, tol=TOL):
    """|out - ref| <= tol * max(1, |ref|max), elementwise."""
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def models():
    """(the JAX DiT with jittered parameters, the port's carrying them)."""
    cfg = JDiTConfig(**TINY_DIT)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32),
        JDiT.from_config(cfg, seed=0).params)
    jmodel = JDiT(cfg, params=params)
    model = DiTModel(DiTConfig(**TINY_DIT))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(params), model, DIT_KEY_MAP))
    return jmodel, model.eval()


def _inputs(seed=0, b=2):
    rs = np.random.RandomState(seed)
    s = TINY_DIT["sample_size"]
    return (rs.randn(b, s, s, 4).astype(np.float32), rs.randint(0, 1000, b).astype(np.float32),
            np.asarray([3, TINY_DIT["num_classes"]], np.int32))  # a label and the null class


def test_dit_forward_matches_jax(models):
    jmodel, model = models
    lat, t, labels = _inputs()
    assert all(float(np.abs(np.asarray(jmodel.params[f"blocks_{i}"]["adaLN_modulation"]
                                       ["kernel"])).max()) > 0 for i in range(2))
    ref = jax.jit(jmodel.module.apply)({"params": jmodel.params}, jnp.asarray(lat),
                                       jnp.asarray(t), jnp.asarray(labels))
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(labels).long())
    _assert_close(ref, out)


def test_label_embedding_force_drop_matches_jax():
    n, d = 10, 16
    labels = np.asarray([1, 4, 9, 2], np.int32)
    drop = np.asarray([True, False, True, False])
    jmod = JLabelEmbedding(n, d, 0.1)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(labels))["params"]
    emb = LabelEmbedding(n, d, 0.1)
    assert emb.embedding_table.weight.shape == (n + 1, d)
    emb.embedding_table.weight.data = torch.from_numpy(
        np.array(params["embedding_table"]["embedding"]))
    ref = jmod.apply({"params": params}, jnp.asarray(labels), force_drop_ids=jnp.asarray(drop))
    out = emb(torch.from_numpy(labels).long(), force_drop_ids=torch.from_numpy(drop))
    _assert_close(ref, out, 0)
    # a seeded draw drops labels to the null class (row n), nothing without one
    gen = torch.Generator().manual_seed(0)
    many = torch.arange(1000) % n
    dropped = (emb(many, generator=gen) == emb.embedding_table.weight[n]).all(-1)
    assert 50 < int(dropped.sum()) < 150
    assert torch.equal(emb(many), emb.embedding_table.weight[many])
    assert LabelEmbedding(n, d, 0.0).embedding_table.weight.shape == (n, d)


@pytest.mark.parametrize("kind", ["ddim", "dpmsolver"])
def test_dit_pipeline_matches_jax(models, kind):
    """DiTPipeline's latents at JAX's seeded noise, 4 steps of CFG 4.0. JAX's
    pipeline calls set_timesteps without the latents' shape, so under
    DPM-Solver++ its loop refuses the first step (C.39): the JAX side is
    given that shape, the port needs none."""
    jmodel, model = models
    steps, seed = 4, 3
    s = TINY_DIT["sample_size"]
    shape = (len(LABELS), s, s, 4)
    jsched = {"ddim": JDDIM, "dpmsolver": JDPM}[kind]()
    if kind == "dpmsolver":
        with pytest.raises(TypeError, match="x0_prev"):
            JDiTPipeline(transformer=jmodel, vae=None, scheduler=jsched)(
                LABELS, num_inference_steps=steps, seed=seed, output_type="latent")
        jsched.set_timesteps = functools.partial(jsched.set_timesteps, sample_shape=shape)
    ref = JDiTPipeline(transformer=jmodel, vae=None, scheduler=jsched)(
        LABELS, num_inference_steps=steps, seed=seed, output_type="latent")[0]
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    sched = {"ddim": DDIMScheduler, "dpmsolver": DPMSolverMultistepScheduler}[kind]()
    out = DiTPipeline(transformer=model, vae=None, scheduler=sched)(
        LABELS, num_inference_steps=steps, latents=noise, output_type="latent")[0]
    _assert_close(ref, out, 1e-4)


def test_dit_pipeline_decodes_with_the_vae(models):
    """The image is the VAE's decode of latents / scaling_factor, in [0, 1]."""
    _, model = models
    vae = AutoencoderKL(AutoencoderKLConfig(
        block_out_channels=(8, 16), down_block_types=("DownEncoderBlock2D",) * 2,
        up_block_types=("UpDecoderBlock2D",) * 2, layers_per_block=1, latent_channels=4,
        norm_num_groups=4)).eval()
    pipe = DiTPipeline(transformer=model, vae=vae, scheduler=DDIMScheduler())
    lat = pipe(LABELS, num_inference_steps=2, seed=1, output_type="latent")[0]
    image = pipe(LABELS, num_inference_steps=2, seed=1, output_type="np")[0]
    with torch.no_grad():
        want = (vae.decode(lat / vae.config.scaling_factor) / 2 + 0.5).clamp(0, 1)
    assert image.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(image, want.numpy(), rtol=0, atol=1e-6)


def test_dit_directories_both_ways(models, tmp_path):
    """The port's DiT directory (transformer, DDIM) read by the JAX package's
    DiffusionPipeline.from_pretrained, and JAX's (DPM-Solver++) by the
    port's: every parameter and the scheduler configs equal."""
    jmodel, model = models
    sched = DDIMScheduler(set_alpha_to_one=False, steps_offset=1)
    DiTPipeline(transformer=model, vae=None, scheduler=sched).save_pretrained(
        str(tmp_path / "port"))
    jpipe = JDiffusionPipeline.from_pretrained(str(tmp_path / "port"))
    assert type(jpipe).__name__ == "DiTPipeline" and jpipe.vae is None
    assert jpipe.scheduler.config.set_alpha_to_one is False
    assert jpipe.scheduler.config.steps_offset == 1
    mine = torch_to_flax_state_dict(model, DIT_KEY_MAP)
    theirs = flatten_flax(jpipe.transformer.params)
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(theirs[k]), v.numpy())

    JDiTPipeline(transformer=jmodel, vae=None, scheduler=JDPM(solver_order=1)).save_pretrained(
        str(tmp_path / "jax"))
    pipe = DiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert isinstance(pipe, DiTPipeline) and pipe.vae is None
    assert isinstance(pipe.scheduler, DPMSolverMultistepScheduler)
    assert pipe.scheduler.config.solver_order == 1
    for k, v in torch_to_flax_state_dict(pipe.transformer, DIT_KEY_MAP).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flatten_flax(jmodel.params)[k]))


def _jax_example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "train_dit.py")
    spec = importlib.util.spec_from_file_location("example_train_dit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_dit_loss_fn_matches_jax(models):
    """`dit_loss` at the draws JAX's loss makes from its key (split in 3:
    timesteps, noise, and an unused one), its loss and every gradient
    against jax.value_and_grad of the example's `make_dit_loss_fn`."""
    jmodel, model = models
    rs = np.random.RandomState(4)
    s = TINY_DIT["sample_size"]
    batch = {"latents": rs.randn(3, s, s, 4).astype(np.float32),
             "labels": rs.randint(0, 10, 3).astype(np.int32)}
    rng = jax.random.PRNGKey(7)
    jsched = JDDPM(num_train_timesteps=1000)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_example().make_dit_loss_fn(jmodel, jsched)))(
        jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    k_t, k_n, _ = jax.random.split(rng, 3)
    t = np.asarray(jax.random.randint(k_t, (3,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_n, (3, s, s, 4), jnp.float32))
    loss = train_dit.dit_loss(model, DDPMScheduler(num_train_timesteps=1000),
                              {k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.from_numpy(t).long(), torch.from_numpy(noise))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = flax_to_torch_state_dict(flatten_flax(jgrads), model, DIT_KEY_MAP)
    for name, g in zip(names, grads):
        _assert_close(want[name], g, 1e-4)


def test_train_dit_never_drops_labels_c35(models):
    """C.35: the example hands the model no rng, so no label is dropped and
    CFG's null class is never trained; the port's loss passes its label
    embedding neither a generator nor forced drops."""
    _, model = models
    seen = []
    hook = model.y_embedder.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append((args, kwargs)), with_kwargs=True)
    try:
        s = TINY_DIT["sample_size"]
        batch = {"latents": torch.randn(4, s, s, 4), "labels": torch.tensor([1, 2, 3, 4])}
        train_dit.make_dit_loss_fn(model, DDPMScheduler())(None, batch,
                                                            torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    (args, kwargs), = seen
    assert args[1] is None and args[2] is None and not kwargs
    assert not (args[0] == TINY_DIT["num_classes"]).any()
    src = open(os.path.join(os.path.dirname(__file__), "..", "examples", "train_dit.py")).read()
    assert "if False else None" in src


def test_dit_gradient_checkpointing_bit_equal(models):
    _, model = models
    lat, t, labels = (torch.from_numpy(a) for a in _inputs(5))
    params = list(model.parameters())
    out = []
    try:
        for on in (False, True):
            model.config.gradient_checkpointing = on
            loss = model(lat, t, labels.long()).square().mean()
            out.append((loss, torch.autograd.grad(loss, params)))
    finally:
        model.config.gradient_checkpointing = False
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_dit_attention_reads_fused_qkv_in_place(monkeypatch):
    """At 256 tokens and head 72 (DiT-XL/2's) the attention takes flash; q,
    k and v reach it as strided views of the qkv projection's output, which
    the kernels read in place (`_kernel_operand` returns them as they are)."""
    cfg = dict(TINY_DIT, sample_size=32, hidden_size=144, num_layers=1)
    model = DiTModel(DiTConfig(**cfg)).eval()
    seen, qkv_out = [], []
    model.blocks[0].qkv.register_forward_hook(lambda m, a, out: qkv_out.append(out))
    real = dit_mod.scaled_dot_product_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(dit_mod, "scaled_dot_product_attention", spy)
    with torch.no_grad():
        model(torch.randn(2, 32, 32, 4), torch.tensor([5, 900]), torch.tensor([1, 2]))
    (q, k, v), = seen
    base = qkv_out[0]
    assert q.shape == (2, 256, 2, 72) and tattn.use_flash(q.shape, k.shape)
    for i, t in enumerate((q, k, v)):
        assert not t.is_contiguous() and t.stride() == (256 * 432, 432, 72, 1)
        assert t.data_ptr() == base.data_ptr() + i * 144 * base.element_size()
        assert tattn._kernel_operand(t) is t


def test_dit_launch_walks():
    """At DiT-XL/2-256's widths (on the meta device): 57 adaLN launches a
    forward (two a block and the final one) and 28 flash ones at (16, 256,
    16, 72) a CFG step of 8 labels; in training with checkpointing, each
    block's forward kernels twice. On a tiny pipeline at 256 tokens the
    calls counted equal the walk."""
    with torch.device("meta"):
        model = DiTModel(DiTConfig())
        vae = AutoencoderKL(AutoencoderKLConfig())
    pipe = DiTPipeline(transformer=model, vae=vae, scheduler=DDIMScheduler())
    want = expected_launches_dit(pipe, 8, 25)
    assert want["adaptive_layer_norm"] == 57 * 25 and want["flash_attention"] == 28 * 25
    assert want["group_norm"] == 30
    model.config.gradient_checkpointing = True
    assert expected_launches_dit_train(model, 16, 2) == {
        "adaptive_layer_norm": 113 * 2, "flash_fwd_lse": 56 * 2, "flash_bwd_dkv": 28 * 2,
        "flash_bwd_dq": 28 * 2}

    tiny = DiTModel(DiTConfig(**dict(TINY_DIT, sample_size=32))).eval()
    pipe = DiTPipeline(transformer=tiny, vae=None, scheduler=DDIMScheduler())
    counts = {"adaptive_layer_norm": 0, "flash_attention": 0}

    def counted(mod, name):
        real = getattr(mod, name)

        def run(*a, **kw):
            counts[name] += 1
            return real(*a, **kw)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dit_mod, "adaptive_layer_norm", counted(dit_mod, "adaptive_layer_norm"))
        mp.setattr(tattn, "flash_attention", counted(tattn, "flash_attention"))
        pipe([1], num_inference_steps=2, output_type="latent")
    assert counts == {k: v * 2 for k, v in dit_forward_launches(tiny, 2).items()}
