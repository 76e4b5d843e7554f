"""The CLIP ViT-B/16 slice in the port (models.clip.CLIPModel, the bench
forward models.clip.vitb16.pair_logits, tools/train_clip -> Trainer ->
AdamW), held against the JAX package on the CPU: a tiny dual tower (2 layers
a tower, 128 wide, MLP 256, batch 4) carried from JAX through
core.convert, its features, logits and contrastive loss in fp32 and in bf16
compute; FusedLayerNorm against the JAX FusedLayerNorm; the tiny model
trained 3 optimizer steps through `build_trainer` against the JAX `Trainer`
with examples/train_clip.py's loss; the launch walks; and the Trainer's
device put-ahead.

bf16 compute differs from JAX by rounding: flax's LayerNorm normalises and
applies its scale and bias in bf16, the port's B10 does all of it in fp32
and rounds once, and the bf16 elementwise ops round per op on each side.
"""

import functools
import importlib.util
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.datasets import DataLoader as JDataLoader
from paddlemix_tpu.models.clip import CLIPConfig as JCLIPConfig
from paddlemix_tpu.models.clip import CLIPModel as JCLIPModel
from paddlemix_tpu.models.clip import clip_contrastive_loss as jclip_contrastive_loss
from paddlemix_tpu.models.layers import FusedLayerNorm as JFusedLayerNorm
from paddlemix_tpu.trainer import Trainer as JTrainer
from paddlemix_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlemix_tpu_torch.core import (
    CLIP_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
    init_weights_,
)
from paddlemix_tpu_torch.models import layers as layers_mod
from paddlemix_tpu_torch.models.clip import CLIPConfig, CLIPModel, clip_contrastive_loss
from paddlemix_tpu_torch.models.clip.vitb16 import (
    VITB16,
    expected_launches_clip,
    forward_flops,
    pair_logits,
    seeded_inputs,
)
from paddlemix_tpu_torch.models.layers import FusedLayerNorm
from paddlemix_tpu_torch.ops import norms as tnorms
from paddlemix_tpu_torch.ops.attention import use_flash
from paddlemix_tpu_torch.tools import train_clip
from paddlemix_tpu_torch.trainer import trainer as trainer_mod

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1000
TINY = dict(vision_config=dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                               num_attention_heads=2, image_size=32, patch_size=16),
            text_config=dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=256,
                             num_hidden_layers=2, num_attention_heads=2,
                             max_position_embeddings=77, eos_token_id=VOCAB - 1),
            projection_dim=64)
# fp32: the two differ by summation order, ~1e-6 relative. bf16 compute: by
# rounding (see the module docstring), ~1e-2 of the features after 2 layers a
# tower and ~5e-3 of the loss on this CPU.
FP32_REL, BF16_REL, BF16_LOSS_REL = 5e-6, 3e-2, 2e-2
DTYPES = {"fp32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b):
    a, b = (np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)
            for t in (a, b))
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def example():
    """examples/train_clip.py, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        "train_clip_example", os.path.join(REPO, "examples", "train_clip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jparams():
    """The tiny JAX CLIPModel's fp32 params (from_config in fp32)."""
    return JCLIPModel.from_config(JCLIPConfig(**TINY), seed=0).params


def _port(jparams, compute_dtype):
    model = CLIPModel(CLIPConfig(**TINY), dtype=compute_dtype)
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(jparams), model, CLIP_KEY_MAP))
    return model


# ------------------------------------------------------------- the dual tower
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dual_tower_matches_jax(jparams, dtype):
    jdt, tdt = DTYPES[dtype]
    jmodel = JCLIPModel(JCLIPConfig(**TINY), dtype=jdt)  # fp32 params, jdt compute: the bench's
    model = _port(jparams, tdt)
    px, ids = seeded_inputs(CLIPConfig(**TINY), 4, seed=1, device="cpu")
    jpx = jnp.asarray(px.numpy()).astype(jdt)
    jids = jnp.asarray(ids.numpy())
    apply = functools.partial(jmodel.module.apply, {"params": jparams})
    want = {"image": apply(jpx, method=jmodel.module.encode_image),
            "text": apply(jids, method=jmodel.module.encode_text)}
    img, txt, scale = apply(jpx, jids)

    def bench_fwd(params, px_, ids_):  # the function bench_clip_pairs jits
        i_, t_, s_ = jmodel.module.apply({"params": params}, px_, ids_)
        return s_ * i_ @ t_.T

    want.update(img=img, txt=txt, logits=bench_fwd(jparams, jpx, jids))
    # fp32 logits: exp(logit_scale) is an fp32 0-d array, which promotes the features
    assert jax.eval_shape(bench_fwd, jparams, jpx, jids).dtype == jnp.float32
    with torch.no_grad():
        tpx = px.to(tdt or torch.float32)
        got = {"image": model.encode_image(tpx), "text": model.encode_text(ids)}
        got["img"], got["txt"], tscale = model(tpx, ids)
        got["logits"] = pair_logits(model, tpx, ids)
        loss = clip_contrastive_loss(got["img"], got["txt"], tscale)
    assert got["logits"].dtype == torch.float32 and got["img"].dtype == (tdt or torch.float32)
    assert tscale.dtype == torch.float32 and abs(float(tscale) - float(scale)) <= 1e-6
    rels = {k: _rel(got[k], want[k]) for k in want}
    assert max(rels.values()) <= (FP32_REL if dtype == "fp32" else BF16_REL), rels
    jloss = float(jclip_contrastive_loss(img, txt, scale))
    assert abs(float(loss) - jloss) <= (FP32_REL if dtype == "fp32" else BF16_LOSS_REL) * jloss
    # the text tower pools at the first eos, which these ids place at 4-76
    eos = (ids == VOCAB - 1).int().argmax(dim=-1)
    assert len(set(eos.tolist())) > 1 and bool((eos > 3).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_norm_matches_jax_fused_layer_norm(monkeypatch, dtype):
    """The same params through JAX's FusedLayerNorm, which takes its Pallas
    kernel (interpret mode here) at 128 rows of 256."""
    import paddlemix_tpu.ops.norms as jnorms

    monkeypatch.setenv("PMIX_KERNEL_BACKEND", "pallas")
    monkeypatch.setenv("PMIX_PALLAS_INTERPRET", "1")
    calls = []
    pallas_call = jnorms.pl.pallas_call
    monkeypatch.setattr(jnorms.pl, "pallas_call",
                        lambda *a, **kw: calls.append(1) or pallas_call(*a, **kw))
    rs = np.random.RandomState(5)
    x = (2 * rs.randn(2, 64, 256) + rs.randn(2, 64, 1)).astype(np.float32)
    w, b = (1 + 0.2 * rs.randn(256)).astype(np.float32), (0.2 * rs.randn(256)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = JFusedLayerNorm(epsilon=1e-5).apply({"params": {"scale": w, "bias": b}}, jx)
    assert len(calls) == 1 and want.dtype == jx.dtype
    norm = FusedLayerNorm(256, eps=1e-5)
    # nn.LayerNorm's names, which the CLIP key map renames to flax's
    assert list(norm.state_dict()) == ["weight", "bias"] and norm.weight.dtype == torch.float32
    norm.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = norm(torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    else:  # one rounding of the same fp32 math on each side: at most a step apart
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_convert_carries_the_dual_towers_params(jparams):
    """Every JAX param lands in the port's model once (the conversion raises
    otherwise), the projections transposed and the 0-d logit scale as is."""
    model = _port(jparams, None)
    flat = flatten_flax(jparams)
    assert {"visual_projection.kernel", "text_projection.kernel", "logit_scale"} <= set(flat)
    np.testing.assert_array_equal(model.visual_projection.weight.detach().numpy(),
                                  np.asarray(flat["visual_projection.kernel"]).T)
    np.testing.assert_array_equal(model.text_projection.weight.detach().numpy(),
                                  np.asarray(flat["text_projection.kernel"]).T)
    scale = model.logit_scale.detach()
    assert scale.shape == () and float(scale) == float(flat["logit_scale"])
    assert abs(float(flat["logit_scale"]) - 2.6592) < 1e-6
    np.testing.assert_array_equal(model.vision_model.post_layernorm.bias.detach().numpy(),
                                  np.asarray(flat["vision_model.post_layernorm.bias"]))


def test_contrastive_loss_refuses_a_mesh_axis():
    feats = torch.randn(4, 8)
    with pytest.raises(NotImplementedError, match="axis_name"):
        clip_contrastive_loss(feats, feats, torch.tensor(1.0), axis_name="data")


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_clip_matches_jax_trainer(example, jparams, tmp_path, monkeypatch, dtype):
    """3 optimizer steps of the example's recipe at batch 4 over 16 seeded
    (pixels, caption) pairs: the JAX Trainer with the example's loss_fn and
    loader (and `data_parallel_degree` 1: the suite's 8-device CPU would build
    a mesh), the port through `build_trainer`. Both hold fp32 params and
    compute in `dtype` (see tools/train_clip.py on the example's bf16 params)."""
    jdt, tdt = DTYPES[dtype]
    steps, batch, lr = 3, 4, 5e-4
    rs = np.random.RandomState(2)
    items = [(rs.standard_normal((32, 32, 3)).astype(np.float32),
              f"synthetic image number {i} of rolled noise") for i in range(16)]
    # the example's hash tokenizer hashes words with Python's str hash, which
    # is salted per process: the ids, and so the batches, the losses and the
    # two sides' fp32 gap, changed from run to run. A stable word hash in the
    # example's namespace gives every run the same ids; both sides read them
    monkeypatch.setattr(example, "hash", lambda w: zlib.crc32(w.encode()), raising=False)
    data = train_clip.ImageTextDataset(items, functools.partial(example._hash_tokenize,
                                                                vocab=VOCAB))
    jmodel = JCLIPModel(JCLIPConfig(**TINY), dtype=jdt)
    jmodel.params = jax.tree_util.tree_map(jnp.array, jparams)

    def loss_fn(params, batch_, rng):  # examples/train_clip.py's
        img, txt, scale = jmodel.module.apply(
            {"params": params}, batch_["pixel_values"].astype(jnp.bfloat16),
            batch_["input_ids"])
        return jclip_contrastive_loss(img, txt, scale), {}

    seen = []
    args = JTrainingArguments(output_dir=str(tmp_path), learning_rate=lr,
                              warmup_steps=min(200, max(steps // 10, 1)), max_steps=steps,
                              logging_steps=1, save_steps=1000, benchmark=True,
                              data_parallel_degree=1)
    loader = JDataLoader(data, batch_size=batch, shuffle=True, num_workers=8, prefetch_batches=8)
    jtrainer = JTrainer(model=jmodel, args=args, loss_fn=loss_fn, train_dataloader=loader,
                        callbacks=[lambda step, metrics: seen.append(
                            (float(metrics["loss"]), float(metrics["grad_norm"])))])
    jtrainer.train()
    model = _port(jparams, tdt)
    trainer = train_clip.build_trainer(model, data, batch, steps)
    result = trainer.train()
    assert result["final_step"] == steps and trainer.state.opt_state["count"] == steps
    got = np.asarray([(float(h["loss"]), float(h["grad_norm"])) for h in trainer.history])
    init = flax_to_torch_state_dict(flatten_flax(jparams), model, CLIP_KEY_MAP)
    final = flax_to_torch_state_dict(flatten_flax(jtrainer.state.params), model, CLIP_KEY_MAP)
    state = model.state_dict()
    # the key projections' biases have a zero gradient (softmax ignores a
    # shift common to a row's logits): theirs is rounding noise on each side,
    # which Adam, dividing by its own rms, turns into whole steps of either
    # sign: the two updates (rates lr and lr / 2) move each side up to ~2 lr
    noise = [k for k in final if k.endswith("k_proj.bias")]
    assert len(noise) == 4

    def gaps(keys, ref):
        return np.concatenate([(state[k] - ref[k]).abs().numpy().ravel() for k in keys])

    signal = [k for k in final if k not in noise]
    errs, moves = gaps(signal, final), np.concatenate(
        [(final[k] - init[k]).abs().numpy().ravel() for k in signal])
    assert gaps(noise, final).max() <= 4 * lr
    # every tensor moved on both sides (the first update's rate is 0: warmup 1)
    assert all(not torch.equal(state[k], init[k]) and not torch.equal(final[k], init[k])
               for k in final)
    if dtype == "fp32":
        np.testing.assert_allclose(got, np.asarray(seen), rtol=2e-6, atol=0)
        # where a gradient element is near 0 (near Adam's eps) the two sides'
        # rounding still moves a share of a step: the bulk agrees to ~1e-8, a
        # few elements to within 5% of a step
        assert errs.max() <= 0.05 * lr and np.quantile(errs, 0.999) <= 1e-6 \
            and errs.mean() <= 1e-7, (errs.max(), np.quantile(errs, 0.999), errs.mean())
    else:
        # bf16 rounding moves the losses ~3e-3 and the gradient norms ~1.6%
        # here; where a gradient element is near 0 its sign can differ, so an
        # element may move the other way: at most twice the largest step JAX
        # took, and on average a few percent of JAX's mean step
        np.testing.assert_allclose(got[:, 0], np.asarray(seen)[:, 0], rtol=1e-2, atol=0)
        np.testing.assert_allclose(got[:, 1], np.asarray(seen)[:, 1], rtol=5e-2, atol=0)
        assert errs.max() <= 2 * moves.max() and errs.mean() <= 0.1 * moves.mean(), \
            (errs.max(), moves.max(), errs.mean(), moves.mean())


def _config_fields(cfg):
    return {k: getattr(cfg, k) for k in ("text_config", "vision_config", "projection_dim",
                                         "logit_scale_init_value")}


def test_recipe_pieces_equal_the_example(example):
    assert _config_fields(VITB16) == _config_fields(example.VITB16)
    for caption in ("a photo of a cat", "synthetic image number 7 of rolled noise", ""):
        np.testing.assert_array_equal(train_clip._hash_tokenize(caption),
                                      example._hash_tokenize(caption))
    trainer = train_clip.build_trainer(_port(JCLIPModel.from_config(JCLIPConfig(**TINY)).params,
                                             None), [], 4, 500)
    a = trainer.args
    assert (a.learning_rate, a.warmup_steps, a.max_steps, a.lr_scheduler_type, a.max_grad_norm,
            a.weight_decay, a.save_steps) == (5e-4, 50, 500, "cosine", 1.0, 0.0, 0)
    with pytest.raises(NotImplementedError, match="CLIPImageProcessor"):
        train_clip.main(["--synthetic"])


# ----------------------------------------------------------- launch walks
def test_expected_launches_clip_at_full_width_on_meta():
    """ViT-B/16: 12 blocks x 2 + pre- and post-LN, 12 x 2 + the final LN:
    51 B10 launches a forward and, all parameters training, 51 backward;
    both towers' attention is math at the bench's batch (no flash)."""
    with torch.device("meta"):
        model = CLIPModel(VITB16)
    n = sum(p.numel() for p in model.parameters())
    assert 149.5e6 < n < 149.7e6  # CLIP ViT-B/16: 149.6 M parameters
    assert expected_launches_clip(model, forwards=1, backwards=1) == {
        "layer_norm": 51, "layer_norm_backward": 51}
    assert expected_launches_clip(model, forwards=10) == {"layer_norm": 510,
                                                          "layer_norm_backward": 0}
    v, t = VITB16.vision, VITB16.text
    assert not use_flash((256, 197, 12, 64), (256, 197, 12, 64))
    assert not use_flash((256, 77, 8, 64), (256, 77, 8, 64), causal=True)
    # bench.py's analytic count at batch 256 (its literal widths)
    def tower(n_, d, dff, layers):
        return layers * (2 * n_ * d * (4 * d + 2 * dff) + 2 * 2 * n_ * n_ * d)
    want = 256 * (tower(197, 768, 3072, 12) + 2 * 197 * (3 * 16 * 16) * 768
                  + tower(77, 512, 2048, 12) + 2 * (768 * 512 + 512 * 512))
    assert forward_flops(VITB16, 256) == want and 1.05e13 < want < 1.06e13
    assert (v.hidden_size, t.hidden_size, VITB16.projection_dim) == (768, 512, 512)


def test_train_step_launches_match_walk(monkeypatch):
    """One training step of the tiny model on the CPU: each wrapper called as
    often as the walk says its kernel would launch on a card."""
    counts = {"layer_norm": 0, "layer_norm_backward": 0}

    def count(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)

    count(layers_mod, "layer_norm")
    count(tnorms, "layer_norm_backward")
    model = init_weights_(CLIPModel(CLIPConfig(**TINY), dtype=torch.bfloat16),
                          torch.Generator().manual_seed(0))
    rs = np.random.RandomState(3)
    items = [(rs.standard_normal((32, 32, 3)).astype(np.float32), f"caption {i}")
             for i in range(8)]
    data = train_clip.ImageTextDataset(items, functools.partial(train_clip._hash_tokenize,
                                                                vocab=VOCAB))
    train_clip.build_trainer(model, data, 4, 1).train()
    assert counts == expected_launches_clip(model, forwards=1, backwards=1) == {
        "layer_norm": 11, "layer_norm_backward": 11}


# ------------------------------------------------------- device put-ahead
def test_prefetch_keeps_order_and_counts_the_wait():
    prepared = []

    def prepare(b):
        prepared.append(b)
        return b * 10

    gen = trainer_mod._prefetch_to_device(iter(range(5)), prepare, depth=3)
    stall, first = next(gen)
    assert first == 0 and prepared == [0, 1, 2] and stall >= 0  # 3 in hand before the first
    assert [b for _, b in gen] == [10, 20, 30, 40]
    assert [b for _, b in trainer_mod._prefetch_to_device(iter(range(3)), prepare, 0)] == \
        [0, 10, 20]


def test_device_put_ahead_leaves_sft_losses_unchanged():
    """The LoRA SFT slice gives the same losses and gradients with batches put
    ahead (depth 2) and without (depth 0)."""
    from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddlemix_tpu_torch.tools.supervised_finetune import build_trainer

    rs = np.random.RandomState(4)
    samples = []
    for _ in range(12):
        ids = rs.randint(3, 64, rs.randint(10, 40)).tolist()
        samples.append({"input_ids": ids, "labels": ids})
    cfg = dict(max_length=64, per_device_train_batch_size=2, learning_rate=1e-3, warmup_steps=1,
               max_steps=4, save_steps=0, logging_steps=1, lora=True, lora_rank=4, lora_alpha=8,
               seed=0)
    runs = []
    for depth in (0, 2):
        torch.manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                             num_hidden_layers=2, num_attention_heads=2,
                                             max_position_embeddings=64))
        trainer, _ = build_trainer(model, samples, dict(cfg, prefetch_depth=depth))
        trainer.train()
        runs.append([(float(h["loss"]), float(h["grad_norm"])) for h in trainer.history])
    assert len(runs[0]) == 4 and runs[0] == runs[1]


def test_jax_example_trains_bf16_parameters():
    """A finding on the reference: examples/train_clip.py builds
    `CLIPModel.from_config(VITB16, dtype=bfloat16)`, and `from_config` casts
    every floating parameter to that dtype (so optax keeps bf16 moments);
    the bench's fp32 params with bf16 compute are the form the port keeps."""
    leaves = jax.tree_util.tree_leaves(
        JCLIPModel.from_config(JCLIPConfig(**TINY), seed=0, dtype=jnp.bfloat16).params)
    assert leaves and all(leaf.dtype == jnp.bfloat16 for leaf in leaves)
    model = CLIPModel(CLIPConfig(**TINY), dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
