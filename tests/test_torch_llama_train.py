"""The Llama LoRA SFT slice in the port (tools/supervised_finetune ->
Trainer -> AdamW), held against the JAX package on the CPU: MixToken packing,
`pad_collate` and the shuffled DataLoader order; the schedules, clip, AdamW
and gradient accumulation against optax; the JAX LoRA factors carried into
the port's layout; and the whole slice on the tiny model of
tools/tpu_train_smoke.py (2 layers, 512 wide, 8 query heads on 4 kv heads,
vocab 512), with the JAX LoRA factors carried across, trained 3 optimizer
steps x accumulation 2 against the JAX `Trainer`, with recompute off and
on. Also the JAX SFT loss's fault under LLaVA (packed positions reach the
model as pixel values), shown at a tiny size, the launch walk of a training
micro-batch, and the paged cache refusing a step past its pool.

The JAX side runs its XLA paths here (its kernels are held against the
port's plain versions in tests/test_torch_train_kernels.py); both sides are
fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.datasets import DataLoader as JDataLoader
from paddlemix_tpu.datasets import pack_samples as jpack_samples
from paddlemix_tpu.datasets import pad_collate as jpad_collate
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.optimization import SCHEDULES as JSCHEDULES
from paddlemix_tpu.optimization import create_optimizer as jcreate_optimizer
from paddlemix_tpu.peft import LoraConfig as JLoraConfig
from paddlemix_tpu.peft import lora_init as jlora_init
from paddlemix_tpu.peft import lora_loss_fn as jlora_loss_fn
from paddlemix_tpu.tools.supervised_finetune import default_lm_loss as jdefault_lm_loss
from paddlemix_tpu.trainer import Trainer as JTrainer
from paddlemix_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict, lora_from_flax
from paddlemix_tpu_torch.datasets import DataLoader, MixTokenMapDataset, pack_samples, pad_collate
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, PagedKVCache
from paddlemix_tpu_torch.models.llama.llama7b import expected_launches_train, llama2_7b_config
from paddlemix_tpu_torch.optimization import SCHEDULES, create_optimizer
from paddlemix_tpu_torch.peft import LoraConfig, lora_init, lora_params
from paddlemix_tpu_torch.tools.supervised_finetune import build_trainer
from paddlemix_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.torch_port

# tools/tpu_train_smoke.py's model
TINY = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=512)
# the recipe of configs/llava/lora_sft_7b.json at this size: 3 optimizer steps of
# 2 rows x 2 micro-batches, a warmup of one step (the first update's rate is 0)
SFT = dict(max_length=256, mixtoken=True, per_device_train_batch_size=2,
           gradient_accumulation_steps=2, learning_rate=2e-3, lr_scheduler_type="cosine",
           warmup_steps=1, max_steps=6, save_steps=0, logging_steps=1, bf16=False, lora=True,
           lora_rank=8, lora_alpha=16, seed=0, data_parallel_degree=1)


def _samples(seed, n, lo, hi, vocab):
    """Tokenized samples of lo..hi tokens, the first third of each labelled -100."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rs.randint(lo, hi + 1)
        ids = rs.randint(3, vocab, length).tolist()
        out.append({"input_ids": ids, "labels": [-100] * (length // 3) + ids[length // 3:]})
    return out


# ------------------------------------------------------------------ data
def test_packing_collate_and_loader_order_equal_jax():
    samples = _samples(0, 40, 5, 90, 500)
    rows, jrows = pack_samples(samples, 128), jpack_samples(samples, 128)
    assert len(rows) == len(jrows) > 10
    for r, jr in zip(rows, jrows):
        assert r.keys() == jr.keys()
        for k in r:
            np.testing.assert_array_equal(r[k], jr[k])
    loader = DataLoader(MixTokenMapDataset(samples, 128), 3, collate_fn=pad_collate, shuffle=True,
                        seed=5)
    jloader = JDataLoader(jrows, 3, collate_fn=jpad_collate, shuffle=True, seed=5)
    assert len(loader) == len(jloader)
    for _ in range(2):  # two epochs: the shuffle is seed + epoch
        for b, jb in zip(loader, jloader):
            assert b.keys() == jb.keys()
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])
    # ragged rows: padded to a multiple of 64 with each field's fill
    ragged = pad_collate([{"input_ids": [5, 6], "labels": [5, 6], "positions": [0, 1],
                           "segment_ids": [1, 1]}, {"input_ids": [7], "labels": [-100],
                                                    "positions": [0], "segment_ids": [1]}])
    jragged = jpad_collate([{"input_ids": [5, 6], "labels": [5, 6], "positions": [0, 1],
                             "segment_ids": [1, 1]}, {"input_ids": [7], "labels": [-100],
                                                      "positions": [0], "segment_ids": [1]}])
    for k in jragged:
        np.testing.assert_array_equal(ragged[k], jragged[k])


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_equal_optax(kind):
    args = (3e-4, 40, 7) if kind != "constant" else (3e-4, 7)
    port, ref = SCHEDULES[kind](*args), JSCHEDULES[kind](*args)
    for count in range(0, 45):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, atol=0)
    # optax refuses a cosine decay of no steps: more warmup than total steps
    with pytest.raises(ValueError, match="decay_steps"):
        SCHEDULES["cosine"](2e-4, 32, 100)
    with pytest.raises(ValueError, match="decay_steps"):
        JSCHEDULES["cosine"](2e-4, 32, 100)


@pytest.mark.parametrize("every_k,weight_decay", [(1, 0.0), (2, 0.0), (1, 0.05)],
                         ids=["adamw", "multisteps2", "decay-masked"])
def test_clip_adamw_and_accumulation_equal_optax_over_5_updates(every_k, weight_decay):
    rs = np.random.RandomState(every_k)
    params = {"w": rs.randn(16, 8).astype(np.float32), "v": rs.randn(8, 4).astype(np.float32),
              "norm": rs.randn(8).astype(np.float32)}
    kw = dict(learning_rate=1e-2, schedule="cosine", total_steps=12, warmup_steps=2,
              weight_decay=weight_decay, max_grad_norm=1.0)
    jtx = jcreate_optimizer(**kw)
    if every_k > 1:
        jtx = optax.MultiSteps(jtx, every_k)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tx = create_optimizer(**kw, every_k=every_k)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tparams)
    for step in range(5 * every_k):
        # large enough that some calls clip (norm above 1) and some do not
        scale = 0.05 if step % 3 else 3.0
        grads = {k: (rs.randn(*v.shape) * scale).astype(np.float32) for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.update({k: torch.from_numpy(g) for k, g in grads.items()}, state, tparams)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} at call {step}")
    assert state["count"] == 5
    assert not np.allclose(tparams["w"].numpy(), params["w"])


# ------------------------------------------------------------------ LoRA
def test_lora_targets_layout_and_merge():
    cfg = dict(TINY, num_hidden_layers=1)
    jmodel = JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(cfg), seed=3)
    jlcfg = JLoraConfig(r=4, lora_alpha=8)
    jlora = jlora_init(jmodel.params, jlcfg, jax.random.PRNGKey(1))
    rs = np.random.RandomState(2)  # b non-zero, so that the merge shows
    jlora = {p: {"a": ab["a"], "b": jnp.asarray(rs.randn(*ab["b"].shape).astype(np.float32))}
             for p, ab in jlora.items()}
    model = LlamaForCausalLM(LlamaConfig(**cfg))
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    factors = lora_init(model, LoraConfig(r=4, lora_alpha=8), torch.Generator().manual_seed(0))
    # the seven projections of the layer, as the JAX regex picks them
    assert len(factors) == 2 * len(jlora) == 14
    assert lora_from_flax(jlora, model, LLAMA_KEY_MAP) == 7
    from paddlemix_tpu.peft.lora import merge_params

    merged = flatten_params(merge_params(jmodel.params, jlora, jlcfg))
    got = model.model.layers[0].mlp.down_proj.weight  # through the parametrization
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(merged["layers_0.mlp.down_proj.kernel"]).T,
                               rtol=1e-6, atol=1e-6)
    names = list(lora_params(model))
    assert names[:2] == ["model.layers.0.self_attn.q_proj.lora_a",
                         "model.layers.0.self_attn.q_proj.lora_b"]


# --------------------------------------------------------- the whole slice
@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's SFT after its model load (tools/supervised_finetune.py
    `main`): pack, load, LoRA on a frozen base, Trainer with MultiSteps.
    Returns (model, dataset, initial factors, per-step (loss, grad_norm),
    final factors)."""
    jmodel = JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=0)
    samples = _samples(1, 24, 40, 180, 512)
    rows = jpack_samples(samples, SFT["max_length"])
    loader = JDataLoader(rows, SFT["per_device_train_batch_size"], collate_fn=jpad_collate,
                         shuffle=True, seed=SFT["seed"])
    lcfg = JLoraConfig(r=SFT["lora_rank"], lora_alpha=SFT["lora_alpha"])
    lora0 = jlora_init(jmodel.params, lcfg, jax.random.PRNGKey(SFT["seed"]))
    args = JTrainingArguments.from_dict({k: v for k, v in SFT.items()
                                         if k in JTrainingArguments.__dataclass_fields__})
    seen = []
    trainer = JTrainer(params=lora0, args=args,
                       loss_fn=jlora_loss_fn(jdefault_lm_loss(jmodel), jmodel.params, lcfg),
                       train_dataloader=loader,
                       callbacks=[lambda step, metrics: seen.append(
                           (float(metrics["loss"]), float(metrics["grad_norm"])))])
    trainer.train()
    final = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    return jmodel, samples, lora0, seen, final


@pytest.mark.parametrize("recompute", [False, True], ids=["no-recompute", "recompute"])
def test_lora_sft_slice_matches_jax_trainer(jax_run, recompute):
    jmodel, samples, lora0, jsteps, jfinal = jax_run
    assert len(jsteps) == SFT["max_steps"]
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    trainer, lcfg = build_trainer(model, samples, dict(SFT, recompute=recompute))
    assert model.config.gradient_checkpointing == recompute
    assert lora_from_flax(lora0, model, LLAMA_KEY_MAP) == 14
    result = trainer.train()
    assert result["final_step"] == SFT["max_steps"] and trainer.state.opt_state["count"] == 3
    steps = [(float(h["loss"]), float(h["grad_norm"])) for h in trainer.history]
    # fp32 on both sides; the port's attention is the plain flash path (base-2
    # softmax), JAX's the XLA math: they differ by rounding, ~1e-6 of the loss
    np.testing.assert_allclose(np.asarray(steps), np.asarray(jsteps), rtol=2e-5, atol=0)
    # Adam divides each gradient by its own rms, so where a gradient element
    # is near 0 the two sides' rounding moves a share of a whole step (lr):
    # the bulk agrees to ~1e-7 (|a| ~ 0.01, a step of b 2e-3), a few elements
    # (19 of 131,072 above 2e-6 on this CPU) to within 5% of a step
    moved, errs = 0, []
    for path, ab in jfinal.items():
        name = "model." + ".".join(path[:-1]).replace("layers_", "layers.")
        for kind, port_kind in (("a", "lora_a"), ("b", "lora_b")):
            got = trainer.state.params[f"{name}.{port_kind}"].detach().numpy().T
            errs.append(np.abs(got - ab[kind]).ravel())
            moved += not np.allclose(ab[kind], np.asarray(lora0[path][kind]), rtol=0, atol=1e-7)
    errs = np.concatenate(errs)
    assert errs.max() <= 0.05 * SFT["learning_rate"] and np.quantile(errs, 0.999) <= 1e-6 \
        and errs.mean() <= 1e-7, (errs.max(), np.quantile(errs, 0.999), errs.mean())
    assert moved == 2 * len(jfinal)  # every factor moved: b at update 2, a at update 3
    # the base stayed frozen
    base = flatten_params(jmodel.params)
    np.testing.assert_array_equal(
        model.model.layers[1].self_attn.q_proj.parametrizations.weight.original.detach().numpy(),
        np.asarray(base["layers_1.self_attn.q_proj.kernel"]).T)


def test_jax_sft_loss_feeds_packed_positions_to_llava_as_pixel_values():
    """A fault of the reference, at a tiny size: `default_lm_loss` calls
    `model.module.apply(params, input_ids, positions, ...)`, and
    `LlavaModule.__call__` takes pixel_values second, so a packed batch's
    positions reach the vision tower. The port trains the Llama, whose
    second argument is positions."""
    from paddlemix_tpu.models.llava import LlavaConfig as JLlavaConfig
    from paddlemix_tpu.models.llava import LlavaForConditionalGeneration as JLlava
    from paddlemix_tpu.models.llava.modeling import LlavaModule

    tiny = dict(vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                   num_attention_heads=2, image_size=28, patch_size=14),
                text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                                 num_hidden_layers=1, num_attention_heads=2,
                                 max_position_embeddings=64), image_token_index=63)
    jllava = JLlava.from_config(JLlavaConfig.from_dict(tiny), seed=0)
    rows = pad_collate(pack_samples(_samples(2, 3, 5, 9, 60), 32))
    batch = {k: jnp.asarray(v) for k, v in rows.items()}
    seen = []
    encode = LlavaModule.encode_images

    def spy(self, pixel_values):
        seen.append(pixel_values)
        return encode(self, pixel_values)

    LlavaModule.encode_images = spy
    try:
        with pytest.raises(Exception):  # int positions are no NHWC image
            jdefault_lm_loss(jllava)(jllava.params, batch, None)
    finally:
        LlavaModule.encode_images = encode
    np.testing.assert_array_equal(np.asarray(seen[0]), rows["positions"])


# ----------------------------------------------------------- launch walk
@pytest.mark.parametrize("recompute", [False, True])
def test_expected_launches_train_walks_the_modules(recompute):
    """The kernels a micro-batch runs at full width, counted on the meta
    device: every RMSNorm forward, a backward for all but layer 0's input
    norm (frozen embeddings, nothing to differentiate), one lse forward and
    one dkv + dq backward a layer; recompute runs each layer's forward twice."""
    with torch.device("meta"):
        model = LlamaForCausalLM(llama2_7b_config())
    model.config.gradient_checkpointing = recompute
    want = expected_launches_train(model, micro_batches=8)
    layers = 32
    assert want == {
        "rms_norm": 8 * (2 * layers + 1 + (2 * layers if recompute else 0)),
        "rms_norm_backward": 8 * (2 * layers + 1 - 1),
        "flash_fwd_lse": 8 * layers * (2 if recompute else 1),
        "flash_bwd_dkv": 8 * layers, "flash_bwd_dq": 8 * layers, "flash_attention": 0,
        "decode_attention": 0, "decode_attention_int8": 0, "paged_decode_attention": 0,
        "wint8_matmul": 0}


# ------------------------------------------------------------------ C.3
def test_paged_cache_refuses_a_step_past_its_pool():
    """A direct forward (no paged_greedy_generate to size the pool) that
    needs one block more than the pool holds: the id it would take is the
    parking block's, which the card would write without complaint."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                      num_attention_heads=2, max_position_embeddings=64)
    model = LlamaForCausalLM(cfg).eval()
    cache = PagedKVCache.create(cfg, 2, num_blocks=3, block_size=8, max_blocks_per_seq=4,
                                dtype=torch.float32, device="cpu")
    ids = torch.randint(3, 64, (2, 12))
    with torch.inference_mode(), pytest.raises(ValueError, match="pool has 3"):
        model(ids, torch.arange(12).expand(2, 12), cache=cache)  # 2 + 2 blocks
    assert (cache.block_tables < 0).all() and int(cache.num_allocated) == 0
    with torch.inference_mode():  # what fits is taken: 1 + 1 blocks, then 1 more
        model(ids[:, :8], torch.arange(8).expand(2, 8), cache=cache)
        model(ids[:, :4], torch.tensor([[8, 9, 10, 11], [-1, -1, -1, -1]]), cache=cache)
    assert int(cache.num_allocated) == 3
