"""`Trainer.evaluate` / `predict` / best tracking, `supervised_finetune.main`
end to end and the port's CLI, held against the JAX package on the CPU:
the same tiny Llama (2 layers, width 64, fp32) written by JAX's
`save_pretrained`, the same jsonl data, the same batches.

JAX's `main` and the port's make the same full fine-tune (no random LoRA
init on either side), so their saved models agree to PARAMS_TOL; a LoRA run
draws its factors from each side's own generator, so there JAX's `load_lora`
reads the port's adapter and its shapes and keys are held equal to JAX's
`lora_init`'s. Eval losses agree to 1e-5 (relative), merged weights of
`merge-lora` to 1e-6 (the two sides sum the rank-4 product in another
order).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu import cli as jcli
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.models.llava import llava_loss as jllava_loss
from paddlemix_tpu.peft import LoraConfig as JLoraConfig
from paddlemix_tpu.peft import load_lora as jload_lora
from paddlemix_tpu.peft import lora_init as jlora_init
from paddlemix_tpu.peft import save_lora as jsave_lora
from paddlemix_tpu.tools.supervised_finetune import main as jmain
from paddlemix_tpu.trainer import Trainer as JTrainer
from paddlemix_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlemix_tpu_torch import cli
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.core import safetensors as st
from paddlemix_tpu_torch.core.modeling import load_flat_state
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlemix_tpu_torch.models.llava import LlavaConfig, LlavaForConditionalGeneration
from paddlemix_tpu_torch.models.llava import llava_loss
from paddlemix_tpu_torch.tools.supervised_finetune import main
from paddlemix_tpu_torch.trainer import Trainer, TrainingArguments

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
PARAMS_TOL = 2e-6
EVAL_RTOL = 1e-5


@pytest.fixture(scope="module")
def jmodel():
    return JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=0)


def port_model(jmodel):
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    return model


def make_batch(bs=4, seq=8, seed=0):
    ids = np.random.RandomState(seed).randint(1, 64, (bs, seq)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


# ------------------------------------------------------------ evaluate
def test_evaluate_and_best_tracking_match_jax(tmp_path, jmodel):
    """do_eval every 2 steps of 4: the eval losses, the best step, its
    checkpoint, and the final eval in the result (test_input_pipeline.py's
    test_evaluate_and_best_tracking)."""
    train = [make_batch(seed=i) for i in range(4)]
    evald = [make_batch(bs=8, seed=10 + i) for i in range(2)]
    kw = dict(max_steps=4, logging_steps=2, save_steps=0, warmup_steps=1, learning_rate=1e-2,
              do_eval=True, eval_steps=2, data_parallel_degree=1)
    seen = {"jax": [], "port": []}
    jt = JTrainer(model=jmodel, args=JTrainingArguments(output_dir=str(tmp_path / "jax"), **kw),
                  loss_fn=lambda p, b, r: jllava_loss(jmodel.module.apply({"params": p},
                                                                          b["input_ids"])[0],
                                                      b["labels"]),
                  train_dataloader=train, eval_dataloader=evald,
                  callbacks=[lambda step, metrics: seen["jax"].append(dict(metrics))])
    jres = jt.train()
    model = port_model(jmodel)
    t = Trainer(model=model, args=TrainingArguments(output_dir=str(tmp_path / "port"), **kw),
                loss_fn=lambda p, b, r: llava_loss(model(b["input_ids"])[0], b["labels"]),
                train_dataloader=train, eval_dataloader=evald,
                callbacks=[lambda step, metrics: seen["port"].append(dict(metrics))])
    res = t.train()
    assert np.isfinite(res["eval_loss"])
    np.testing.assert_allclose(res["eval_loss"], jres["eval_loss"], rtol=EVAL_RTOL)
    ev = [m["eval_loss"] for m in seen["port"] if "eval_loss" in m]
    jev = [m["eval_loss"] for m in seen["jax"] if "eval_loss" in m]
    assert len(ev) == len(jev) == 3  # steps 2 and 4, and the final eval
    np.testing.assert_allclose(ev, jev, rtol=EVAL_RTOL)
    assert t.best_step == jt.best_step and t.best_step in (2, 4)
    np.testing.assert_allclose(t.best_metric, jt.best_metric, rtol=EVAL_RTOL)
    assert os.listdir(tmp_path / "port" / "checkpoints") == [str(t.best_step)] if \
        t.best_step == 2 else sorted(os.listdir(tmp_path / "port" / "checkpoints")) == ["2", "4"]


def test_evaluate_with_eval_fn_compute_metrics_and_predict_match_jax(jmodel):
    """eval_fn returning arrays and compute_metrics over them (the corpus
    metrics path), and predict (test_input_pipeline.py's
    test_evaluate_with_custom_eval_fn_and_corpus_metrics)."""
    evald = [make_batch(bs=8, seed=20 + i) for i in range(2)]

    def jeval_fn(params, batch):
        logits, _ = jmodel.module.apply({"params": params}, batch["input_ids"])
        return {"loss": jllava_loss(logits, batch["labels"]), "pred": jnp.argmax(logits, -1),
                "label": batch["labels"]}

    model = port_model(jmodel)

    def eval_fn(params, batch):
        logits = model(batch["input_ids"])[0]
        return {"loss": llava_loss(logits, batch["labels"]), "pred": logits.argmax(-1),
                "label": batch["labels"]}

    def compute_metrics(outs):
        return {"acc": float((outs["pred"][:, :-1] == outs["label"][:, 1:]).mean())}

    jm = JTrainer(model=jmodel, eval_dataloader=evald, eval_fn=jeval_fn,
                  compute_metrics=compute_metrics).evaluate()
    t = Trainer(model=model, eval_dataloader=evald, eval_fn=eval_fn,
                compute_metrics=compute_metrics)
    m = t.evaluate()
    assert m.keys() == jm.keys() == {"eval_loss", "eval_acc"}
    np.testing.assert_allclose(m["eval_loss"], jm["eval_loss"], rtol=EVAL_RTOL)
    assert m["eval_acc"] == jm["eval_acc"]
    preds = t.predict(evald, lambda p, b: {"pred": model(b["input_ids"])[0].argmax(-1)})
    jpreds = JTrainer(model=jmodel).predict(
        evald, lambda p, b: {"pred": jnp.argmax(jmodel.module.apply({"params": p},
                                                                    b["input_ids"])[0], -1)})
    for a, b in zip(preds, jpreds):
        np.testing.assert_array_equal(a["pred"], b["pred"])


# ------------------------------------------------------------ main
def _write_jsonl(path, seed, n):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.randint(3, 64, rng.randint(6, 20)).tolist()
            f.write(json.dumps({"input_ids": ids, "labels": ids}) + "\n")


@pytest.fixture(scope="module")
def sft_dir(jmodel, tmp_path_factory):
    """JAX's save_pretrained of the tiny model, and a train and an eval set
    (test_sft_cli.py's _setup, at width 64)."""
    d = tmp_path_factory.mktemp("sft")
    jmodel.save_pretrained(str(d / "model"))
    _write_jsonl(d / "data.jsonl", 0, 48)
    _write_jsonl(d / "eval.jsonl", 1, 16)
    return d


def _cfg(d, out, **kw):
    return dict(dict(model_name_or_path=str(d / "model"), dataset_path=str(d / "data.jsonl"),
                     max_length=32, per_device_train_batch_size=2, learning_rate=1e-3,
                     max_steps=6, logging_steps=1, save_steps=0, bf16=False,
                     output_dir=str(out), warmup_steps=1, data_parallel_degree=1), **kw)


def _write_cfg(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def test_sft_main_full_finetune_matches_jax_main(tmp_path, sft_dir):
    """main on a JAX-written directory, full fine-tuning: the saved model
    `output_dir/final` (read by JAX) against JAX main's; with eval over the
    held-out set, a checkpoint inside an accumulation window and
    save_total_limit 1."""
    base = _cfg(sft_dir, tmp_path / "jax", gradient_accumulation_steps=2)
    jres = jmain(_write_cfg(tmp_path / "j.json", base))
    port_cfg = dict(base, output_dir=str(tmp_path / "port"), device="cpu", save_steps=3,
                    save_total_limit=1, do_eval=True, eval_steps=4,
                    eval_dataset_path=str(sft_dir / "eval.jsonl"))
    res = main(_write_cfg(tmp_path / "p.json", port_cfg))
    assert res["final_step"] == jres["final_step"] == 6
    np.testing.assert_allclose(res["loss"], jres["loss"], rtol=1e-5)
    assert np.isfinite(res["eval_loss"])
    # steps 3 and 6 saved, the eval's best at 4 too: one left
    assert len(os.listdir(tmp_path / "port" / "checkpoints")) == 1
    ours = load_flat_state(str(tmp_path / "port" / "final"))
    theirs = load_flat_state(str(tmp_path / "jax" / "final"))
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (ours[k] - v).abs().max().item() <= PARAMS_TOL, k
    JLlamaForCausalLM.from_pretrained(str(tmp_path / "port" / "final"))  # JAX reads it


def test_sft_main_lora_adapter_is_read_by_jax_and_resumes(tmp_path, sft_dir, jmodel):
    cfg = _cfg(sft_dir, tmp_path / "out", device="cpu", lora=True, lora_r=4, lora_alpha=8,
               max_steps=4, save_steps=3, gradient_accumulation_steps=2)
    res = main(_write_cfg(tmp_path / "c.json", cfg))
    assert res["final_step"] == 4 and np.isfinite(res["loss"])
    jlora, jcfg = jload_lora(str(tmp_path / "out" / "lora"))
    want = jlora_init(jmodel.params, JLoraConfig(r=4, lora_alpha=8), jax.random.PRNGKey(0))
    assert jlora.keys() == want.keys() and (jcfg.r, jcfg.lora_alpha) == (4, 8)
    for p, ab in want.items():
        assert jlora[p]["a"].shape == ab["a"].shape and jlora[p]["b"].shape == ab["b"].shape
    assert any(float(jnp.abs(ab["b"]).max()) > 0 for ab in jlora.values())  # trained
    # resume from the checkpoint of step 3 and train on to 6
    res2 = main(_write_cfg(tmp_path / "c2.json", dict(
        cfg, max_steps=6, resume_from_checkpoint=str(tmp_path / "out" / "checkpoints" / "3"))))
    assert res2["final_step"] == 6


def test_sft_main_trains_a_llava_checkpoints_language_model(tmp_path, caplog):
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                  num_attention_heads=2, image_size=28, patch_size=14)
    llava = LlavaForConditionalGeneration(LlavaConfig(vision_config=vision,
                                                      text_config=dict(TINY),
                                                      image_token_index=63))
    llava.save_pretrained(str(tmp_path / "llava"))
    _write_jsonl(tmp_path / "data.jsonl", 0, 24)
    cfg = dict(_cfg(tmp_path, tmp_path / "out", device="cpu", lora=True, lora_r=4, max_steps=2),
               model_name_or_path=str(tmp_path / "llava"))
    caplog.set_level("INFO")
    main(_write_cfg(tmp_path / "c.json", cfg))
    assert "LLaVA checkpoint: training its language model" in caplog.text
    keys = st.load_file(str(tmp_path / "out" / "lora" / "adapter_model.safetensors"))
    assert "layers_0.self_attn.q_proj.kernel.lora_a" in keys and len(keys) == 28


# ------------------------------------------------------------ the CLI
def test_cli_merge_lora_equals_jax(tmp_path, sft_dir, jmodel):
    rs = np.random.RandomState(3)
    jcfg = JLoraConfig(r=4, lora_alpha=8)
    lora = jlora_init(jmodel.params, jcfg, jax.random.PRNGKey(1))
    lora = {p: {"a": ab["a"], "b": jnp.asarray(rs.randn(*ab["b"].shape).astype(np.float32))}
            for p, ab in lora.items()}
    jsave_lora(lora, jcfg, str(tmp_path / "lora"))
    model_dir = str(sft_dir / "model")
    assert jcli.main(["merge-lora", model_dir, str(tmp_path / "lora"), str(tmp_path / "jax"),
                      "--model-class", "paddlemix_tpu.models.llama.LlamaForCausalLM"]) == 0
    assert cli.main(["merge-lora", model_dir, str(tmp_path / "lora"), str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    ours = load_flat_state(str(tmp_path / "port"))
    theirs = load_flat_state(str(tmp_path / "jax"))
    base = load_flat_state(model_dir)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and (ours[k] - v).abs().max().item() <= 1e-6, k
    assert not torch.equal(ours["layers_0.self_attn.q_proj.kernel"],
                           base["layers_0.self_attn.q_proj.kernel"])


def test_cli_fp16_safetensors_and_env_match_jax(tmp_path, sft_dir, capsys):
    src = str(sft_dir / "model")
    for dtype in ("fp16", "bf16"):
        assert jcli.main(["fp16-safetensors", src, "--dtype", dtype,
                          "--output", str(tmp_path / f"jax_{dtype}")]) == 0
        assert cli.main(["fp16-safetensors", src, "--dtype", dtype,
                         "--output", str(tmp_path / f"port_{dtype}")]) == 0
        a = open(tmp_path / f"port_{dtype}" / "model.safetensors", "rb").read()
        b = open(tmp_path / f"jax_{dtype}" / "model.safetensors", "rb").read()
        assert a == b, dtype
    assert cli.main(["env"]) == 0
    assert "torch" in capsys.readouterr().out
