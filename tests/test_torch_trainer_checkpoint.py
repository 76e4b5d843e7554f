"""The Trainer's durable half in the port (checkpoints and resume, the
preemption save, callbacks, EMA, LoRA adapters), held against the JAX
package's `Trainer` (orbax checkpoints), `ema_update`, `save_lora` /
`load_lora` / `merge_params` on the CPU.

Tiny Llama: 2 layers, width 64, fp32 on both sides, the same weights
(carried from JAX by `flax_to_torch_state_dict`) and the same batches. The
JAX Trainer runs with `data_parallel_degree=1` (the suite's 8-device CPU
would build a mesh). Trained parameters agree to PARAMS_TOL (the two sides'
attention rounds differently, ~1e-6 of the loss, and Adam's division by each
gradient's own rms carries a share of that into a step); a restored state
equals the saved one bit for bit; logits agree to 2e-5.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu.models.llava import llava_loss as jllava_loss
from paddlemix_tpu.peft import LoraConfig as JLoraConfig
from paddlemix_tpu.peft import load_lora as jload_lora
from paddlemix_tpu.peft import lora_init as jlora_init
from paddlemix_tpu.peft import merge_params as jmerge_params
from paddlemix_tpu.peft import save_lora as jsave_lora
from paddlemix_tpu.trainer import Trainer as JTrainer
from paddlemix_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlemix_tpu.trainer import ema_init as jema_init
from paddlemix_tpu.trainer import ema_update as jema_update
from paddlemix_tpu_torch.core import LLAMA_KEY_MAP, flax_to_torch_state_dict
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlemix_tpu_torch.models.llava import llava_loss
from paddlemix_tpu_torch.peft import (
    LoraConfig,
    load_lora,
    lora_init,
    merge_lora_into_model,
    save_lora,
)
from paddlemix_tpu_torch.trainer import (
    BenchmarkCallback,
    ProfilerCallback,
    TensorBoardCallback,
    Trainer,
    TrainingArguments,
    ema_init,
    ema_update,
    parse_profiler_options,
    train_state_dict,
)

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
PARAMS_TOL = 2e-6
LOGITS_TOL = 2e-5


def make_batch(bs=4, seq=8, seed=0):
    ids = np.random.RandomState(seed).randint(1, 64, (bs, seq)).astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def jax_loss(jmodel):
    def loss_fn(params, batch, rng):
        logits, _ = jmodel.module.apply({"params": params}, batch["input_ids"])
        return jllava_loss(logits, batch["labels"])
    return loss_fn


def port_loss(model):
    def loss_fn(params, batch, rng):
        return llava_loss(model(batch["input_ids"])[0], batch["labels"])
    return loss_fn


@pytest.fixture(scope="module")
def jmodel():
    return JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=0)


def port_model(jmodel):
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    model.load_state_dict(flax_to_torch_state_dict(flatten_params(jmodel.params), model,
                                                   LLAMA_KEY_MAP))
    return model


def _args(cls, out, **kw):
    base = dict(output_dir=str(out), learning_rate=1e-3, logging_steps=1, warmup_steps=1,
                num_train_epochs=10, data_parallel_degree=1)
    return cls(**dict(base, **kw))


def _close_to_jax(model, jparams, tol=PARAMS_TOL):
    ref = flax_to_torch_state_dict(flatten_params(jax.device_get(jparams)), model, LLAMA_KEY_MAP)
    errs = {k: (v - ref[k]).abs().max().item() for k, v in model.state_dict().items()}
    assert max(errs.values()) <= tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


# --------------------------------------------------------------- resume
@pytest.mark.parametrize("accum,save_at,resume_to", [(1, 5, 7), (2, 3, 6)],
                         ids=["save-resume-continue", "mid-accumulation"])
def test_train_save_resume_and_continue_match_the_jax_trainer(tmp_path, jmodel, accum, save_at,
                                                              resume_to):
    """Train to `save_at` (saving there), resume from "latest" in a new
    Trainer and train to `resume_to`, as JAX's test_trainer_loop_and_resume;
    with accumulation 2 the checkpoint falls inside a window (micro-step 3),
    whose accumulator and mini-step must come back."""
    data = [make_batch(seed=i) for i in range(6)]
    kw = dict(max_steps=save_at, save_steps=save_at, gradient_accumulation_steps=accum)
    jt = JTrainer(model=jmodel, args=_args(JTrainingArguments, tmp_path / "jax", **kw),
                  loss_fn=jax_loss(jmodel), train_dataloader=data)
    assert jt.train()["final_step"] == save_at
    jt2 = JTrainer(model=jmodel, args=_args(JTrainingArguments, tmp_path / "jax",
                                            **dict(kw, max_steps=resume_to)),
                   loss_fn=jax_loss(jmodel), train_dataloader=data)
    jt2.setup()
    jt2.load_checkpoint("latest")
    assert int(jt2.state.step) == save_at
    jmini = int(getattr(jt2.state.opt_state, "mini_step", 0))
    assert jt2.train(max_steps=resume_to)["final_step"] == resume_to

    model = port_model(jmodel)
    t = Trainer(model=model, args=_args(TrainingArguments, tmp_path / "port", **kw),
                loss_fn=port_loss(model), train_dataloader=data)
    assert t.train()["final_step"] == save_at
    saved = {k: v.clone() for k, v in train_state_dict(t.state, t.tx).items()}
    _close_to_jax(model, jt.state.params)
    assert os.listdir(tmp_path / "port" / "checkpoints") == [str(save_at)]

    model2 = port_model(jmodel)  # fresh weights: all of them must come from the checkpoint
    t2 = Trainer(model=model2, args=_args(TrainingArguments, tmp_path / "port",
                                          **dict(kw, max_steps=resume_to,
                                                 resume_from_checkpoint="latest")),
                 loss_fn=port_loss(model2), train_dataloader=data)
    t2.setup()
    assert t2.state.step == save_at
    restored = train_state_dict(t2.state, t2.tx)
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k  # bit for bit: params, moments, counters
    if accum > 1:
        assert t2.state.opt_state["mini_step"] == save_at % accum == 1
        assert jmini == 1
        assert any(bool(a.abs().max() > 0) for a in t2.state.opt_state["acc"].values())
    assert t2.train(max_steps=resume_to)["final_step"] == resume_to
    _close_to_jax(model2, jt2.state.params)


@pytest.fixture(scope="module")
def jax_rotation(jmodel, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_rotation")
    jt = JTrainer(model=jmodel, args=_args(JTrainingArguments, out, max_steps=4, save_steps=1,
                                           save_total_limit=2),
                  loss_fn=jax_loss(jmodel), train_dataloader=[make_batch(seed=i)
                                                              for i in range(4)])
    jt.train()
    return sorted(os.listdir(out / "checkpoints"))


@pytest.mark.parametrize("load_from", ["latest", "directory", "step"])
def test_save_total_limit_and_every_load_form(tmp_path, jmodel, jax_rotation, load_from):
    model = port_model(jmodel)
    args = _args(TrainingArguments, tmp_path, max_steps=4, save_steps=1, save_total_limit=2)
    data = [make_batch(seed=i) for i in range(4)]
    t = Trainer(model=model, args=args, loss_fn=port_loss(model), train_dataloader=data)
    t.train()
    # orbax's max_to_keep: the newest two steps, as directories named by step
    assert sorted(os.listdir(tmp_path / "checkpoints")) == jax_rotation == ["3", "4"]
    final = {k: v.clone() for k, v in train_state_dict(t.state, t.tx).items()}
    model2 = port_model(jmodel)
    t2 = Trainer(model=model2, args=args, loss_fn=port_loss(model2), train_dataloader=data)
    ref = {"latest": "latest", "directory": str(tmp_path / "checkpoints" / "4") + "/",
           "step": "4"}[load_from]
    t2.load_checkpoint(ref)
    assert t2.state.step == 4
    for k, v in train_state_dict(t2.state, t2.tx).items():
        assert torch.equal(v, final[k]), k
    with pytest.raises(ValueError):
        t2.load_checkpoint(str(tmp_path))  # a directory whose leaf is no step


def test_latest_without_a_checkpoint_warns_and_keeps_the_state(tmp_path, jmodel, caplog):
    model = port_model(jmodel)
    t = Trainer(model=model, args=_args(TrainingArguments, tmp_path, max_steps=1),
                loss_fn=port_loss(model), train_dataloader=[make_batch()])
    t.setup()
    t.load_checkpoint("latest")
    assert t.state.step == 0 and "no checkpoint" in caplog.text


def test_preemption_by_sigterm_saves_and_stops(tmp_path, jmodel):
    """SIGTERM during training: the loop checkpoints at the next step
    boundary and stops, as JAX's test_preemption_checkpoint."""
    model = port_model(jmodel)
    args = _args(TrainingArguments, tmp_path, max_steps=50, save_steps=0)
    calls = []

    def hook(step, metrics):
        calls.append(step)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    t = Trainer(model=model, args=args, loss_fn=port_loss(model),
                train_dataloader=[make_batch(seed=i) for i in range(8)], callbacks=[hook])
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        t.install_preemption_handler()
        result = t.train()
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert result["final_step"] == 2 < 50
    assert os.listdir(tmp_path / "checkpoints") == ["2"]
    model2 = port_model(jmodel)
    t2 = Trainer(model=model2, args=args, loss_fn=port_loss(model2), train_dataloader=[])
    t2.load_checkpoint("latest")
    assert t2.state.step == 2
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------ EMA
@pytest.mark.parametrize("use_warmup", [True, False], ids=["warmup", "constant"])
def test_ema_matches_jax(use_warmup):
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(8, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
    state = ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    jstate = jema_init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(6):
        new = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        state = ema_update(state, {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.9,
                           use_warmup=use_warmup)
        jstate = jema_update(jstate, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.9,
                             use_warmup=use_warmup)
        for k in params:
            np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7)
    assert state.count == int(jstate.count) == 6


# ----------------------------------------------------------------- LoRA
def _ids():
    return np.random.RandomState(5).randint(1, 64, (2, 12))


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_lora_adapter_save_load_and_merge_against_jax(tmp_path, jmodel, direction):
    """The port's `save_lora` read by JAX's `load_lora` and merged by JAX's
    `merge_params`, against the port's `merge_lora_into_model`; and JAX's
    adapter read, attached and merged by the port."""
    rs = np.random.RandomState(1)
    model = port_model(jmodel)
    if direction == "port-to-jax":
        cfg = LoraConfig(r=4, lora_alpha=8)
        factors = lora_init(model, cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in factors.values():
                p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32) * 0.1))
        save_lora(factors, cfg, str(tmp_path))
        jlora, jcfg = jload_lora(str(tmp_path))
        assert jcfg.r == 4 and jcfg.lora_alpha == 8 and jcfg.target_modules.endswith(r"\.kernel$")
        assert len(jlora) == 14
        back, back_cfg = load_lora(str(tmp_path))
        assert back_cfg == cfg
        with torch.no_grad():
            attached = model(torch.as_tensor(_ids()))[0].numpy()
        merge_lora_into_model(model)
    else:
        jcfg = JLoraConfig(r=4, lora_alpha=8)
        jlora = jlora_init(jmodel.params, jcfg, jax.random.PRNGKey(0))
        jlora = {p: {"a": ab["a"], "b": jnp.asarray(rs.randn(*ab["b"].shape).astype(np.float32)
                                                      * 0.1)} for p, ab in jlora.items()}
        jsave_lora(jlora, jcfg, str(tmp_path))
        merge_lora_into_model(model, *load_lora(str(tmp_path)))
        attached = None
    assert not any(".parametrizations." in n for n, _ in model.named_parameters())
    with torch.no_grad():
        merged = model(torch.as_tensor(_ids()))[0].numpy()
    jlogits = np.asarray(jmodel.module.apply({"params": jmerge_params(jmodel.params, jlora,
                                                                      jcfg)},
                                             jnp.asarray(_ids()))[0])
    np.testing.assert_allclose(merged, jlogits, rtol=0, atol=LOGITS_TOL)
    if attached is not None:  # merging moves nothing: the attached model's logits
        np.testing.assert_allclose(merged, attached, rtol=0, atol=1e-5)
    assert not np.allclose(jlogits, _base_logits(jmodel), atol=1e-3)


def _base_logits(jmodel):
    return np.asarray(jmodel(jnp.asarray(_ids()))[0])


# ------------------------------------------------------------ callbacks
def test_callbacks_and_their_wiring(tmp_path, jmodel):
    from paddlemix_tpu.trainer import BenchmarkCallback as JBenchmarkCallback
    from paddlemix_tpu.trainer import parse_profiler_options as jparse

    cb, jcb = BenchmarkCallback(skip_steps=1, log_every=100), JBenchmarkCallback(1, 100)
    for s in range(1, 8):
        cb(step=s, metrics={"ips": 10.0 + s, "loss": 1.0})
        jcb(step=s, metrics={"ips": 10.0 + s, "loss": 1.0})
    assert cb.summary() == jcb.summary() and cb.summary()["steps"] == 6
    for spec in ("batch_range=[2,4];state=GPU", "batch_range=[3,9];profile_path=p", None):
        mine, theirs = parse_profiler_options(spec), jparse(spec)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert (mine.start_step, mine.end_step, mine.log_dir) == \
                (theirs.start_step, theirs.end_step, theirs.log_dir)
    model = port_model(jmodel)
    prof_dir = str(tmp_path / "prof")
    args = _args(TrainingArguments, tmp_path, max_steps=3, save_steps=0, benchmark=True,
                 report_to="tensorboard", profiler_options=f"batch_range=[1,2];"
                                                           f"profile_path={prof_dir}")
    t = Trainer(model=model, args=args, loss_fn=port_loss(model),
                train_dataloader=[make_batch(bs=2, seed=i) for i in range(4)])
    t.train()
    kinds = {type(c) for c in t.callbacks}
    assert kinds == {BenchmarkCallback, TensorBoardCallback, ProfilerCallback}
    next(c for c in t.callbacks if isinstance(c, TensorBoardCallback)).close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    assert os.path.getsize(os.path.join(prof_dir, "trace.json")) > 0


def test_tensorboard_without_tensorboardx_raises_naming_it(tmp_path, monkeypatch, jmodel):
    import sys

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    model = port_model(jmodel)
    t = Trainer(model=model, args=_args(TrainingArguments, tmp_path, max_steps=1,
                                        report_to="tensorboard"),
                loss_fn=port_loss(model), train_dataloader=[make_batch()])
    with pytest.raises(ImportError, match="tensorboardX"):
        t.setup()


def test_training_arguments_keep_jax_fields():
    port = {f.name: f.default for f in dataclasses.fields(TrainingArguments)}
    jax_ = {f.name: f.default for f in dataclasses.fields(JTrainingArguments)}
    assert port == jax_
