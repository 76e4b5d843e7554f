"""ROADMAP C.23: packed (B, S) positions given to Qwen2-VL as its M-RoPE
`position_ids`. JAX's `mrope_cos_sin` indexes the (3, B, S) streams and
raises IndexError on such an array; the port's refuses every shape but
(3, B, S) with ValueError (before the repair it rotated every row by the
first three rows' positions). Shown on the model's forward at batches 8 and
3 (two segments a row, as MixToken packs them), on `mrope_cos_sin` itself,
and through both packages' `supervised_finetune.main` on a tiny Qwen2-VL
checkpoint under `mixtoken: true` (ROADMAP C.24: JAX's cannot train it
there, and the port now refuses it too). fp32 on the CPU."""

import json

import numpy as np
import pytest
import torch

from paddlemix_tpu.models.qwen2_vl import Qwen2VLConfig as JConfig
from paddlemix_tpu.models.qwen2_vl import Qwen2VLForConditionalGeneration as JQwen2VL
from paddlemix_tpu.tools.supervised_finetune import main as jmain
from paddlemix_tpu_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLForConditionalGeneration
from paddlemix_tpu_torch.ops.rope import mrope_cos_sin
from paddlemix_tpu_torch.tools.supervised_finetune import main

pytestmark = pytest.mark.torch_port

# tests/test_torch_qwen2_vl.py's tiny model
TINY = dict(
    vision_config=dict(depth=2, embed_dim=32, num_heads=2, patch_size=4,
                       spatial_merge_size=2, temporal_patch_size=2, hidden_size=48,
                       mlp_ratio=2.0),
    text_config=dict(vocab_size=160, hidden_size=48, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                     max_position_embeddings=128, eos_token_id=2),
    image_token_id=150, video_token_id=151, vision_start_token_id=149,
    mrope_section=(4, 4, 4),
)
S = 16


def _packed(b):
    """ids (b, 16) and the packed positions (b, 16): two segments a row, of
    7 and 9 tokens, each counted from 0."""
    ids = np.random.RandomState(b).randint(3, 140, (b, S))
    pos = np.concatenate([np.arange(7), np.arange(S - 7)])
    return ids, np.tile(pos, (b, 1))


@pytest.mark.parametrize("b", [8, 3])
def test_fault23_packed_positions_are_refused(b):
    ids, pos = _packed(b)
    model = Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_dict(TINY)).eval()
    with torch.no_grad(), pytest.raises(ValueError, match=r"\(3, B, S\)"):
        model(torch.from_numpy(ids), torch.from_numpy(pos))
    jmodel = JQwen2VL.from_config(JConfig.from_dict(TINY), seed=0)
    with pytest.raises(IndexError):
        jmodel.module.apply({"params": jmodel.params}, ids.astype(np.int32),
                            pos.astype(np.int32))
    # the three equal streams the packed positions stand for are taken
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids), torch.from_numpy(np.stack([pos] * 3)))
    assert logits.shape == (b, S, 160) and torch.isfinite(logits).all()


@pytest.mark.parametrize("shape", [(8, S), (3, S), (2, 4, S), (4, 3, S), (3, 2, S, 1)])
def test_mrope_refuses_every_shape_but_3_b_s(shape):
    with pytest.raises(ValueError, match="must be"):
        mrope_cos_sin(torch.zeros(shape, dtype=torch.long), 24, (4, 4, 4))
    cos, sin = mrope_cos_sin(torch.zeros((3, 2, S), dtype=torch.long), 24, (4, 4, 4))
    assert cos.shape == sin.shape == (2, S, 24)


def test_fault23_sft_main_under_mixtoken_raises_as_jax_does(tmp_path):
    model = Qwen2VLForConditionalGeneration(Qwen2VLConfig.from_dict(TINY))
    model.save_pretrained(str(tmp_path / "model"))
    rng = np.random.RandomState(0)
    with open(tmp_path / "data.jsonl", "w") as f:
        for _ in range(16):
            ids = rng.randint(3, 140, rng.randint(6, 14)).tolist()
            f.write(json.dumps({"input_ids": ids, "labels": ids}) + "\n")
    cfg = dict(model_name_or_path=str(tmp_path / "model"), dataset_path=str(tmp_path / "data.jsonl"),
               max_length=32, mixtoken=True, per_device_train_batch_size=2, max_steps=2,
               logging_steps=1, save_steps=0, bf16=False, data_parallel_degree=1)
    (tmp_path / "j.json").write_text(json.dumps(dict(cfg, output_dir=str(tmp_path / "jax"))))
    (tmp_path / "p.json").write_text(json.dumps(dict(cfg, output_dir=str(tmp_path / "port"),
                                                     device="cpu")))
    with pytest.raises(IndexError):
        jmain(str(tmp_path / "j.json"))
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        main(str(tmp_path / "p.json"))
