"""CLIP zero-shot classification in the port (metrics.clip_zero_shot,
appflow's `zero_shot_classification` task, tools.clip_zero_shot), held
against the JAX package on the CPU: the template-averaged classifier and the
top-1 / top-5 accuracy over a tiny CLIP carried from JAX; the Appflow task
with a (model, processor) pair (an EVACLIP) and with a directory (a
CLIPModel, its processor config and tokenizer files, written by the JAX
package), its ranking and scores against JAX's (atol 1e-5, fp32).

The tokenizer is the byte-level CLIP tokenizer (no merges), which both
sides read from the same files. Weights and images come from numpy seeds.
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp
from paddlemix_tpu.appflow import Appflow as JAppflow
from paddlemix_tpu.metrics.clip_zero_shot import build_zero_shot_classifier as jbuild
from paddlemix_tpu.metrics.clip_zero_shot import zero_shot_accuracy as jaccuracy
from paddlemix_tpu.models.clip import CLIPConfig as JCLIPConfig
from paddlemix_tpu.models.clip import CLIPModel as JCLIPModel
from paddlemix_tpu.models.clip import EVACLIP as JEVACLIP
from paddlemix_tpu.models.clip import EVACLIPConfig as JEVACLIPConfig
from paddlemix_tpu.models.clip.tokenizer import CLIPTokenizer as JCLIPTokenizer
from paddlemix_tpu.processors import CLIPImageProcessor as JCLIPImageProcessor
from paddlemix_tpu.processors import CLIPProcessor as JCLIPProcessor
from paddlemix_tpu_torch.appflow import Appflow
from paddlemix_tpu_torch.core import (
    CLIP_KEY_MAP,
    EVA_CLIP_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from paddlemix_tpu_torch.metrics import build_zero_shot_classifier, zero_shot_accuracy
from paddlemix_tpu_torch.models.clip import CLIPConfig, CLIPModel, EVACLIP, EVACLIPConfig
from paddlemix_tpu_torch.models.clip.tokenizer import byte_level_tokenizer
from paddlemix_tpu_torch.processors import CLIPImageProcessor, CLIPProcessor
from paddlemix_tpu_torch.tools import clip_zero_shot

pytestmark = pytest.mark.torch_port

TOK = byte_level_tokenizer(model_max_length=32)
VOCAB, EOS = TOK.vocab_size, TOK.eos_token_id
TEXT = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32, eos_token_id=EOS)
CLIP_TINY = dict(vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                    num_attention_heads=4, image_size=32, patch_size=16),
                 text_config=TEXT, projection_dim=16)
EVA_TINY = dict(vision_cfg=dict(image_size=32, patch_size=8, width=32, layers=2, head_width=16,
                                mlp_ratio=2.0, pt_hw_seq_len=4),
                text_cfg=dict(TEXT, hidden_act="gelu"), embed_dim=16)
CLASSES = [f"class {chr(97 + i % 26)}{i}" for i in range(70)]  # two batches of 64
ATOL = 1e-5


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: np.asarray(v, np.float32) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
         for k, v in flat.items()})


@pytest.fixture(scope="module")
def clip_pair():
    jmodel = JCLIPModel.from_config(JCLIPConfig(**CLIP_TINY), seed=0)
    jmodel.params = _noisy(jmodel.params, 1)
    model = CLIPModel(CLIPConfig(**CLIP_TINY))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(jmodel.params), model,
                                                   CLIP_KEY_MAP))
    return jmodel, model.eval()


@pytest.fixture(scope="module")
def eva_pair():
    jmodel = JEVACLIP.from_config(JEVACLIPConfig(**EVA_TINY), seed=0)
    jmodel.params = _noisy(jmodel.params, 2)
    model = EVACLIP(EVACLIPConfig(**EVA_TINY))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(jmodel.params), model,
                                                   EVA_CLIP_KEY_MAP))
    return jmodel, model.eval()


def test_classifier_and_accuracy_match_jax(clip_pair):
    jmodel, model = clip_pair
    classifier = build_zero_shot_classifier(model.encode_text, TOK, CLASSES, device="cpu")
    jclassifier = jbuild(jax.jit(jmodel.encode_text), TOK, CLASSES)
    assert classifier.shape == (len(CLASSES), 16)
    np.testing.assert_allclose(classifier.numpy(), np.asarray(jclassifier), atol=ATOL, rtol=1e-4)
    torch.testing.assert_close(classifier.norm(dim=-1), torch.ones(len(CLASSES)))
    rng = np.random.default_rng(3)
    px = rng.standard_normal((12, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        feats = model.encode_image(torch.from_numpy(px))
    jfeats = jmodel.encode_image(jnp.asarray(px))
    # labels: half the images' own best class, half random: a top-1 and a top-5 short of 1
    logits = (feats / feats.norm(dim=-1, keepdim=True)) @ classifier.T
    labels = np.where(np.arange(12) % 2 == 0, logits.argmax(-1).numpy(),
                      rng.integers(0, len(CLASSES), 12))
    out = zero_shot_accuracy(feats, classifier, torch.from_numpy(labels))
    ref = jaccuracy(jfeats, jclassifier, jnp.asarray(labels))
    # the same hits: the shares differ at most by fp32 rounding of the mean
    assert set(out) == set(ref) == {"top1", "top5"}
    assert all(abs(out[k] - ref[k]) <= 1e-6 for k in out), (out, ref)
    assert 0.5 <= out["top1"] <= out["top5"] <= 1


def _image(seed, h=45, w=60):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same_ranking(result, ref):
    assert [r["label"] for r in result] == [r["label"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in result], [r["score"] for r in ref],
                               atol=ATOL, rtol=0)


def test_appflow_with_a_model_and_processor_pair_matches_jax(eva_pair):
    jmodel, model = eva_pair
    labels = ["cat", "dog", "a bird", "car", "tree"]
    ip = dict(size=32, crop_size=32)
    app = Appflow(app="zero_shot_classification",
                  models=[(model, CLIPProcessor(CLIPImageProcessor(**ip), TOK))])
    japp = JAppflow(app="zero_shot_classification",
                    models=[(jmodel, JCLIPProcessor(JCLIPImageProcessor(**ip), TOK))])
    for seed in (5, 6):
        out = app(image=_image(seed), candidate_labels=labels)["result"]
        _same_ranking(out, japp(image=_image(seed), candidate_labels=labels)["result"])
        assert sorted(r["label"] for r in out) == sorted(labels)


def test_appflow_from_a_directory_matches_jax(clip_pair, tmp_path, capsys):
    jmodel, _ = clip_pair
    jmodel.save_pretrained(str(tmp_path))
    JCLIPImageProcessor(size=32, crop_size=32).save_pretrained(str(tmp_path))
    TOK.save_pretrained(str(tmp_path))
    labels = ["red", "green", "blue", "yellow"]
    out = Appflow(app="zero_shot_classification", models=[str(tmp_path)],
                  device="cpu")(image=_image(7), candidate_labels=labels)["result"]
    ref = JAppflow(app="zero_shot_classification",
                   models=[str(tmp_path)])(image=_image(7), candidate_labels=labels)["result"]
    assert JCLIPTokenizer.from_pretrained(str(tmp_path)).vocab_size == VOCAB
    _same_ranking(out, ref)
    # the example's entry point, on a jpeg-free image file
    from PIL import Image

    Image.fromarray(_image(7)).save(tmp_path / "im.png")
    result = clip_zero_shot.main([str(tmp_path), str(tmp_path / "im.png"), *labels],
                                 device="cpu")["result"]
    _same_ranking(result, ref)
    assert capsys.readouterr().out.splitlines()[0].startswith(f"{ref[0]['label']}: ")
    with pytest.raises(ValueError, match="unknown app"):
        Appflow(app="openset_det_sam")
