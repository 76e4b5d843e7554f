"""EVA ViT and EVA-CLIP in the port (models.clip.eva, ops.rope's vision
rope, core.convert's EVA maps, core.modeling's `from_pretrained`), held
against the JAX package on the CPU: the rope tables exactly; the EVA tower at
tests/test_eva_clip.py's tiny VCFG in its default form and in the postnorm,
layer-scale, mean-pooling, non-SwiGLU and rope-free forms; EVACLIP's
features, logit scale and loss; a torch-keyed checkpoint through the key
map; and a directory written by the JAX package's `save_pretrained`.

The JAX parameters (flax init, then seeded numpy noise on every leaf, so that
norms and biases are not 1 / 0) reach the port through
`flax_to_torch_state_dict`. fp32 throughout: the two sides differ by
summation order (flax's LayerNorm takes the variance as E[x^2] - E[x]^2, the
port's B10 plain version two-pass), well inside atol 1e-5, rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from paddlemix_tpu.models.clip import EVACLIP as JEVACLIP
from paddlemix_tpu.models.clip import EVACLIPConfig as JEVACLIPConfig
from paddlemix_tpu.models.clip import EVAVisionConfig as JEVAVisionConfig
from paddlemix_tpu.models.clip import EVAVisionTransformer as JEVAVisionTransformer
from paddlemix_tpu.models.clip import vision_rope_2d as jvision_rope_2d
from paddlemix_tpu.models.clip.eva import apply_vision_rope as japply_vision_rope
from paddlemix_tpu_torch.core import (
    EVA_CLIP_KEY_MAP,
    EVA_VISION_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
)
from paddlemix_tpu_torch.models.clip import EVACLIP, EVACLIPConfig, EVAVisionConfig
from paddlemix_tpu_torch.models.clip import EVAVisionTransformer
from paddlemix_tpu_torch.models.clip.eva02_b16 import EVA02_B16, expected_launches_eva_clip
from paddlemix_tpu_torch.models.layers import n_layer_norms
from paddlemix_tpu_torch.ops.rope import apply_vision_rope, vision_rope_2d

pytestmark = pytest.mark.torch_port

VCFG = dict(image_size=32, patch_size=8, width=64, layers=2, head_width=16,
            mlp_ratio=2.0, output_dim=24, pt_hw_seq_len=4, intp_freq=True)
TCFG = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16, eos_token_id=99,
            hidden_act="gelu")
ATOL, RTOL = 1e-5, 1e-4
VARIANTS = {
    "default": {},
    "postnorm": dict(postnorm=True),
    "init_values": dict(init_values=0.1),
    "mean_pooling": dict(use_mean_pooling=True),
    "mlp": dict(naiveswiglu=False),
    "no_rope": dict(rope=False),
}


def _noisy(params, seed):
    """Every leaf of a flax tree plus seeded normal noise (std 0.1): norms
    and biases away from 1 / 0, so that their mapping is checked."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    return traverse_util.unflatten_dict(
        {k: np.asarray(v, np.float32) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
         for k, v in flat.items()})


def _pixels(batch, size, seed):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def _ids(batch, seed):
    """Start id, random ids, the eos (99) at a random position, padding 0."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((batch, TCFG["max_position_embeddings"]), np.int32)
    for row, n in zip(ids, rng.integers(2, 14, batch)):
        row[0] = 98
        row[1:n + 1] = rng.integers(1, 98, n)
        row[n + 1] = 99
    return ids


def test_vision_rope_tables_and_rotation_match_jax():
    for grid, hd, pt, intp in [(4, 16, 4, True), (14, 64, 16, True), (16, 64, 16, False)]:
        jc, js = jvision_rope_2d(grid, hd, pt, intp)
        tc, ts = vision_rope_2d(grid, hd, pt, intp)
        assert tc.dtype == ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = np.random.default_rng(0).standard_normal((2, 16, 3, 16)).astype(np.float32)
    c, s = vision_rope_2d(4, 16, 4)
    out = apply_vision_rope(torch.from_numpy(x), c, s)
    ref = japply_vision_rope(jnp.asarray(x), jnp.asarray(c.numpy()), jnp.asarray(s.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    # bf16 in, bf16 out (the rotation in fp32)
    assert apply_vision_rope(torch.from_numpy(x).bfloat16(), c, s).dtype == torch.bfloat16


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eva_tower_matches_jax(variant):
    cfg = dict(VCFG, **VARIANTS[variant])
    jmodel = JEVAVisionTransformer.from_config(JEVAVisionConfig(**cfg), seed=0)
    params = _noisy(jmodel.params, 1)
    model = EVAVisionTransformer(EVAVisionConfig(**cfg))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(params), model,
                                                   EVA_VISION_KEY_MAP))
    px = _pixels(3, cfg["image_size"], 2)
    ref = np.asarray(jmodel.module.apply({"params": params}, jnp.asarray(px)))
    with torch.no_grad():
        out = model(torch.from_numpy(px))
        feats = model(torch.from_numpy(px), return_all_features=True)
    assert out.shape == ref.shape == (3, cfg["output_dim"])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    jfeats = jmodel.module.apply({"params": params}, jnp.asarray(px), return_all_features=True)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL, rtol=RTOL)
    # every LayerNorm is a FusedLayerNorm (B10): 4 a block with sub-LN, 2 without
    per_block = 2 + (2 if cfg.get("naiveswiglu", True) else 1)
    assert n_layer_norms(model) == cfg["layers"] * per_block + 1


@pytest.fixture(scope="module")
def eva_clip_pair():
    jcfg = JEVACLIPConfig(vision_cfg=dict(VCFG), text_cfg=dict(TCFG), embed_dim=24)
    jmodel = JEVACLIP.from_config(jcfg, seed=0)
    params = _noisy(jmodel.params, 3)
    jmodel.params = params
    model = EVACLIP(EVACLIPConfig(vision_cfg=dict(VCFG), text_cfg=dict(TCFG), embed_dim=24))
    model.load_state_dict(flax_to_torch_state_dict(flatten_flax(params), model,
                                                   EVA_CLIP_KEY_MAP))
    return jmodel, model.eval()


def test_eva_clip_features_scale_and_loss_match_jax(eva_clip_pair):
    jmodel, model = eva_clip_pair
    px, ids = _pixels(4, 32, 4), _ids(4, 5)
    ref = jmodel(jnp.asarray(px), jnp.asarray(ids))
    with torch.no_grad():
        out = model(torch.from_numpy(px), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "logit_scale", "loss"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    with torch.no_grad():
        np.testing.assert_allclose(model.encode_image(torch.from_numpy(px)).numpy(),
                                   np.asarray(jmodel.encode_image(jnp.asarray(px))),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(model.encode_text(torch.from_numpy(ids).long()).numpy(),
                                   np.asarray(jmodel.encode_text(jnp.asarray(ids))),
                                   atol=ATOL, rtol=RTOL)


def _torch_keyed(model):
    """The port's state dict under EVA's torch checkpoint names (the port's
    own: `visual.blocks.N.attn.q_proj.weight`, ...), as numpy."""
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def test_torch_keyed_checkpoint_loads_through_the_key_map(eva_clip_pair, tmp_path):
    from safetensors.numpy import save_file

    jmodel, model = eva_clip_pair
    jmodel.config.save_pretrained(str(tmp_path))
    save_file(_torch_keyed(model), str(tmp_path / "model.safetensors"))
    loaded = EVACLIP.from_pretrained(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # the same through pytorch_model.bin, and the tower alone: EVA's `visual.`
    # prefix is dropped by the vision map
    tower = {k[len("visual."):]: torch.from_numpy(v) for k, v in _torch_keyed(model).items()
             if k.startswith("visual.")}
    from paddlemix_tpu_torch.core.modeling import convert_torch_state_dict

    flat = convert_torch_state_dict({"visual." + k: v.numpy() for k, v in tower.items()},
                                    EVA_VISION_KEY_MAP)
    vis = EVAVisionTransformer(model.visual.config)
    vis.load_state_dict(flax_to_torch_state_dict(flat, vis, EVA_VISION_KEY_MAP))
    px = torch.from_numpy(_pixels(2, 32, 6))
    with torch.no_grad():
        assert torch.equal(vis(px), model.visual(px))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    jmodel.config.save_pretrained(str(bin_dir))
    torch.save(model.state_dict(), str(bin_dir / "pytorch_model.bin"))
    loaded = EVACLIP.from_pretrained(str(bin_dir), device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())


def test_from_pretrained_reads_the_jax_save_pretrained(eva_clip_pair, tmp_path):
    jmodel, model = eva_clip_pair
    jmodel.save_pretrained(str(tmp_path))
    loaded = EVACLIP.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.config.vision.width == VCFG["width"]
    assert loaded.config.text.hidden_act == "gelu"
    px, ids = _pixels(2, 32, 7), _ids(2, 8)
    with torch.no_grad():
        a = loaded(torch.from_numpy(px), torch.from_numpy(ids).long())
        b = model(torch.from_numpy(px), torch.from_numpy(ids).long())
    for k in ("image_features", "text_features", "loss"):
        assert torch.equal(a[k], b[k]), k


def test_eva02_b16_widths_and_launch_walk():
    """The published configuration on the meta device: the widths, the
    SwiGLU hidden 2,048 (the B10 row of `ffn_ln`) and B10's launches."""
    with torch.device("meta"):
        model = EVACLIP(EVA02_B16)
    v, t = EVA02_B16.vision, EVA02_B16.text
    assert (v.image_size, v.patch_size, v.width, v.layers, v.num_heads, v.mlp_hidden) == \
        (224, 16, 768, 12, 12, 2048)
    assert (t.hidden_size, t.num_attention_heads, t.num_hidden_layers, t.intermediate_size,
            t.max_position_embeddings, t.vocab_size, t.hidden_act) == \
        (512, 8, 12, 2048, 77, 49408, "gelu")
    assert model.visual.blocks[0].mlp.ffn_ln.weight.shape == (2048,)
    assert model.visual.blocks[0].attn.k_proj.bias is None
    assert model.visual.blocks[0].attn.q_proj.bias is not None
    assert n_layer_norms(model.visual) == 12 * 4 + 1
    assert n_layer_norms(model.text_model) == 12 * 2 + 1
    assert expected_launches_eva_clip(model, 2, 3, 1) == {
        "layer_norm": 2 * 49 + 3 * 25, "layer_norm_backward": 74}
