"""Layer decay in the port (optimization `layer_id_for_param`,
`layer_decay_scales`, `create_optimizer(layer_decay=...)`, the Trainer's
hookup), held against the JAX package on the CPU: every parameter's scale
equals JAX's at its flax path (through the model's key map) for CLIPModel
and EVACLIP; three optimizer steps of EVA-CLIP's recipe (cosine, weight
decay 0.05, layer decay 0.75, clip 1.0) from the same parameters and
gradients equal optax's chain within 1e-6 relative, JAX's weight-decay mask
included (`flax_weight_decay_mask`); the Trainer takes its layer count from
the model's config as JAX's does.

Parameters and gradients come from numpy seeds in the flax layout and reach
the port through `flax_to_torch_state_dict`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
from paddlemix_tpu.models.clip import CLIPConfig as JCLIPConfig
from paddlemix_tpu.models.clip import CLIPModel as JCLIPModel
from paddlemix_tpu.models.clip import EVACLIP as JEVACLIP
from paddlemix_tpu.models.clip import EVACLIPConfig as JEVACLIPConfig
from paddlemix_tpu.optimization import create_optimizer as jcreate_optimizer
from paddlemix_tpu.optimization import layer_decay_scales as jlayer_decay_scales
from paddlemix_tpu.optimization import layer_id_for_param as jlayer_id_for_param
from paddlemix_tpu.optimization import no_weight_decay_mask as jno_weight_decay_mask
from paddlemix_tpu_torch.core import (
    CLIP_KEY_MAP,
    EVA_CLIP_KEY_MAP,
    flatten_flax,
    flax_to_torch_state_dict,
    torch_key_to_flax,
)
from paddlemix_tpu_torch.models.clip import CLIPConfig, CLIPModel, EVACLIP, EVACLIPConfig
from paddlemix_tpu_torch.models.clip.eva02_b16 import EVA02_B16
from paddlemix_tpu_torch.models.clip.vitb16 import VITB16
from paddlemix_tpu_torch.optimization import (
    create_optimizer,
    flax_weight_decay_mask,
    layer_decay_scales,
    layer_id_for_param,
)
from paddlemix_tpu_torch.trainer import Trainer, TrainingArguments

pytestmark = pytest.mark.torch_port

TEXT = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, max_position_embeddings=8, eos_token_id=63)
EVA_TINY = dict(vision_cfg=dict(image_size=32, patch_size=8, width=32, layers=3, head_width=16,
                                mlp_ratio=2.0, pt_hw_seq_len=4, init_values=0.1),
                text_cfg=dict(TEXT, hidden_act="gelu"), embed_dim=16)
MODELS = {
    "clip": (JCLIPModel, JCLIPConfig, CLIPModel, CLIPConfig, CLIP_KEY_MAP, VITB16.to_dict()),
    "eva_clip": (JEVACLIP, JEVACLIPConfig, EVACLIP, EVACLIPConfig, EVA_CLIP_KEY_MAP,
                 EVA02_B16.to_dict()),
}


def _strip(d):
    return {k: v for k, v in d.items() if k not in ("model_type", "_class_name")}


@pytest.mark.parametrize("name", list(MODELS))
def test_every_scale_equals_jax_at_its_flax_path(name):
    """At the published widths (shapes only: eval_shape on the JAX side, the
    meta device on the port's), layer decay 0.75 over 12 blocks."""
    jcls, jcfg_cls, cls, cfg_cls, key_map, cfg = MODELS[name]
    jscales = flatten_flax(jlayer_decay_scales(jcls(jcfg_cls(**_strip(cfg))).params_shape(),
                                               0.75, 12))
    with torch.device("meta"):
        model = cls(cfg_cls(**_strip(cfg)))
    params = dict(model.named_parameters())
    scales = layer_decay_scales(params, 0.75, 12)
    assert len(scales) == len(jscales)
    ids = set()
    for tname in params:
        fkey = torch_key_to_flax(tname, key_map)
        assert scales[tname] == jscales[fkey], (tname, fkey)
        tid = layer_id_for_param(tname, 14)
        assert tid == jlayer_id_for_param(fkey.replace(".", "/"), 14), (tname, fkey)
        ids.add(tid)
    assert ids == set(range(14))  # the embeddings, 12 blocks, the head


def _flax_params(jmodel, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_flax(jmodel.params_shape()).items()}


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def test_three_layer_decayed_steps_equal_optax():
    jmodel = JEVACLIP(JEVACLIPConfig(**EVA_TINY))
    flat = _flax_params(jmodel, 0)
    model = EVACLIP(EVACLIPConfig(**EVA_TINY))
    tparams = {k: v.clone() for k, v in flax_to_torch_state_dict(flat, model,
                                                                  EVA_CLIP_KEY_MAP).items()}
    kw = dict(learning_rate=1e-2, schedule="cosine", total_steps=10, warmup_steps=2,
              weight_decay=0.05, max_grad_norm=1.0, layer_decay=0.75, num_layers=3)
    jparams = _unflatten(flat)
    jtx = jcreate_optimizer(params=jparams, **kw)
    jstate = jtx.init(jparams)
    tx = create_optimizer(params=tparams, flax_key_map=EVA_CLIP_KEY_MAP, **kw)
    state = tx.init(tparams)
    # JAX's mask decides: EVA's pos_embed and patch embedding decay (their flax
    # names hold no "embedding"), norms, biases and the logit scale do not
    jmask = flatten_flax(jno_weight_decay_mask(jparams))
    mask = flax_weight_decay_mask(EVA_CLIP_KEY_MAP)
    for tname, p in tparams.items():
        assert mask(tname, p) == bool(jmask[torch_key_to_flax(tname, EVA_CLIP_KEY_MAP)]), tname
    assert mask("visual.pos_embed", tparams["visual.pos_embed"])
    rng = np.random.default_rng(1)
    for step in range(3):
        scale = 3.0 if step == 1 else 0.01  # one step clips, two do not
        gflat = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in flat.items()}
        upd, jstate = jtx.update(_unflatten(gflat), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.update(flax_to_torch_state_dict(gflat, model, EVA_CLIP_KEY_MAP), state, tparams)
    jflat = flatten_flax(jparams)
    want = flax_to_torch_state_dict({k: np.asarray(v) for k, v in jflat.items()}, model,
                                    EVA_CLIP_KEY_MAP)
    start = flax_to_torch_state_dict(flat, model, EVA_CLIP_KEY_MAP)
    for tname, p in tparams.items():
        err = float((p - want[tname]).norm() / want[tname].norm())
        assert err <= 1e-6, (tname, err)
        assert not torch.equal(p, start[tname]), tname
    # the steps differ by layer: the head moved more than the patch embedding
    moved = {n: float((tparams[n] - start[n]).abs().mean()) for n in
             ("visual.head.weight", "visual.patch_embed.proj.weight")}
    assert moved["visual.head.weight"] > moved["visual.patch_embed.proj.weight"]


def test_trainer_hooks_up_layer_decay():
    model = EVACLIP(EVACLIPConfig(**EVA_TINY))
    args = TrainingArguments(learning_rate=5e-4, weight_decay=0.05, layer_decay=0.75,
                             warmup_steps=2, max_steps=10)
    trainer = Trainer(model=model, args=args, loss_fn=lambda *a: None).setup()
    params = dict(model.named_parameters())
    # EVACLIPConfig has no num_hidden_layers / num_layers: 12, as in JAX
    assert trainer.tx.layer_scales == layer_decay_scales(params, 0.75, 12)
    assert trainer.tx.decay_mask("visual.pos_embed", params["visual.pos_embed"])
    plain = Trainer(model=model, args=TrainingArguments(), loss_fn=lambda *a: None).setup()
    assert plain.tx.layer_scales is None
    with pytest.raises(ValueError, match="needs params and num_layers"):
        create_optimizer(layer_decay=0.75)
