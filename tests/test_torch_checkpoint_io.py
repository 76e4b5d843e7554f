"""The port's weights IO against the JAX package and the `safetensors`
library, on the CPU: `core/safetensors.py` (every dtype, bf16 bit for bit,
byte-equal files, the refusals), `from_pretrained` of a JAX-written directory
with the `safetensors` package unimportable (the card's machine has none),
`save_pretrained` (flat and sharded, the shards and index JAX's own) read by
JAX and JAX's read by the port's `AutoModel`, the torch -> flax conversion as
the exact inverse of flax -> torch, and the `AutoModel` registry.

Tiny Llama: 2 layers, width 64, fp32 unless a case says bf16. Logits agree
to 2e-5 (fp32; the port's attention is the plain flash path, JAX's the XLA
math: they differ by rounding, ~3e-6 here); weights agree bit for bit.
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddlemix_tpu.core.modeling import flatten_params
from paddlemix_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddlemix_tpu.models.llama import LlamaForCausalLM as JLlamaForCausalLM
from paddlemix_tpu_torch.auto import AutoConfig, AutoModel
from paddlemix_tpu_torch.core import (
    LLAMA_KEY_MAP,
    UNET_KEY_MAP,
    flax_to_torch_state_dict,
    lora_from_flax,
    lora_to_flax,
    torch_to_flax_state_dict,
)
from paddlemix_tpu_torch.core import safetensors as st
from paddlemix_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddlemix_tpu_torch.peft import LoraConfig, lora_init

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
LOGITS_TOL = 2e-5


def _every_dtype(seed=0):
    """One tensor of every dtype the format takes, a 0-d one, an empty one
    and a transposed view (which must be written row-major)."""
    g = torch.Generator().manual_seed(seed)
    return {"f32": torch.randn(3, 5, generator=g), "f64": torch.randn(4, generator=g).double(),
            "bf16": torch.randn(7, 3, generator=g).bfloat16(),
            "f16": torch.randn(2, 2, 3, generator=g).half(),
            "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
            "u8": torch.randint(0, 256, (3, 3), generator=g, dtype=torch.uint8),
            "i16": torch.randint(-999, 999, (5,), generator=g, dtype=torch.int16),
            "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 3), generator=g, dtype=torch.int32),
            "i64": torch.tensor([2 ** 40, -3]), "bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
            "view_T": torch.randn(4, 6, generator=g).T}


def _bits(t):
    t = t.contiguous().reshape(-1)
    return t.view(torch.uint8) if t.numel() else t


# one metadata key: the library writes its metadata map in a hash map's
# order, which varies from run to run once there are two keys
@pytest.mark.parametrize("metadata", [None, {"format": "pt"}], ids=["no-metadata", "metadata"])
def test_port_safetensors_and_the_library_read_each_other(tmp_path, metadata):
    from safetensors.torch import load_file as lib_load
    from safetensors.torch import save_file as lib_save

    tensors = _every_dtype()
    port_file, lib_file = str(tmp_path / "port.safetensors"), str(tmp_path / "lib.safetensors")
    st.save_file(tensors, port_file, metadata=metadata)
    lib_save({k: v.contiguous() for k, v in tensors.items()}, lib_file, metadata=metadata)
    # the same bytes: header order, padding, offsets
    assert open(port_file, "rb").read() == open(lib_file, "rb").read()
    for got in (lib_load(port_file), st.load_file(lib_file)):
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(_bits(got[k]), _bits(t)), k  # bit for bit, bf16 included
    header, meta, start = st.read_header(port_file)
    assert meta == (metadata or {}) and start % 8 == 0


def test_port_safetensors_maps_copy_on_write(tmp_path):
    path = str(tmp_path / "w.safetensors")
    st.save_file({"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}, path)
    w = st.load_file(path)["w"]
    w.add_(1)  # writable, and the file keeps its bytes
    assert torch.equal(st.load_file(path)["w"], torch.arange(12.0).reshape(3, 4))


def _header_file(path, header, data):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("fault,match", [
    ("truncated", "truncated"), ("overlap", "overlaps"), ("dtype", "unknown dtype"),
    ("gap", "gap"), ("size", "takes"), ("short header", "truncated")])
def test_port_safetensors_refuses_bad_files(tmp_path, fault, match):
    path = str(tmp_path / "bad.safetensors")
    if fault == "truncated":
        st.save_file({"w": torch.ones(16)}, path)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4)
    elif fault == "overlap":
        _header_file(path, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                            "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
                     bytes(12))
    elif fault == "dtype":
        _header_file(path, {"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}},
                     bytes(2))
    elif fault == "gap":
        _header_file(path, {"a": {"dtype": "F32", "shape": [1], "data_offsets": [4, 8]}},
                     bytes(8))
    elif fault == "size":
        _header_file(path, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
                     bytes(8))
    else:
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(ValueError, match=match):
        st.load_file(path)


# ------------------------------------------------------------- models and JAX
@pytest.fixture(scope="module")
def jax_llama():
    return JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=0)


def _ids():
    return np.random.RandomState(0).randint(0, TINY["vocab_size"], (2, 16))


def _logits_jax(jmodel):
    return np.asarray(jmodel(jnp.asarray(_ids()))[0])


def _logits_port(model):
    with torch.no_grad():
        return model(torch.as_tensor(_ids()))[0].float().numpy()


def test_from_pretrained_reads_a_jax_directory_without_the_safetensors_package(
        tmp_path, monkeypatch, jax_llama):
    """The card's machine has no `safetensors`. The loader of the parent
    tree called `from safetensors import safe_open` for every safetensors
    file, which raises there; the port's own reader needs nothing."""
    jax_llama.save_pretrained(str(tmp_path))  # the JAX package writes with the library
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        from safetensors import safe_open  # noqa: F401  (what the parent's loader ran)
    model = LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    np.testing.assert_allclose(_logits_port(model), _logits_jax(jax_llama), rtol=0,
                               atol=LOGITS_TOL)
    imported = [m for m in sys.modules if m.startswith("paddlemix_tpu_torch")]
    assert not any(getattr(sys.modules[m], "safe_open", None) for m in imported)


@pytest.mark.parametrize("shard_bytes", [None, 40_000], ids=["one-file", "sharded"])
def test_save_pretrained_round_trips_with_jax(tmp_path, jax_llama, shard_bytes):
    kw = {} if shard_bytes is None else {"max_shard_bytes": shard_bytes}
    jax_llama.save_pretrained(str(tmp_path / "jax"), **kw)
    model = AutoModel.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert isinstance(model, LlamaForCausalLM)
    np.testing.assert_allclose(_logits_port(model), _logits_jax(jax_llama), rtol=0,
                               atol=LOGITS_TOL)
    written = model.save_pretrained(str(tmp_path / "port"), **kw)
    back = JLlamaForCausalLM.from_pretrained(str(tmp_path / "port"))
    np.testing.assert_allclose(_logits_jax(back), _logits_port(model), rtol=0, atol=LOGITS_TOL)
    # the same files as JAX's: the shards split alike, byte for byte
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in written:
        assert open(tmp_path / "port" / name, "rb").read() == \
            open(tmp_path / "jax" / name, "rb").read(), name
    if shard_bytes:
        assert len(written) > 2
        index = "model.safetensors.index.json"
        assert json.load(open(tmp_path / "port" / index)) == \
            json.load(open(tmp_path / "jax" / index))
    cfg = AutoConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.num_hidden_layers == 2 and type(cfg).model_type == "llama"


def test_bf16_weights_go_out_and_back_bit_for_bit(tmp_path, jax_llama):
    """bf16 is written as its 16 bits (no fp32 on the way: the file is
    JAX's bf16 file), and read back into bf16 parameters, the RMSNorm scales
    in fp32."""
    jbf16 = JLlamaForCausalLM.from_config(JLlamaConfig.from_dict(TINY), seed=0,
                                          dtype=jnp.bfloat16)
    jbf16.save_pretrained(str(tmp_path / "jax"))
    model = LlamaForCausalLM.from_pretrained(str(tmp_path / "jax"), device="cpu",
                                             dtype=torch.bfloat16)
    assert model.lm_head.weight.dtype == torch.bfloat16
    assert model.model.norm.weight.dtype == torch.float32
    model.save_pretrained(str(tmp_path / "port"))
    ours = st.load_file(str(tmp_path / "port" / "model.safetensors"))
    theirs = st.load_file(str(tmp_path / "jax" / "model.safetensors"))
    for k, t in theirs.items():
        # norm scales: bf16 in JAX's file, fp32 (the same values) in the port's
        assert torch.equal(ours[k].to(t.dtype), t) and ours[k].dtype in (t.dtype, torch.float32)
    size = os.path.getsize(tmp_path / "port" / "model.safetensors")
    assert size < 1.01 * os.path.getsize(tmp_path / "jax" / "model.safetensors")


def test_torch_to_flax_is_the_exact_inverse_of_flax_to_torch(jax_llama):
    """Every Llama tensor, a LoRA-parametrized model's base weights (not the
    merged ones), a conv kernel (HWIO <-> OIHW) and the LoRA factors."""
    model = LlamaForCausalLM(LlamaConfig(**TINY))
    flat = flatten_params(jax_llama.params)
    model.load_state_dict(flax_to_torch_state_dict(flat, model, LLAMA_KEY_MAP))
    lora = lora_init(model, LoraConfig(r=4, lora_alpha=8), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in lora.values():
            p.normal_()
    back = torch_to_flax_state_dict(model, LLAMA_KEY_MAP)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), err_msg=k)
    factors = lora_to_flax(model, LLAMA_KEY_MAP)
    assert len(factors) == 14 and factors[("layers_0", "mlp", "down_proj", "kernel")]["a"].shape \
        == (TINY["intermediate_size"], 4)
    before = {k: v.clone() for k, v in lora.items()}
    assert lora_from_flax({p: {k: t.clone() for k, t in ab.items()} for p, ab in factors.items()},
                          model, LLAMA_KEY_MAP) == 14
    for k, v in lora.items():
        assert torch.equal(v, before[k])
    conv = torch.nn.Sequential(torch.nn.Conv2d(3, 5, 3), torch.nn.Conv2d(5, 2, 1))
    cflat = torch_to_flax_state_dict(conv, UNET_KEY_MAP)
    assert cflat["0.kernel"].shape == (3, 3, 3, 5)
    state = flax_to_torch_state_dict({k: v.numpy() for k, v in cflat.items()}, conv, UNET_KEY_MAP)
    for k, v in conv.state_dict().items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("model_type,cls", [
    ("llama", "LlamaForCausalLM"), ("llava", "LlavaForConditionalGeneration"),
    ("clip", "CLIPModel"), ("evaclip", "EVACLIP"), ("opt", "OPTForCausalLM"),
    ("blip-2", "Blip2ForConditionalGeneration"), ("blip2", "Blip2ForConditionalGeneration")])
def test_auto_registry_maps_the_ported_families(model_type, cls):
    from paddlemix_tpu.auto import _MODEL_REGISTRY as JAX_REGISTRY
    from paddlemix_tpu_torch.auto import _MODEL_REGISTRY, _load

    entry = _MODEL_REGISTRY[model_type]
    assert _load(entry, 2).__name__ == cls
    config_class = _load(entry, 1)
    assert config_class.model_type == model_type or model_type == "blip2"
    if model_type in JAX_REGISTRY:  # the JAX package's classes of the same names
        assert JAX_REGISTRY[model_type][1:] == entry[1:]


def test_auto_model_refuses_an_unported_model_type(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen2_vl"}))
    with pytest.raises(NotImplementedError, match="qwen2_vl"):
        AutoModel.from_pretrained(str(tmp_path), device="cpu")
