"""Loading and saving a pretrained model directory (port of
paddlemix_tpu/core/modeling.py `PretrainedModel.from_pretrained` and
`save_pretrained`).

A directory (or its `subfolder`, as a diffusers pipeline keeps `unet/`,
`vae/`, `text_encoder/`) holds `config.json` and the weights, in one of two
forms:
  - `model.safetensors` (or its sharded index) as the JAX package's
    `save_pretrained` writes it, in flax keys (`...q_proj.kernel`, (in, out)
    Dense kernels, HWIO convs);
  - a torch-keyed file as transformers and diffusers write it
    (`diffusion_pytorch_model.safetensors`, `model.safetensors`,
    `pytorch_model.bin`, `diffusion_pytorch_model.bin`, read in the JAX
    package's order), whose keys the model's key map renames to flax keys,
    transposing `.weight`s as the JAX package's `convert_torch_state_dict`
    does.
Either way the flax-keyed arrays then go into the model through
`load_flax_state_`, which refuses a key missing or of the wrong shape,
naming the keys: the JAX package's `strict=True`. (Its default,
`strict=False`, keeps the random init of a missing parameter with a
warning; the port never does.) Keys the model has no parameter for are
dropped with a warning where the caller says so (`drop_unexpected`), as the
JAX loader drops them, and refused otherwise. Safetensors files are read
and written by the port's own `core/safetensors.py` (no `safetensors`
package): mapped, in their own dtype (bf16 stays bf16), each tensor moved to
the card as it is laid out in the file and transposed there. `save_pretrained` writes what the JAX
package's writes: `config.json` and flax-keyed `model.safetensors`, or
above `max_shard_bytes` shards and their index, split as JAX splits them.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import safetensors
from .config import resolve_file
from .convert import KeyMap, load_flax_state_, torch_key_to_flax, torch_to_flax_state_dict

SAFETENSORS_NAME = "model.safetensors"
SAFETENSORS_INDEX_NAME = "model.safetensors.index.json"
TORCH_BIN_NAME = "pytorch_model.bin"
DIFFUSERS_SAFETENSORS_NAME = "diffusion_pytorch_model.safetensors"
DIFFUSERS_BIN_NAME = "diffusion_pytorch_model.bin"
MAX_SHARD_BYTES = 5 * 1024 ** 3

logger = logging.getLogger(__name__)

# The JAX package's markers, and OPT's learned positions: JAX transposes that
# (max_positions + 2, D) table as a Dense weight, then back by its shape at load
_EMBEDDING_MARKERS = ("embedding", "embed_tokens", ".wte.", ".wpe.", ".shared.",
                      "embed_positions")


def load_flat_state(path: str, subfolder: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The tensors of the weights file(s) in directory `path` (or its
    `subfolder`), by key, in their stored dtype (CPU tensors over the mapped
    safetensors files). The files are tried in the JAX package's order:
    `model.safetensors.index.json` and its shards, `model.safetensors`,
    `diffusion_pytorch_model.safetensors`, `pytorch_model.bin` (read by
    `torch.load(weights_only=True)`), `diffusion_pytorch_model.bin`."""
    index = resolve_file(path, SAFETENSORS_INDEX_NAME, subfolder, required=False)
    if index is not None:
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        flat: Dict[str, torch.Tensor] = {}
        for name in names:
            flat.update(safetensors.load_file(os.path.join(os.path.dirname(index), name)))
        return flat
    for name in (SAFETENSORS_NAME, DIFFUSERS_SAFETENSORS_NAME):
        st = resolve_file(path, name, subfolder, required=False)
        if st is not None:
            return safetensors.load_file(st)
    for name in (TORCH_BIN_NAME, DIFFUSERS_BIN_NAME):
        binary = resolve_file(path, name, subfolder, required=False)
        if binary is not None:
            return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights under {path!r} (subfolder={subfolder!r}): none of "
                            f"{SAFETENSORS_INDEX_NAME}, {SAFETENSORS_NAME}, "
                            f"{DIFFUSERS_SAFETENSORS_NAME}, {TORCH_BIN_NAME}, "
                            f"{DIFFUSERS_BIN_NAME}")


def _is_embedding_weight(key: str) -> bool:
    """An embedding table's `.weight`: the module that owns it is named as
    one (`token_embedding`, `embed_tokens`, `wte`, ...). Only the owner
    counts: `time_embedding.linear_2.weight` is a Linear's."""
    parts = key.split(".")
    owner = f".{parts[-2]}." if len(parts) > 1 else ""
    return any(m in owner for m in _EMBEDDING_MARKERS)


def convert_torch_state_dict(flat: Dict[str, object], key_map: KeyMap) -> Dict[str, object]:
    """torch keys and layouts -> flax ones (the JAX package's
    `convert_torch_state_dict`): a 2-D `.weight` that is no embedding table
    transposed to (in, out), a 3-D one OIW -> WIO, a 4-D one OIHW -> HWIO, a
    5-D one OIDHW -> DHWIO; every key renamed by `key_map`. Takes numpy
    arrays or tensors (views, no copy). JAX takes every `.weight` under a
    module whose path names an embedding for a table and so leaves the
    diffusers UNet's time and add-embedding Linears untransposed (the square
    `linear_2` loads transposed; ROADMAP C lists it); the port asks the
    owning module alone (`_is_embedding_weight`)."""
    perms = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
    out = {}
    for k, v in flat.items():
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        if k.endswith(".weight") and v.ndim == 2 and not _is_embedding_weight(k):
            v = v.T
        elif k.endswith(".weight") and v.ndim in perms:
            v = v.permute(*perms[v.ndim]) if isinstance(v, torch.Tensor) else \
                np.transpose(v, perms[v.ndim])
        out[torch_key_to_flax(k, key_map)] = v
    return out


def from_pretrained(model_class, config_class, key_map: KeyMap, path: str, *, device="cuda",
                    dtype=None, convert: Optional[Callable] = None,
                    unused: Tuple[str, ...] = (), param_dtype: Optional[torch.dtype] = None,
                    fp32_modules: Tuple[type, ...] = (),
                    build: Optional[Callable] = None, subfolder: Optional[str] = None,
                    drop_unexpected: bool = False) -> torch.nn.Module:
    """`model_class(config, dtype=dtype)` (dtype: the compute dtype; or
    `build(config)`) with the config of directory `path` (or its
    `subfolder`) and its weights on `device`, the parameters in fp32, or in
    `param_dtype` but for the submodules of the `fp32_modules` types. Each
    tensor of the file goes to the device as it is stored and is cast there:
    nothing of the model's size is converted on the host. Torch-keyed weights lose the keys that
    match a pattern of `unused` (ones the model has no parameter for, as the
    JAX loader drops them), then go through `convert` (a model's copy of the
    JAX package's `convert_foreign_state_dict`, taking the stored tensors,
    views of the mapped files, in their own dtypes) where given, else
    `convert_torch_state_dict` with `key_map`. With `drop_unexpected`, flax keys the model has no parameter
    for are dropped with a warning (the JAX loader's unexpected keys); else
    they are refused with the missing and mis-shaped ones."""
    config = config_class.from_pretrained(path, subfolder=subfolder)
    flat = load_flat_state(path, subfolder)
    with torch.device("meta"):
        model = build(config) if build is not None else model_class(config, dtype=dtype)
        if param_dtype is not None:
            model.to(param_dtype)
            for m in model.modules():
                if isinstance(m, fp32_modules):
                    m.float()
    expected = {torch_key_to_flax(k, key_map): v.ndim for k, v in model.state_dict().items()}
    if not set(expected) <= set(flat):  # torch keys: through the key map
        flat = {k: v for k, v in flat.items() if not any(re.match(p, k) for p in unused)}
        flat = convert(flat) if convert is not None else convert_torch_state_dict(flat, key_map)
    # a 0-d parameter (the logit scale) may come back from safetensors as (1,)
    flat = {k: v.reshape(()) if expected.get(k) == 0 and tuple(v.shape) == (1,) else v
            for k, v in flat.items()}
    if drop_unexpected and set(flat) - set(expected):
        dropped = sorted(set(flat) - set(expected))
        logger.warning("%s: %d keys the model has no parameter for are dropped, e.g. %s",
                       model_class.__name__, len(dropped), dropped[:5])
        flat = {k: v for k, v in flat.items() if k in expected}
    model = model.to_empty(device=device)
    load_flax_state_(model, flat, key_map)
    return model.eval()


def save_pretrained(model: torch.nn.Module, directory: str, key_map: Optional[KeyMap] = None,
                    max_shard_bytes: int = MAX_SHARD_BYTES) -> Dict[str, int]:
    """Write `model` as the JAX package's `save_pretrained` does: its
    config's `config.json`, and its parameters and buffers in flax keys and
    layouts (`torch_to_flax_state_dict` through `key_map`, the model's
    `flax_key_map` by default; a LoRA-parametrized weight writes its base)
    in their own dtypes, one `model.safetensors` up to `max_shard_bytes`,
    else shards of at most that many bytes (a tensor larger than that alone)
    and `model.safetensors.index.json`. The shards are filled in JAX's order,
    the flax tree's (`jax.tree_util` sorts a dict's keys at every level), so
    the split is JAX's. Each tensor is brought to the host as it is written.
    Returns {file name: bytes}."""
    key_map = key_map if key_map is not None else model.flax_key_map
    os.makedirs(directory, exist_ok=True)
    model.config.save_pretrained(directory)
    flat = torch_to_flax_state_dict(model, key_map)
    return save_state_dict({k: flat[k] for k in sorted(flat, key=lambda k: k.split("."))},
                           directory, max_shard_bytes)


def save_state_dict(flat: Dict[str, torch.Tensor], directory: str,
                    max_shard_bytes: int = MAX_SHARD_BYTES) -> Dict[str, int]:
    """Write `flat` ({key: tensor}) into `directory` as one
    `model.safetensors` up to `max_shard_bytes`, else as shards of at most
    that many bytes (a tensor larger than that alone), filled in `flat`'s
    order and named `model-0000i-of-0000n.safetensors` (JAX's and
    transformers' names), with `model.safetensors.index.json`. Returns {file
    name: bytes}."""
    os.makedirs(directory, exist_ok=True)
    sizes = {k: v.numel() * v.element_size() for k, v in flat.items()}
    total = sum(sizes.values())
    if total <= max_shard_bytes:
        return {SAFETENSORS_NAME: safetensors.save_file(
            flat, os.path.join(directory, SAFETENSORS_NAME))}
    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        if cur and cur_bytes + sizes[k] > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += sizes[k]
    shards.append(cur)
    written, index = {}, {"metadata": {"total_size": total}, "weight_map": {}}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"  # JAX's names
        written[name] = safetensors.save_file(shard, os.path.join(directory, name))
        index["weight_map"].update({k: name for k in shard})
    with open(os.path.join(directory, SAFETENSORS_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return written
