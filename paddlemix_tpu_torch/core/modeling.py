"""Loading a pretrained model directory (port of the load side of
paddlemix_tpu/core/modeling.py `PretrainedModel.from_pretrained`).

A directory holds `config.json` and the weights, in one of two forms:
  - `model.safetensors` (or its sharded index) as the JAX package's
    `save_pretrained` writes it, in flax keys (`...q_proj.kernel`, (in, out)
    Dense kernels, HWIO convs);
  - a torch-keyed `model.safetensors` / `pytorch_model.bin`, whose keys the
    model's key map renames to flax keys, transposing `.weight`s as the JAX
    package's `convert_torch_state_dict` does.
Either way the flax-keyed arrays then go through `flax_to_torch_state_dict`,
which refuses a key missing, left over or of the wrong shape. `safetensors`
is imported only when a safetensors file is read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import resolve_file
from .convert import KeyMap, flax_to_torch_state_dict, torch_key_to_flax

SAFETENSORS_NAME = "model.safetensors"
SAFETENSORS_INDEX_NAME = "model.safetensors.index.json"
TORCH_BIN_NAME = "pytorch_model.bin"

# The JAX package's markers, and OPT's learned positions: JAX transposes that
# (max_positions + 2, D) table as a Dense weight, then back by its shape at load
_EMBEDDING_MARKERS = ("embedding", "embed_tokens", ".wte.", ".wpe.", ".shared.", "embed_positions")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """Floats as fp32 (numpy has no bf16), integers as they are."""
    return (t.float() if t.is_floating_point() else t).numpy()


def _load_safetensors(path: str) -> Dict[str, np.ndarray]:
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        return {k: _numpy(f.get_tensor(k)) for k in f.keys()}


def load_flat_state(path: str) -> Dict[str, np.ndarray]:
    """The arrays of the weights file(s) in directory `path`, by key."""
    index = resolve_file(path, SAFETENSORS_INDEX_NAME, required=False)
    if index is not None:
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        flat: Dict[str, np.ndarray] = {}
        for name in names:
            flat.update(_load_safetensors(os.path.join(os.path.dirname(index), name)))
        return flat
    st = resolve_file(path, SAFETENSORS_NAME, required=False)
    if st is not None:
        return _load_safetensors(st)
    binary = resolve_file(path, TORCH_BIN_NAME, required=False)
    if binary is not None:
        sd = torch.load(binary, map_location="cpu", weights_only=True)
        return {k: _numpy(v) for k, v in sd.items()}
    raise FileNotFoundError(f"no {SAFETENSORS_NAME}, {SAFETENSORS_INDEX_NAME} or "
                            f"{TORCH_BIN_NAME} under {path!r}")


def convert_torch_state_dict(flat: Dict[str, np.ndarray], key_map: KeyMap) -> Dict[str, np.ndarray]:
    """torch keys and layouts -> flax ones (copy of the JAX package's
    `convert_torch_state_dict`): a 2-D `.weight` that is no embedding
    transposed to (in, out), a 3-D one OIW -> WIO, a 4-D one OIHW -> HWIO, a
    5-D one OIDHW -> DHWIO; every key renamed by `key_map`."""
    perms = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith(".weight") and v.ndim == 2 and not any(m in k for m in _EMBEDDING_MARKERS):
            v = v.T
        elif k.endswith(".weight") and v.ndim in perms:
            v = np.transpose(v, perms[v.ndim])
        out[torch_key_to_flax(k, key_map)] = v
    return out


def from_pretrained(model_class, config_class, key_map: KeyMap, path: str, *, device="cuda",
                    dtype=None, convert: Optional[Callable] = None,
                    unused: Tuple[str, ...] = ()) -> torch.nn.Module:
    """`model_class(config, dtype=dtype)` (dtype: the compute dtype) with the
    config of directory `path` and its weights, in fp32 on `device`. Torch-keyed
    weights lose the keys that match a pattern of `unused` (ones the model has
    no parameter for, as the JAX loader drops them), then go through `convert`
    (a model's copy of the JAX package's `convert_foreign_state_dict`) where
    given, else `convert_torch_state_dict` with `key_map`."""
    config = config_class.from_pretrained(path)
    flat = load_flat_state(path)
    with torch.device("meta"):
        model = model_class(config, dtype=dtype)
    expected = {torch_key_to_flax(k, key_map): v.ndim for k, v in model.state_dict().items()}
    if not set(expected) <= set(flat):  # torch keys: through the key map
        flat = {k: v for k, v in flat.items() if not any(re.match(p, k) for p in unused)}
        flat = convert(flat) if convert is not None else convert_torch_state_dict(flat, key_map)
    # a 0-d parameter (the logit scale) may come back from safetensors as (1,)
    flat = {k: v.reshape(()) if expected.get(k) == 0 and v.size == 1 else v
            for k, v in flat.items()}
    state = flax_to_torch_state_dict(flat, model, key_map)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()
