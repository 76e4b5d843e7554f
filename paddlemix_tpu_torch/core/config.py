"""A json-round-trippable dataclass config base (port of
paddlemix_tpu/core/config.py, local directories only: the JAX package's hub
download is not ported).

Every processor and model config that saves itself is a `@dataclass`
subclassing `BaseConfig`: the constructor's arguments are the persisted
config, and keys a class has no field for are kept in `unused_kwargs`, so
that foreign config files load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T", bound="BaseConfig")

CONFIG_NAME = "config.json"


def resolve_file(path: str, filename: str, subfolder: Optional[str] = None,
                 required: bool = True) -> Optional[str]:
    """`path` itself where it is a file, else `filename` inside the local
    directory `path` (or its `subfolder`); None, or FileNotFoundError where
    `required`, when it is not there."""
    if os.path.isfile(path):
        return path
    full = os.path.join(path, subfolder or "", filename)
    if os.path.isfile(full):
        return full
    if required:
        raise FileNotFoundError(f"{filename} not found under {path!r} (subfolder={subfolder!r})")
    return None


@dataclasses.dataclass
class BaseConfig:
    config_name = CONFIG_NAME
    model_type = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model_type"] = type(self).model_type
        d["_class_name"] = type(self).__name__
        return d

    def to_json_string(self) -> str:
        def _default(o):
            if hasattr(o, "tolist"):
                return o.tolist()
            if isinstance(o, (set, tuple)):
                return list(o)
            return str(o)

        return json.dumps(self.to_dict(), indent=2, sort_keys=True, default=_default) + "\n"

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, self.config_name), "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any], **overrides) -> T:
        data = dict(data, **overrides)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in data.items() if k in field_names}
        unused = {k: v for k, v in data.items() if k not in field_names}
        # tuples serialise as lists; coerce them back for fields typed as tuple
        for f in dataclasses.fields(cls):
            if f.name in kept and isinstance(kept[f.name], list):
                origin = getattr(f.type, "__origin__", None)
                if origin is tuple or (isinstance(f.type, str) and f.type.startswith("Tuple")):
                    kept[f.name] = tuple(kept[f.name])
        cfg = cls(**kept)
        object.__setattr__(cfg, "unused_kwargs", unused)
        return cfg

    @classmethod
    def from_pretrained(cls: Type[T], path: str, subfolder: Optional[str] = None,
                        **overrides) -> T:
        with open(resolve_file(path, cls.config_name, subfolder)) as f:
            data = json.load(f)
        return cls.from_dict(data, **overrides)
