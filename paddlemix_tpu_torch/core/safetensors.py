"""The safetensors format, read and written with torch alone (the port's
counterpart of the `safetensors` library, which the JAX package calls).

A file is an 8-byte little-endian header length N, N bytes of JSON (every
tensor's dtype, shape and [begin, end) byte offsets into the data that
follows, and an optional "__metadata__" map of strings), padded with spaces
to a multiple of 8, then the raw little-endian bytes. `save_file` writes what
the library writes, byte for byte: tensors ordered by dtype, widest first
(I64, F64, F32, I32, BF16, F16, I16, I8, U8, BOOL), then by name, packed
back to back, so each starts aligned to its element size. bf16 is written
and read as its raw 16 bits: nothing widens to fp32.

`load_file` maps the file (copy-on-write: the tensors are writable and
writing them leaves the file alone) and returns CPU tensors over it, so that
reading a checkpoint costs no copy before the tensors move to their device.
It refuses a truncated file, overlapping or gapped offsets, a size that is
not the shape's and an unknown dtype, each with a message.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

# the library's names, in its write order (widest first)
DTYPES = {"I64": torch.int64, "F64": torch.float64, "F32": torch.float32, "I32": torch.int32,
          "BF16": torch.bfloat16, "F16": torch.float16, "I16": torch.int16, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_ORDER = {name: i for i, name in enumerate(DTYPES)}
# a header longer than this is refused, as the library refuses it
MAX_HEADER_BYTES = 100_000_000


def _dtype_name(t: torch.Tensor) -> str:
    try:
        return _NAMES[t.dtype]
    except KeyError:
        raise ValueError(f"safetensors: dtype {t.dtype} cannot be saved (supported: "
                         f"{sorted(_NAMES.values())})") from None


def _layout(tensors: Mapping[str, torch.Tensor],
            metadata: Optional[Dict[str, str]]) -> Tuple[bytes, list]:
    """(the padded header with its length prefix, the names in write order)."""
    order = sorted(tensors, key=lambda k: (_ORDER[_dtype_name(tensors[k])], k))
    header: Dict[str, object] = {}
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors: metadata must map strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw, order


def _bytes_of(t: torch.Tensor):
    """A buffer of `t`'s raw bytes on the host, in row-major order: a
    strided view (a transposed weight) is laid out on its own device first,
    where the copy is fast, then brought over."""
    t = t.detach().contiguous().to("cpu").reshape(-1)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else b""


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any device, any strides: each is laid out row-major
    and brought to the host in turn, so at most one tensor's bytes sit on
    the host at a time) to `path`. Returns the bytes written."""
    for name, t in tensors.items():
        if not isinstance(name, str) or name == "__metadata__":
            raise ValueError(f"safetensors: bad tensor name {name!r}")
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"safetensors: {name} is a {type(t).__name__}, not a torch.Tensor")
    head, order = _layout(tensors, metadata)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(head)
            for name in order:
                f.write(_bytes_of(tensors[name]))
            written = f.tell()
        os.replace(tmp, path)  # a reader never sees half a file
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return written


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries by name, metadata, where the data begins) of `path`,
    checked against the file's size: every entry's dtype known, its bytes
    those of its shape, the entries back to back from 0 to the end of the
    file without overlap or gap."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 8:
            raise ValueError(f"safetensors: {path} is truncated ({size} bytes, no header length)")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise ValueError(f"safetensors: {path} is truncated or not safetensors (header of "
                             f"{n} bytes in a file of {size})")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"safetensors: {path} has an unreadable header ({e})") from None
    metadata = header.pop("__metadata__", None) or {}
    spans = []
    for name, e in header.items():
        if e.get("dtype") not in DTYPES:
            raise ValueError(f"safetensors: {path}: {name} has an unknown dtype "
                             f"{e.get('dtype')!r} (known: {list(DTYPES)})")
        begin, end = e["data_offsets"]
        numel = 1
        for s in e["shape"]:
            numel *= int(s)
        want = numel * torch.empty((), dtype=DTYPES[e["dtype"]]).element_size()
        if end - begin != want or begin < 0:
            raise ValueError(f"safetensors: {path}: {name} spans bytes [{begin}, {end}) but "
                             f"{e['dtype']} {e['shape']} takes {want}")
        spans.append((begin, end, name))
    spans.sort()
    at = 0
    for begin, end, name in spans:
        if begin < at:
            raise ValueError(f"safetensors: {path}: {name} at [{begin}, {end}) overlaps the "
                             f"tensor before it (which ends at {at})")
        if begin > at:
            raise ValueError(f"safetensors: {path}: a gap of bytes [{at}, {begin}) before {name}")
        at = end
    if 8 + n + at != size:
        raise ValueError(f"safetensors: {path} is truncated or has trailing bytes: the header "
                         f"needs {8 + n + at} bytes, the file has {size}")
    return header, metadata, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of `path` by name, as CPU tensors over a copy-on-write
    map of the file."""
    header, _, start = read_header(path)
    size = os.path.getsize(path)
    data = torch.empty(0, dtype=torch.uint8)
    if size > start:
        storage = torch.UntypedStorage.from_file(path, shared=False, nbytes=size)
        data = torch.empty(0, dtype=torch.uint8).set_(storage)[start:]
    out = {}
    for name, e in header.items():
        begin, end = e["data_offsets"]
        dtype = DTYPES[e["dtype"]]
        raw = data[begin:end]
        if begin % raw.new_empty((), dtype=dtype).element_size():
            raw = raw.clone()  # a writer that packs unaligned: copy to an aligned buffer
        t = raw.view(dtype).reshape(e["shape"]) if end > begin else \
            torch.empty(e["shape"], dtype=dtype)
        out[name] = t
    return out
