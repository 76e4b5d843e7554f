"""Qwen-VL (v1)'s processing, on the host (port of
paddlemix_tpu/processors/qwen_vl_processing.py).

Images: a 448 x 448 bicubic resize and CLIP's normalization (NHWC float32).
Queries: `from_list_format` assembles the "Picture N: <img>path</img>\\n"
runs and the text; `QwenVLProcessor.__call__` tokenizes them with the
tokenizer it is given (any object with `__call__ -> {"input_ids": ...}` and
QWen's ChatML ids). Training records: `train_preprocess` builds the ChatML
system turn and masks everything but the assistant replies to -100.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .base import BaseImageProcessor, ProcessorMixin
from .image_utils import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, normalize, resize, to_numpy_rgb

IGNORE_TOKEN_ID = -100
_IMG_TAG = re.compile(r"<img>(.*?)</img>")

CLIP_MEAN, CLIP_STD = OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def _load_image(image):
    """A file path is opened as an RGB image, as the reference processors do."""
    if isinstance(image, str):
        from PIL import Image

        return Image.open(image).convert("RGB")
    return image


@dataclasses.dataclass
class QwenVLImageProcessor(BaseImageProcessor):
    """448 x 448 bicubic + CLIP normalize."""

    model_type = "qwen_vl_image_processor"
    image_size: int = 448
    image_mean: Sequence[float] = CLIP_MEAN
    image_std: Sequence[float] = CLIP_STD

    def __call__(self, images) -> np.ndarray:
        """-> (N, image_size, image_size, 3) float32."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        out = []
        for image in images:
            arr = to_numpy_rgb(_load_image(image))
            arr = resize(arr, (self.image_size, self.image_size), resample="bicubic")
            out.append(normalize(arr / 255.0, self.image_mean, self.image_std).astype(np.float32))
        return np.stack(out, axis=0)


class QwenVLProcessor(ProcessorMixin):
    """Query assembly and ChatML training targets over an injected
    tokenizer."""

    image_processor_class = QwenVLImageProcessor

    def __init__(self, image_processor=None, tokenizer=None, max_len: int = 2048, **kw):
        super().__init__(image_processor=image_processor or QwenVLImageProcessor(),
                         tokenizer=tokenizer, **kw)
        self.max_len = max_len

    @staticmethod
    def from_list_format(query: List[dict]) -> str:
        """QWen's `from_list_format`: numbered picture tags and text runs."""
        parts, num_images = [], 0
        for ele in query:
            if "image" in ele:
                num_images += 1
                parts.append(f"Picture {num_images}: <img>{ele['image']}</img>\n")
            elif "text" in ele:
                parts.append(ele["text"])
            else:
                raise ValueError(f"unsupported query element keys: {sorted(ele)}")
        return "".join(parts)

    def __call__(self, query: Optional[List[dict]] = None,
                 record: Optional[Union[List[dict], dict, str]] = None,
                 mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """An inference query -> {"input_ids": (1, S) int32, "images": (N, H,
        W, 3) or None}; with mode "train", `train_preprocess` of the record."""
        if query is None and record is None:
            raise ValueError("You have to specify query or record.")
        if query is None:
            query = record
        if mode == "train":
            return self.train_preprocess(query)
        images = [ele["image"] for ele in query if "image" in ele]
        ids = np.asarray([self.tokenizer(self.from_list_format(query))["input_ids"]], np.int32)
        inputs: Dict[str, np.ndarray] = {"input_ids": ids, "images": None}
        if images:
            inputs["images"] = self.image_processor(images)
        return inputs

    def train_preprocess(self, sources, system_message: str = "You are a helpful assistant."):
        """ChatML assembly of a conversation string (or a dict with a
        "conversations" string) carrying <|im_start|> / <|im_end|> turns and
        optional <img>path</img> tags: {"input_ids", "labels"} int32 cut to
        max_len, every token but the assistant replies' (and the turn
        markers') labelled -100, and the image paths where there are any."""
        tok = self.tokenizer
        im_start = getattr(tok, "im_start_id", None)
        im_end = getattr(tok, "im_end_id", None)
        if im_start is None:
            im_start = tok.convert_tokens_to_ids("<|im_start|>")
        if im_end is None:
            im_end = tok.convert_tokens_to_ids("<|im_end|>")
        nl = list(tok("\n")["input_ids"])
        _system = list(tok("system")["input_ids"]) + nl

        if isinstance(sources, dict) and "conversations" in sources:
            sources = sources["conversations"]
        image_path = _IMG_TAG.findall(sources) if "<img>" in sources else []

        system = [im_start] + _system + list(tok(system_message)["input_ids"]) + [im_end] + nl
        input_id: List[int] = list(system)
        target: List[int] = [im_start] + [IGNORE_TOKEN_ID] * (len(system) - 3) + [im_end] + nl

        conv = list(tok(sources)["input_ids"])
        input_id += conv
        conv_arr = np.asarray(conv)
        starts = np.where(conv_arr == im_start)[0]
        ends = np.where(conv_arr == im_end)[0]
        asst_prefix_len = len(tok("<|im_start|>assistant")["input_ids"])
        for i in range(0, min(len(starts), len(ends)) - 1, 2):
            q = (starts[i], ends[i])
            a = (starts[i + 1], ends[i + 1])
            target += [im_start] + [IGNORE_TOKEN_ID] * (q[1] - q[0] - 1) + [im_end] + nl
            reply = conv[a[0]: a[1] + 2][asst_prefix_len + 1: -2]
            target += [im_start] + [IGNORE_TOKEN_ID] * asst_prefix_len + list(reply) \
                + [im_end] + nl
        target += [IGNORE_TOKEN_ID] * (len(input_id) - len(target))

        inputs = {"input_ids": np.asarray(input_id[: self.max_len], np.int32),
                  "labels": np.asarray(target[: self.max_len], np.int32)}
        if image_path:
            inputs["images"] = image_path
        return inputs

    def batch_decode(self, *args, **kwargs):
        return self.tokenizer.batch_decode(*args, **kwargs)

    def decode(self, ids, **kwargs):
        ids = np.asarray(ids)
        if ids.ndim > 1:
            ids = ids[0]
        return self.tokenizer.decode(list(ids), **kwargs)
