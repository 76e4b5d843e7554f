"""BLIP-2 image and text processing (port of
paddlemix_tpu/processors/blip_processing.py): the eval transform (a plain
resize to `size`, rescale, normalise) and the train transform (a random
resized crop and a horizontal flip, drawn from an explicit
`np.random.Generator`), caption and question normalisation with the task
prompt, and `Blip2Processor`, which pairs pixel batches (NHWC float32) with
the tokenizer's ids.

OPT's GPT-2 BPE tokenizer is not ported (its files are not in the
repository): `Blip2Processor` takes a tokenizer object or None, and with
None it processes images alone. The JAX processor draws from an unseeded
generator where none is given; the port's train transform asks for one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import BaseImageProcessor, ProcessorMixin
from .image_utils import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, normalize, resize, to_numpy_rgb


@dataclasses.dataclass
class BlipImageProcessor(BaseImageProcessor):
    model_type = "blip_image_processor"
    size: int = 224
    resample: str = "bicubic"
    do_rescale: bool = True
    rescale_factor: float = 1 / 255.0
    do_normalize: bool = True
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD
    # the train transform's random resized crop and flip
    scale_min: float = 0.5
    scale_max: float = 1.0
    flip_prob: float = 0.5

    def random_resized_crop(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Up to 10 draws of an area share in [scale_min, scale_max] and an
        aspect ratio in [3/4, 4/3] (log-uniform); the first crop that fits,
        resized to `size`, else the whole image resized."""
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(self.scale_min, self.scale_max) * area
            ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            ch = int(round(np.sqrt(target / ratio)))
            cw = int(round(np.sqrt(target * ratio)))
            if ch <= h and cw <= w:
                top = rng.integers(0, h - ch + 1)
                left = rng.integers(0, w - cw + 1)
                crop = arr[top: top + ch, left: left + cw]
                return resize(crop, (self.size, self.size), self.resample)
        return resize(arr, (self.size, self.size), self.resample)

    def __call__(self, images, mode: str = "eval",
                 rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        """One image or a list -> {"pixel_values": (N, size, size, 3)
        float32}; mode "train" draws its crops and flips from `rng`."""
        if mode not in ("eval", "train"):
            raise ValueError(f"BlipImageProcessor: mode {mode!r} is not 'eval' or 'train'")
        if mode == "train" and rng is None:
            raise ValueError("BlipImageProcessor: the train transform draws from `rng`, an "
                             "np.random.Generator; none was given")
        if not isinstance(images, (list, tuple)):
            images = [images]
        out = []
        for im in images:
            arr = to_numpy_rgb(im)
            if mode == "train":
                arr = self.random_resized_crop(arr, rng)
                if rng.random() < self.flip_prob:
                    arr = arr[:, ::-1]
            else:
                arr = resize(arr, (self.size, self.size), self.resample)
            arr = arr.astype(np.float32)
            if self.do_rescale:
                arr = arr * self.rescale_factor
            if self.do_normalize:
                arr = normalize(arr, self.image_mean, self.image_std)
            out.append(arr)
        return {"pixel_values": np.stack(out)}


@dataclasses.dataclass
class BlipTextProcessor(BaseImageProcessor):
    """Caption and question normalisation with the task prompt."""

    model_type = "blip_text_processor"
    prompt: str = ""
    max_words: int = 50
    do_caption: bool = True
    do_question: bool = False

    def pre_caption(self, caption: str) -> str:
        """Lower case, punctuation to spaces, runs of spaces to one, trimmed,
        at most max_words words."""
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    def pre_question(self, question: str) -> str:
        """Lower case, punctuation removed, trailing spaces dropped, at most
        max_words words."""
        question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question

    def __call__(self, text, do_caption: Optional[bool] = None,
                 do_question: Optional[bool] = None, mode: str = "train") -> List[str]:
        """Captions: prompt + pre_caption; questions: the prompt formatted with
        pre_question; mode "train" ends each with a newline."""
        do_caption = self.do_caption if do_caption is None else do_caption
        do_question = self.do_question if do_question is None else do_question
        if do_caption == do_question:
            raise ValueError("exactly one of do_caption/do_question")
        if not isinstance(text, (list, tuple)):
            text = [text]
        if do_caption:
            results = [self.prompt + self.pre_caption(t) for t in text]
        else:
            results = [self.prompt.format(self.pre_question(t)) for t in text]
        if mode == "train":
            results = [r + "\n" for r in results]
        return results


class Blip2Processor(ProcessorMixin):
    """Images and text -> model inputs: `pixel_values` from the image
    processor, and the tokenizer's `input_ids` / `attention_mask` of the
    normalised text. The FlanT5 branch's decoder inputs come with the port's
    T5 decoder (ROADMAP A.2)."""

    image_processor_class = BlipImageProcessor

    def __init__(self, image_processor=None, text_processor=None, tokenizer=None, **kw):
        super().__init__(image_processor=image_processor or BlipImageProcessor(),
                         tokenizer=tokenizer, **kw)
        self.text_processor = text_processor or BlipTextProcessor()

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, **kwargs):
        """The image processor of preprocessor_config.json (defaults where
        there is none) and `tokenizer` as given: the JAX package loads OPT's
        GPT-2 BPE files here, which the port does not read."""
        try:
            image_processor = BlipImageProcessor.from_pretrained(path)
        except FileNotFoundError:
            image_processor = BlipImageProcessor()
        return cls(image_processor=image_processor, tokenizer=tokenizer, **kwargs)

    def __call__(self, images=None, text=None, max_length: int = 32, mode: str = "train",
                 rng: Optional[np.random.Generator] = None, **kwargs):
        if images is None and text is None:
            raise ValueError("You have to specify either images or text.")
        enc: Dict[str, np.ndarray] = {}
        if images is not None:
            enc.update(self.image_processor(images, mode=mode, rng=rng))
        if text is not None:
            if self.tokenizer is None:
                raise ValueError("Blip2Processor: text needs a tokenizer (OPT's is not ported: "
                                 "give one, or pass token ids to the model)")
            enc.update(self.tokenizer(self.text_processor(text, mode=mode),
                                      max_length=max_length))
        return enc

    def batch_decode(self, sequences, **kwargs):
        return [self.decode(s, **kwargs) for s in sequences]

    def decode(self, ids, **kwargs):
        if self.tokenizer is None:
            raise ValueError("Blip2Processor: decoding needs a tokenizer (OPT's is not ported)")
        return self.tokenizer.decode(np.asarray(ids).tolist(), **kwargs)
