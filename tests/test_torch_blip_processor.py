"""The BLIP-2 processors in the port (processors.blip_processing) against the
JAX package's, on the CPU: the eval pixels (a plain bicubic or bilinear
resize, rescale, normalise) bit for bit on PIL and numpy images of odd
sizes, modes and layouts; the train transform (random resized crop and
flip) bit for bit when both draw from generators of one seed; the caption
and question normalisation strings; `Blip2Processor` with a tokenizer object
and without one; the preprocessor_config.json round trip.

Images and strings are made from a seed.
"""

import numpy as np
import pytest
from PIL import Image

from paddlemix_tpu.processors.blip_processing import Blip2Processor as JBlip2Processor
from paddlemix_tpu.processors.blip_processing import BlipImageProcessor as JBlipImageProcessor
from paddlemix_tpu.processors.blip_processing import BlipTextProcessor as JBlipTextProcessor
from paddlemix_tpu_torch.processors import Blip2Processor, BlipImageProcessor, BlipTextProcessor

pytestmark = pytest.mark.torch_port

CONFIGS = {"default": {}, "small": dict(size=24), "bilinear": dict(size=40, resample="bilinear"),
           "no_normalize": dict(do_normalize=False), "crop_range": dict(scale_min=0.2,
                                                                       flip_prob=0.9)}


def _images(seed):
    """PIL RGB and L images and numpy HWC, HW (gray) and CHW arrays, of odd
    sizes, portrait and landscape."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    return [Image.fromarray(rgb), Image.fromarray(rgb[..., 0]).convert("L"),
            rng.integers(0, 256, (61, 29, 3), dtype=np.uint8),
            rng.integers(0, 256, (20, 30), dtype=np.uint8),
            np.ascontiguousarray(np.transpose(rng.integers(0, 256, (45, 47, 3), dtype=np.uint8),
                                              (2, 0, 1)))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eval_pixels_are_bit_equal_to_jax(name):
    cfg = CONFIGS[name]
    ours, theirs = BlipImageProcessor(**cfg), JBlipImageProcessor(**cfg)
    for im in _images(0):
        got = ours(im)["pixel_values"]
        want = theirs(im)["pixel_values"]
        assert got.dtype == np.float32 and got.shape == (1, ours.size, ours.size, 3)
        np.testing.assert_array_equal(got, want)
    batch = _images(1)
    np.testing.assert_array_equal(ours(batch)["pixel_values"], theirs(batch)["pixel_values"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_pixels_are_bit_equal_to_jax_from_one_seed(name):
    """The crops and flips drawn from np.random.Generators of one seed: the
    same draws, the same pixels, image after image."""
    cfg = CONFIGS[name]
    ours, theirs = BlipImageProcessor(**cfg), JBlipImageProcessor(**cfg)
    images = _images(2) * 3
    got = ours(images, mode="train", rng=np.random.default_rng(7))["pixel_values"]
    want = theirs(images, mode="train", rng=np.random.default_rng(7))["pixel_values"]
    np.testing.assert_array_equal(got, want)
    # the draws matter: another seed gives other pixels
    other = ours(images, mode="train", rng=np.random.default_rng(8))["pixel_values"]
    assert not np.array_equal(got, other)


def test_train_transform_asks_for_a_generator():
    with pytest.raises(ValueError, match="np.random.Generator"):
        BlipImageProcessor()(_images(0)[0], mode="train")
    with pytest.raises(ValueError, match="mode"):
        BlipImageProcessor()(_images(0)[0], mode="test")


TEXTS = ["A Man riding a horse.  On the BEACH!!", "  two dogs; playing (in) the snow*  ",
         "What is the man holding?", "a photo #1: the ~quick~ brown fox\n",
         " ".join(f"w{i}" for i in range(70)), "", "ALL CAPS"]


@pytest.mark.parametrize("prompt,max_words", [("", 50), ("a photo of ", 5),
                                              ("Question: {} Answer:", 50)])
def test_text_normalisation_strings_equal_jax(prompt, max_words):
    ours = BlipTextProcessor(prompt=prompt, max_words=max_words)
    theirs = JBlipTextProcessor(prompt=prompt, max_words=max_words)
    for t in TEXTS:
        assert ours.pre_caption(t) == theirs.pre_caption(t)
        assert ours.pre_question(t) == theirs.pre_question(t)
    for mode in ("train", "eval"):
        assert ours(TEXTS, mode=mode) == theirs(TEXTS, mode=mode)
        assert ours(TEXTS, do_caption=False, do_question=True, mode=mode) == \
            theirs(TEXTS, do_caption=False, do_question=True, mode=mode)
    with pytest.raises(ValueError):
        ours("x", do_caption=True, do_question=True)


class _Tokenizer:
    """A stand-in tokenizer object: one id a character, right-padded."""

    def __call__(self, texts, max_length=32):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, t in enumerate(texts):
            codes = [ord(c) % 97 + 3 for c in t][:max_length]
            ids[i, :len(codes)], mask[i, :len(codes)] = codes, 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, **kwargs):
        return "".join(chr(i - 3) for i in ids if i > 0)


def test_blip2_processor_equals_jax_with_a_tokenizer():
    images, text = _images(3)[:2], ["A dog.", "Two CATS!"]
    ours = Blip2Processor(tokenizer=_Tokenizer())
    theirs = JBlip2Processor(tokenizer=_Tokenizer())
    for mode in ("train", "eval"):
        got = ours(images=images, text=text, mode=mode, max_length=16,
                   rng=np.random.default_rng(0))
        want = theirs(images=images, text=text, mode=mode, max_length=16)
        assert sorted(got) == sorted(want) == ["attention_mask", "input_ids", "pixel_values"]
        for k in ("attention_mask", "input_ids"):
            np.testing.assert_array_equal(got[k], want[k])
        # the JAX processor hands its image processor no generator (its train
        # crops are unseeded draws): the port's pixels are its image
        # processor's from the generator given
        np.testing.assert_array_equal(got["pixel_values"], BlipImageProcessor()(
            images, mode=mode, rng=np.random.default_rng(0))["pixel_values"])
        if mode == "eval":
            np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    assert ours.batch_decode(got["input_ids"][:1]) == theirs.batch_decode(got["input_ids"][:1])


def test_blip2_processor_without_a_tokenizer_processes_images_alone():
    proc = Blip2Processor()
    out = proc(images=_images(4)[0], mode="eval")
    assert list(out) == ["pixel_values"] and out["pixel_values"].shape == (1, 224, 224, 3)
    with pytest.raises(ValueError, match="tokenizer"):
        proc(text="a caption")
    with pytest.raises(ValueError, match="either images or text"):
        proc()


def test_preprocessor_config_round_trip(tmp_path):
    proc = Blip2Processor(image_processor=BlipImageProcessor(size=96, resample="bilinear"))
    proc.save_pretrained(str(tmp_path))
    back = Blip2Processor.from_pretrained(str(tmp_path))
    assert back.image_processor == proc.image_processor and back.tokenizer is None
    jback = JBlipImageProcessor.from_pretrained(str(tmp_path))
    im = _images(5)[2]
    np.testing.assert_array_equal(back.image_processor(im)["pixel_values"],
                                  jback(im)["pixel_values"])
    assert Blip2Processor.from_pretrained(str(tmp_path / "none")).image_processor == \
        BlipImageProcessor()
