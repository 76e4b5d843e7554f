"""The CLIP image processor in the port (processors.clip_processing,
processors.image_utils, native), held against the JAX package's on the CPU:
the default path bit for bit on PIL and numpy images of odd sizes, modes
and layouts (bicubic resize of the shortest edge with the long side
truncated, the centre crop with its padding, rescale, normalise); the port's
own g++ build of the native C++ against the JAX package's native functions,
bit for bit, and the native path of the processor (bilinear, the long side
rounded) against JAX's native path; the preprocessor_config.json round trip;
the refusal to hide a failed build under PMIX_NATIVE_PREPROCESS=1; and
tools/train_clip.main --synthetic, the example's data plane (generated jpegs
decoded and preprocessed in the DataLoader's workers), on a tiny CLIP.

Images are made with numpy from a seed.
"""

import shutil

import numpy as np
import pytest
from PIL import Image

from paddlemix_tpu import native as jnative
from paddlemix_tpu.processors import CLIPImageProcessor as JCLIPImageProcessor
from paddlemix_tpu_torch import native
from paddlemix_tpu_torch.models.clip import CLIPConfig
from paddlemix_tpu_torch.models.clip import vitb16
from paddlemix_tpu_torch.processors import CLIPImageProcessor
from paddlemix_tpu_torch.processors import image_utils
from paddlemix_tpu_torch.tools import train_clip

pytestmark = pytest.mark.torch_port

CONFIGS = {"default": {}, "small": dict(size=24, crop_size=20),
           "pad": dict(size=16, crop_size=20), "bilinear": dict(size=40, resample="bilinear")}


def _images(seed):
    """PIL RGB and L images and numpy HWC, HW (gray), CHW and float arrays,
    of odd sizes, portrait and landscape."""
    rng = np.random.default_rng(seed)
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    return [Image.fromarray(u8(37, 53, 3)), Image.fromarray(u8(71, 29), mode="L"),
            u8(61, 29, 3), u8(45, 45), u8(3, 40, 70), u8(301, 199, 3),
            rng.uniform(0, 255, (33, 47, 3)).astype(np.float32)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_default_path_is_bit_equal_to_jax(name, monkeypatch):
    monkeypatch.delenv("PMIX_NATIVE_PREPROCESS", raising=False)
    kw = CONFIGS[name]
    port, ref = CLIPImageProcessor(**kw), JCLIPImageProcessor(**kw)
    images = _images(len(name))
    for im in images:
        a, b = port(im)["pixel_values"], ref(im)["pixel_values"]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # a batch at once
    np.testing.assert_array_equal(port(images)["pixel_values"], ref(images)["pixel_values"])


def test_image_utils_match_jax():
    from paddlemix_tpu.processors import image_utils as jiu

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (50, 83, 3), dtype=np.uint8)
    for short in (17, 64):
        np.testing.assert_array_equal(image_utils.resize_shortest_edge(img, short),
                                      jiu.resize_shortest_edge(img, short))
    # the long side truncated: 83 * 17 / 50 = 28.22 -> 28, 83 * 29 / 50 = 48.14 -> 48
    assert image_utils.resize_shortest_edge(img, 17).shape[:2] == (17, 28)
    np.testing.assert_array_equal(image_utils.center_crop(img, (60, 60)),
                                  jiu.center_crop(img, (60, 60)))
    for a, b in ((image_utils.OPENAI_CLIP_MEAN, jiu.OPENAI_CLIP_MEAN),
                 (image_utils.OPENAI_CLIP_STD, jiu.OPENAI_CLIP_STD),
                 (image_utils.IMAGENET_MEAN, jiu.IMAGENET_MEAN),
                 (image_utils.IMAGENET_STD, jiu.IMAGENET_STD)):
        assert a == b


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native preprocess cannot be built")


def test_native_build_is_bit_equal_to_jax_native(gxx):
    assert jnative.available()
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    for size in [(40, 54), (224, 303), (97, 131), (7, 300)]:
        np.testing.assert_array_equal(
            native.resize_normalize(img, size, image_utils.OPENAI_CLIP_MEAN,
                                    image_utils.OPENAI_CLIP_STD),
            jnative.resize_normalize(img, size, image_utils.OPENAI_CLIP_MEAN,
                                     image_utils.OPENAI_CLIP_STD))
    f = rng.standard_normal((50, 61, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.center_crop(f, (32, 40)), jnative.center_crop(f, (32, 40)))
    p = rng.standard_normal((56, 84, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.extract_patches(p, 14), jnative.extract_patches(p, 14))
    assert native.load_library()._name.startswith(str(native.BUILD_DIR))
    with pytest.raises(ValueError):
        native.center_crop(f, (51, 10))  # the C code does not pad


def test_native_path_matches_jax_native_path(gxx, monkeypatch):
    monkeypatch.setenv("PMIX_NATIVE_PREPROCESS", "1")
    port, ref = CLIPImageProcessor(size=40, crop_size=32), JCLIPImageProcessor(size=40,
                                                                                crop_size=32)
    for im in _images(3):
        np.testing.assert_array_equal(port(im)["pixel_values"], ref(im)["pixel_values"])
    # it is another path: bilinear and the long side rounded, not PIL's bicubic
    im = _images(4)[5]
    native_px = port(im)["pixel_values"]
    monkeypatch.delenv("PMIX_NATIVE_PREPROCESS")
    assert not np.array_equal(native_px, port(im)["pixel_values"])


def test_failed_native_build_raises(gxx, monkeypatch, tmp_path):
    broken = tmp_path / "preprocess.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PMIX_NATIVE_PREPROCESS", "1")
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
            CLIPImageProcessor()(np.zeros((30, 40, 3), np.uint8))
    finally:
        native._load.cache_clear()  # the next call builds the real source again


def test_preprocessor_config_round_trip(tmp_path):
    port = CLIPImageProcessor(size=256, crop_size=240, resample="bilinear")
    port.save_pretrained(str(tmp_path / "port"))
    assert CLIPImageProcessor.from_pretrained(str(tmp_path / "port")) == port
    # a config the JAX package wrote loads into the port, tuples and all
    JCLIPImageProcessor(size=300, image_mean=(0.5, 0.5, 0.5)).save_pretrained(
        str(tmp_path / "jax"))
    loaded = CLIPImageProcessor.from_pretrained(str(tmp_path / "jax"))
    assert loaded.size == 300 and loaded.image_mean == (0.5, 0.5, 0.5)


def test_train_clip_main_synthetic_runs_the_data_plane(monkeypatch):
    """`main(["--synthetic"])` on the CPU with a tiny CLIP in place of ViT-B/16:
    256 generated 640 x 480 jpegs, each batch decoded and preprocessed by
    CLIPImageProcessor inside the loader's workers, CLIP_STEPS steps of
    CLIP_BATCH; the temporary jpegs are removed after the run."""
    import os
    import tempfile
    import threading

    tiny = CLIPConfig(vision_config=dict(hidden_size=32, intermediate_size=64,
                                         num_hidden_layers=1, num_attention_heads=2,
                                         image_size=224, patch_size=32),
                      text_config=dict(hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=1, num_attention_heads=2),
                      projection_dim=16)
    monkeypatch.setattr(train_clip, "random_clip",
                        lambda device, seed=0: vitb16.random_clip(device, seed, tiny))
    seen = []
    call = train_clip.CLIPImageProcessor.__call__

    def counted(self, images):
        seen.append((threading.get_ident(), np.asarray(images).shape))
        return call(self, images)
    monkeypatch.setattr(train_clip.CLIPImageProcessor, "__call__", counted)
    monkeypatch.setenv("CLIP_STEPS", "2")
    monkeypatch.setenv("CLIP_BATCH", "4")
    before = set(os.listdir(tempfile.gettempdir()))
    result = train_clip.main(["--synthetic"], device="cpu")
    assert result["final_step"] == 2 and np.isfinite(result["loss"])
    assert len(seen) >= 8 and all(shape == (480, 640, 3) for _, shape in seen)
    assert threading.get_ident() not in {t for t, _ in seen}  # in the workers
    assert not {n for n in set(os.listdir(tempfile.gettempdir())) - before
                if n.startswith("clip_synth_jpegs_")}
