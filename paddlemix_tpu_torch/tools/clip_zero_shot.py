"""CLIP zero-shot classification of one image (port of
examples/clip_zero_shot.py), on the card.

Usage: python -m paddlemix_tpu_torch.tools.clip_zero_shot /path/to/clip image.jpg cat dog
(the directory holds config.json, the weights, preprocessor_config.json,
vocab.json and merges.txt). Prints each label with its score, best first.
"""

from __future__ import annotations

import sys

from PIL import Image

from ..appflow import Appflow
from ..processors.image_utils import to_numpy_rgb


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    path, image_path, *labels = argv
    app = Appflow(app="zero_shot_classification", models=[path], device=device)
    with Image.open(image_path) as im:
        result = app(image=to_numpy_rgb(im), candidate_labels=labels)
    for r in result["result"]:
        print(f"{r['label']}: {r['score']:.4f}")
    return result


if __name__ == "__main__":
    main()
