"""CLIP zero-shot classification (port of
paddlemix_tpu/metrics/clip_zero_shot.py): a classifier of template-averaged
class embeddings, and top-k accuracy of image features against it."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

DEFAULT_TEMPLATES = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
)


def _l2(t):
    return t / t.norm(dim=-1, keepdim=True)


@torch.no_grad()
def build_zero_shot_classifier(encode_text: Callable[[torch.Tensor], torch.Tensor], tokenizer,
                               classnames: Sequence[str],
                               templates: Sequence[str] = DEFAULT_TEMPLATES,
                               batch_size: int = 64, device="cuda") -> torch.Tensor:
    """(classes, dim) L2-normalised class embeddings: for each batch of
    `batch_size` classes, each template's prompts through `encode_text` (ids
    on `device`), normalised, averaged over the templates, normalised."""
    embeddings = []
    for i in range(0, len(classnames), batch_size):
        chunk = classnames[i: i + batch_size]
        per_template = []
        for template in templates:
            ids = tokenizer([template.format(c) for c in chunk])["input_ids"]
            per_template.append(_l2(encode_text(torch.as_tensor(ids, device=device).long())))
        embeddings.append(_l2(torch.stack(per_template).mean(dim=0)))
    return torch.cat(embeddings, dim=0)


@torch.no_grad()
def zero_shot_accuracy(image_feats: torch.Tensor, classifier: torch.Tensor, labels: torch.Tensor,
                       topk: Sequence[int] = (1, 5)) -> dict:
    """{"top<k>": the share of images whose label is among their k best
    classes}, the classes ranked by a stable sort of the cosine logits."""
    logits = _l2(image_feats) @ classifier.T
    ranks = torch.argsort(-logits, dim=-1, stable=True)
    out = {}
    for k in topk:
        k_eff = min(k, logits.shape[-1])
        hit = (ranks[:, :k_eff] == labels.to(ranks.device)[:, None]).any(dim=-1)
        out[f"top{k}"] = float(hit.float().mean())
    return out
