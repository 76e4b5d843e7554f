"""Appflow: task-level pipelines with chaining (port of
paddlemix_tpu/appflow/appflow.py: `AppTask`, `register_task`, `Appflow` and
the zero-shot classification task; the other tasks are not ported, ROADMAP).

A task builds its model lazily at the first call, then preprocesses, runs
and postprocesses. Models built from a path go to `device` ("cuda" unless
the caller passes another), computing in `dtype`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.registry import Registry

APPLICATIONS = Registry("applications")


class AppTask:
    """Base task: constructs its model at the first call, then runs
    preprocess -> run -> postprocess."""

    def __init__(self, task: str, model: Optional[Any] = None, **kwargs):
        self.task = task
        self.model = model
        self.kwargs = kwargs
        self._constructed = False

    def _construct(self):
        raise NotImplementedError

    def _preprocess(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return inputs

    def _run_model(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def _postprocess(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return inputs

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        if not self._constructed:
            self._construct()
            self._constructed = True
        return self._postprocess(self._run_model(self._preprocess(inputs)))


def register_task(app: str, *task_names: str):
    def deco(cls):
        APPLICATIONS.add(app, {"task_class": cls, "tasks": list(task_names) or [app]})
        return cls

    return deco


class Appflow:
    """One app: a chain of AppTasks, each fed the previous one's results."""

    def __init__(self, app: str, models: Optional[List[Any]] = None, **kwargs):
        if app not in APPLICATIONS:
            raise ValueError(f"unknown app {app!r}; known: {sorted(APPLICATIONS.keys())}")
        task_cls = APPLICATIONS.get(app)["task_class"]
        models = models or [None]
        if isinstance(task_cls, list):
            self.task_instances = [cls(task=app, model=m, **kwargs)
                                   for cls, m in zip(task_cls, models)]
        else:
            self.task_instances = [task_cls(task=app, model=models[0], **kwargs)]
        self.app = app

    def __call__(self, **inputs) -> Dict[str, Any]:
        results: Dict[str, Any] = dict(inputs)
        for task in self.task_instances:
            results = task(results)
        return results


@register_task("zero_shot_classification")
class ZeroShotClassificationTask(AppTask):
    """An image against candidate labels ("a photo of a {label}"): the
    labels by descending cosine score. The model is a path (a `CLIPModel`
    and its `CLIPProcessor`, loaded from it) or a (model, processor) pair,
    any model with `encode_image` and `encode_text` (e.g. `EVACLIP`)."""

    def _construct(self):
        if isinstance(self.model, str):
            from ..models.clip import CLIPModel
            from ..processors.clip_processing import CLIPProcessor

            self.clip = CLIPModel.from_pretrained(self.model,
                                                  device=self.kwargs.get("device", "cuda"),
                                                  dtype=self.kwargs.get("dtype"))
            self.processor = CLIPProcessor.from_pretrained(self.model)
        else:
            self.clip, self.processor = self.model

    @torch.no_grad()
    def _run_model(self, inputs):
        image = inputs["image"]
        candidates = inputs["candidate_labels"]
        enc = self.processor(text=[f"a photo of a {c}" for c in candidates], images=[image])
        dev = next(self.clip.parameters()).device
        img = self.clip.encode_image(torch.as_tensor(enc["pixel_values"], device=dev))
        txt = self.clip.encode_text(torch.as_tensor(enc["input_ids"], device=dev).long())
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        scores = (img @ txt.T)[0].float().cpu().numpy()
        order = np.argsort(-scores)
        return {"result": [{"label": candidates[i], "score": float(scores[i])} for i in order]}
