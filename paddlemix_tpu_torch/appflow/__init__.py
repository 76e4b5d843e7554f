"""Appflow task pipelines (port of paddlemix_tpu/appflow)."""

from .appflow import APPLICATIONS, Appflow, AppTask, register_task

__all__ = ["APPLICATIONS", "AppTask", "Appflow", "register_task"]
