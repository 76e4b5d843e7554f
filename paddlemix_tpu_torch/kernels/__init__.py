"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`)."""

from .build import build_all, build_log, load_library

__all__ = ["build_all", "build_log", "load_library"]
