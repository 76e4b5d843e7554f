"""Small utilities shared by the port."""

from .registry import Registry

__all__ = ["Registry"]
