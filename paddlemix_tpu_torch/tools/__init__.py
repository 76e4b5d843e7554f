"""Command-line entry points (port of paddlemix_tpu/tools)."""
