"""Profiling utilities."""

from .profiling import StageProfiler, profile_pipeline, trace

__all__ = ["StageProfiler", "profile_pipeline", "trace"]
