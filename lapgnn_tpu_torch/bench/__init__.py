"""Benchmark layer: the rigorous timing harness and experiment logging."""

from .harness import time_rigorous
from .logging_system import BenchmarkLogger

__all__ = ["time_rigorous", "BenchmarkLogger"]
