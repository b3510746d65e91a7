"""Utilities: profiling/tracing helpers."""

from .profiling import roofline_report, timeit_chained, trace

__all__ = ["roofline_report", "timeit_chained", "trace"]
