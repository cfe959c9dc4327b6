from .activations import resolve_activation
from .profiling import timed_block, trace
from .summary import count_params, format_summary

__all__ = [
    "resolve_activation",
    "count_params",
    "format_summary",
    "trace",
    "timed_block",
]
