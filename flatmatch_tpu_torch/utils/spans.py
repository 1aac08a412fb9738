"""Named steps of the program on the profiler's clock.

`with span("engine.run"): ...` marks one step of a render. While a
`torch.profiler` is recording, the span is `torch.profiler.record_function`:
it lands in the trace as a `user_annotation` event, nested under the span
that encloses it and on the clock of every kernel, copy and set the
profiler records, so a trace names the step that issued them or left the
card idle. With no profiler recording, `span` returns one shared no-op
context after the profiler's own enabled check: it allocates nothing,
reads no tensor and synchronises nothing.

The names are the program's steps (`<layer>.<step>`); README.md lists
them and PERF.md the metric that reads each.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks step `name` in a recording profiler's trace,
    else the shared no-op context."""
    return torch.profiler.record_function(name) if _recording() else _OFF
