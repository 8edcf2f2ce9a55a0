"""The program's spans: named host ranges at the port's layer boundaries,
off by default.

``with span("infer"):`` is a ``torch.profiler.record_function`` range named
``gnms.infer`` while spans are on (``enable(True)``), so a profiler that is
running records it on the same clock as the kernels, copies and CUDA runtime
calls of its trace; a kernel belongs to the span open on the thread of its
launch (the runtime call that shares its correlation id).  While spans are
off ``span`` returns one shared ``contextlib.nullcontext()``: no profiler
call, nothing in a ``torch.export`` graph.  Span names are constants, or
built once when a module is constructed.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "gnms."
_OFF = contextlib.nullcontext()
_on = False


def enable(flag):
    """Switch the program's spans on (True) or off (False)."""
    global _on
    _on = bool(flag)


def enabled():
    return _on


def span(name):
    """A context manager: the range ``gnms.<name>`` while spans are on,
    else a shared no-op."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
