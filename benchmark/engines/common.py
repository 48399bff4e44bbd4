"""The run-time wrappers a traced run puts around the port's entries, which
every engine adapter shares (k-means in the build, the list-scan launches
in a search). The wrappers replace a module attribute for this process
only; the port's files are not touched."""

from __future__ import annotations

import time

import torch


# (module, attribute) -> a one-element list holding the trace the wrapper
# reports to: a module attribute is wrapped once per process, and each
# traced run points the wrapper at its own trace
_WRAPPED: dict = {}


def _wrap(module, attr: str, make_wrapper, trace) -> None:
    """Replace ``module.attr`` by ``make_wrapper(original, holder)`` once;
    ``holder[0]`` is the current run's trace."""
    key = (module.__name__, attr)
    if key not in _WRAPPED:
        _WRAPPED[key] = holder = [trace]
        setattr(module, attr, make_wrapper(getattr(module, attr), holder))
    _WRAPPED[key][0] = trace


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_build_calls(trace, modules_attrs, span: str = "build.kmeans") -> None:
    """Time every call of the named functions with the device
    synchronised on both sides, as host spans named ``span``."""

    def make(orig, holder):
        def timed(*args, **kwargs):
            tr = holder[0]
            _sync(tr.device)
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            _sync(tr.device)
            tr.host[span].append((t0, time.perf_counter()))
            return out
        return timed

    for module, attr in modules_attrs:
        _wrap(module, attr, make, trace)


def span_launches(trace, module, attr: str, span: str, keep) -> None:
    """Put each call of ``module.attr`` inside the harness span ``span``
    and, while the capture runs, keep ``keep(*args)``: what the
    yardstick's counts need of the launch's inputs (they are taken after
    the capture, so counting adds no device work to it)."""

    def make(orig, holder):
        def spanned(*args, **kwargs):
            tr = holder[0]
            with tr.span(span):
                out = orig(*args, **kwargs)
            if tr.active:
                tr.keep(span, keep(*args))
            return out
        return spanned

    _wrap(module, attr, make, trace)
