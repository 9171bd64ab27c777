"""Profiling / timing utilities.

The reference's only instrumentation is wall-clock logging gated by
``RenderOption.log_level`` (integrator.cpp:40-45, scene.cpp:594-599).  Here
the same logs exist, plus a hook into ``jax.profiler`` for kernel-level
traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def log_time(label: str, enabled: bool = True):
    """Wall-clock log: '<label> in X seconds.' (reference Object::log style)."""
    t0 = time.perf_counter()
    yield
    if enabled:
        print(f"{label} in {time.perf_counter() - t0:.6g} seconds.")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed block.

    View with TensorBoard's profile plugin or Perfetto.
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
