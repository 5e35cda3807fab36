"""A kernel's device time on the card, the measure by which PERF.md ranks
the kernels. This module imports torch alone, so that
`bench_point_ops`'s worker, run as a script beside it, measures another
checkout's kernels with this checkout's code."""

from __future__ import annotations

import torch


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device ms a call of fn() by torch.profiler: the self device time of
    the launches of the CUDA functions named `<kernel>_...` (the kernel's
    own; the wrapper's conversions left out) over `reps` calls. Raises
    where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(next((getattr(e, f) for f in ("self_device_time_total", "self_cuda_time_total")
                   if hasattr(e, f)), 0)
             for e in prof.key_averages() if f"{kernel}_" in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time of {kernel}")
    return us / 1e3 / reps
