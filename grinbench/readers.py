"""What the per-layer metrics' readers share: the device's idle share of
the profiled slice, a kernel's share of its roofline, and the device time
of the plain torch around the port's kernels.  Each returns ``None`` when
the slice has nothing to read, and the harness then leaves the metric
out."""

from __future__ import annotations

from .peaks import kernel_bound


def idle_share(run):
    """100 · (1 − busy / window) of the profiled slice, in %."""
    if run.slice.window_s <= 0.0 or run.slice.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)


def roofline_share(run, function: str, count):
    """100 · bound / time of the kernel ``function`` in %, a unit's bound
    from ``count(work)`` (operations, bytes) and its time the kernel's
    device seconds in the slice over the slice's units."""
    seconds = run.slice.kernel_s(function)
    if seconds <= 0.0 or run.units <= 0:
        return None
    return 100.0 * kernel_bound(*count(run.work)) / (seconds / run.units)


def other_device_ms(run):
    """Device ms a unit outside the port's own kernels."""
    if run.slice.busy_s <= 0.0 or run.units <= 0:
        return None
    return (run.slice.device_s() - run.slice.port_s()) / run.units * 1e3
