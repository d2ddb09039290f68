"""The device's idle share over the profiled sub-window: 1 minus the union
of its operations' intervals over the sub-window's host-clock length. The
profiler's own host cost lengthens the sub-window, so this is an upper
bound of the idle share of an unprofiled frame."""

from perfbench import tracefile


def read(ctx):
    if not ctx.device_events:
        return None
    return 1.0 - tracefile.busy_us(ctx.device_events) / ctx.window_us
