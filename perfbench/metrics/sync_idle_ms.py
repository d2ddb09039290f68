"""Device idle ms a frame in the gaps that open while the host is inside a
wait of a ``frame`` span (``host_syncs_per_frame``'s calls): the card ran
dry because the frame waited for it. Layer: host (pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.idle_ms(ctx, "sync")
