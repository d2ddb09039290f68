"""Host ms a frame in the ``frame.filter`` and ``frame.blend`` spans (the
nine a-trous launches; the temporal blend, the next history and the
re-modulation), self time less their waits. Layer: host
(pipeline/frame.py)."""

from perfbench import stages


def read(ctx):
    return stages.stage_host_ms(ctx, ("frame.filter", "frame.blend"))
