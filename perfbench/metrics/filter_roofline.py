"""The filter stage's share of its roofline, in %: the least time the card
could take for the stage over its device ms a frame (``filter_ms``).

The least time is the bytes the whole stage must move over the card's HBM
rate. It counts, from the frame's shapes, every plane the stage reads once
(the noisy colour, normals, depth and, variance-guided, the variance; the
blend's history image, backprojected row and column, temporal gradient and,
under the ramp, the history age and both consistency planes) and every
plane it writes once (the displayed image, which is the next history, and
under the ramp the age). Intermediate planes between the nine iterations
are not counted, so the count is the same however many kernels implement
the stage. All planes are 4-byte floats or ints."""

from perfbench import peaks

PREFIXES = ("atrous_iter", "temporal_blend")


def stage_bytes(cfg: dict) -> int:
    """Bytes the filter stage and the blend must move a frame."""
    per_pixel = 3 + 3 + 1          # noisy colour, normal, depth
    per_pixel += 3 + 1 + 1 + 1     # history image, prev_y, prev_x, lambda
    per_pixel += 3                 # the blended image written
    if cfg.get("variance_guided"):
        per_pixel += 1             # the variance read
    if cfg.get("accumulation_ramp"):
        per_pixel += 3 + 1         # age, previous and current consistency; age written
    return 4 * per_pixel * cfg["width"] * cfg["height"]


def read(ctx):
    ms = ctx.family_ms(lambda name: name.startswith(PREFIXES))
    rate = peaks.peak(ctx.device_kind, "hbm_bytes_per_s")
    if ms is None or rate is None:
        return None
    return 100.0 * (stage_bytes(ctx.cfg) / rate * 1e3) / ms
