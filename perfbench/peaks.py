"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, SXM part, dense rates, at the full 700 W power limit), by the name
``torch.cuda.get_device_name()`` gives. A roofline share is stated against
these, with the card's power limit printed beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(device_kind: str, key: str):
    """The peak ``key`` of ``device_kind``, or None for a card not listed."""
    return PEAKS.get(device_kind, {}).get(key)
