"""The whole step's share of the card's peak, in %: the model FLOPs of
all the work of the untraced window (``harness.flops``: convolutions and
dense layers; training counts forward and backward as 3 forwards, not
remat's re-forward) over its host-clock time and the H100's dense bf16
peak."""
from harness.bounds import BF16_PEAK_FLOPS


def read(run):
    w = run.window
    if not w["items"] or w["seconds"] <= 0:
        return None
    return 100.0 * w["flops"] / w["seconds"] / BF16_PEAK_FLOPS
