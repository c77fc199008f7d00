"""Model FLOPs of the clips served in the window (the reference's forward
at the request's shapes, counted on the meta device) over the window's
seconds times the card's bf16 dense peak times the cards, in %."""

from portbench.costs.kernels import PEAKS


def read(record):
    if "flops_per_clip" not in record:
        return None
    peak = PEAKS["bf16_flops_per_s"] * record["chips"] * record["window_s"]
    return 100.0 * record["flops_per_clip"] * record["clips"] / peak
