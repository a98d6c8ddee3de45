"""step_mfu (%): the step's attention operations (every layer's, as the
roofline counts them) over the profiled window's time per step at the
card's bf16 peak."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(trace, counts):
    if trace.steps <= 0 or trace.window_s <= 0.0:
        return None
    step_s = trace.window_s / trace.steps
    flops = counts["flops_per_call"] * counts["calls_per_step"]
    return 100.0 * flops / (step_s * PEAK_BF16_FLOPS)
