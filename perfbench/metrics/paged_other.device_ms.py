"""paged_other.device_ms (ms): device time per layer of every operation
the step runs besides the paged walk and its merge: the wrapper's copies
of the pools, the appends' writes, and the lengths' restore once a step."""


def read(trace, counts):
    names = counts["walk_kernels"] + counts["merge_kernels"]
    other_s = trace.op_seconds(lambda n: not any(k in n for k in names))
    if other_s <= 0.0:
        return None
    return other_s * 1e3 / (trace.steps * counts["calls_per_step"])
