"""paged_decode_roofline (%): the least time one absorbed-MLA decode call
can take, the larger of its operations at the bf16 peak and its bytes at
HBM's peak (``roofline.latent_decode_counts``: the latent row read once,
q and o), over the device time per call of the paged walk and its merge."""

from perfbench.roofline import bound_ms


def read(trace, counts):
    names = counts["walk_kernels"] + counts["merge_kernels"]
    walk_s = trace.op_seconds(lambda n: any(k in n for k in counts["walk_kernels"]))
    if walk_s <= 0.0:
        return None
    calls = trace.steps * counts["calls_per_step"]
    per_call_ms = trace.op_seconds(lambda n: any(k in n for k in names)) * 1e3 / calls
    least_ms, _ = bound_ms(counts["flops_per_call"], counts["bytes_per_call"])
    return 100.0 * least_ms / per_call_ms
