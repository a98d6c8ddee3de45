"""device.idle (%): the share of the profiled window in which no operation
ran on the device (the union of the device operations' intervals)."""


def read(trace, counts):
    if trace.window_s <= 0.0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
