"""paged_host.us (us): the median host time of one layer's appends and
attention call, on the host clock with no synchronize, over every layer of
every step of the measured window (not the profiled one)."""

import statistics


def read(trace, counts):
    host = counts["host_call_us"]
    return statistics.median(host) if host else None
