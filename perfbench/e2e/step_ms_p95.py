"""step_ms_p95: the 95th percentile of every step's time in the window, on
the host's clock: from the step's first call to the return of the
synchronize that ends it, as a serving step ends with the sampled token on
the host. Steps follow each other with no gap, so the window is their sum."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.step_ms, dtype=np.float64), 95))
