"""The 99th percentile, over every request answered in the window, of the
time from its issue to its predictions being kept on the host, in ms
(numpy's linear percentile), on the host's clock: what the client that
waits for the verdicts sees, its own wake-ups and the collector's passes
included."""

import numpy as np


def read(r):
    if r.loop is None or not r.loop.latencies:
        return None
    return 1e3 * float(np.percentile(r.loop.latencies, 99))
