"""How unevenly the router loads the experts: in each MoE layer the
busiest expert's tokens over the mean tokens of an expert, averaged over
the layers (1 is even), from the program's counters (each expert's routed
tokens, summed in place over the requests), read once after the window;
nothing where the program keeps no such counters."""

import numpy as np


def read(r):
    tokens = r.counters.get("expert_tokens")
    if tokens is None or not np.asarray(tokens).size:
        return None
    t = np.asarray(tokens, np.float64)
    mean = t.mean(-1)
    if not (mean > 0).all():
        return None
    return float(np.mean(t.max(-1) / mean))
