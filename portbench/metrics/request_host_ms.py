"""Host time inside the program's entry (``HybridServer.classify``,
``StreamingHybridServer.step_chunk``), mean over the window's requests,
in ms: the benchmark's own span around the call."""


def read(r):
    if not r.call_s:
        return None
    return 1e3 * sum(r.call_s) / len(r.call_s)
