"""The device's idle share of the measured window, in percent: one less
the device's busy time a request (kernels, copies and fills, their union,
in the traced slice, over its requests) times the window's requests, over
the window. The slice's own wall time is not used: the profiler slows the
host's side of each request, not the device's."""


def read(r):
    if r.trace is None or r.loop is None or not r.loop.completed:
        return None
    busy = r.trace["busy_s"] / r.trace["requests"] * r.loop.completed
    return 100.0 * (1.0 - busy / r.loop.seconds)
