"""The whole request step's share of the card's peak: the least time its
work needs (the larger of its operations over the float32 rate and its
bytes over the memory rate, ``portbench.roofline``), over the window's
time a request, in percent."""


def read(r):
    if not r.least_s_per_request or not r.window_s_per_request:
        return None
    return 100.0 * r.least_s_per_request / r.window_s_per_request
