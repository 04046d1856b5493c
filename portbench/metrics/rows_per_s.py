"""Rows (flow records or packets) whose final predictions reached the host
inside the window, over the window's seconds."""


def read(r):
    if r.loop is None or not r.loop.completed:
        return None
    return r.loop.completed * r.rows_per_request / r.loop.seconds
