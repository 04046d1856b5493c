"""Rows the backend answered over all rows served, in percent: the
program's own counters (``HybridStats`` / ``StreamStats``), read once
after the window."""


def read(r):
    rows = r.counters.get("rows")
    if not rows:
        return None
    return 100.0 * r.counters["backend_rows"] / rows
