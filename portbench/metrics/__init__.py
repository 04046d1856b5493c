"""One reader a per-layer metric, found by the metric's name: ``read(r)``
takes ``harness.Readings`` and returns the value, or None where it finds
nothing to read."""
