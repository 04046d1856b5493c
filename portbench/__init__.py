"""The port's benchmark: one cell of BENCHMARK.json run once.

Everything here is the yardstick: traffic generation, the plain reference,
the comparison that decides ``correct``, the roofline arithmetic and the
readers of the per-layer metrics. From the program (``repro_torch``) it
takes only the system under test.
"""
