"""The traffic laws. A mix (``portbench/traffic/<mix>.json``) names its law
under ``"law"``; the law is the module of that name in this package, found
by ``find``. A mix with a law of its own adds one module here and changes
no file.

What a law returns depends on the kind of cell that reads it:

* a record law has ``rows(rng, mix, n) -> (x (n, F) f32, y (n,) i32)``;
* a packet law has ``packets(rngs, mix) -> dict``: the per-packet columns
  ``PACKET_FIELDS`` sorted by ``ts``, and ``flow_label`` a flow, drawn
  from the independent generators ``rngs`` (``STREAMS`` of them).

The laws are copies of the program's own generators, so that a change to
the program cannot move the yardstick.
"""

from __future__ import annotations

import importlib

import numpy as np

PACKET_FIELDS = ("ts", "src_ip", "dst_ip", "sport", "dport", "proto",
                 "length", "direction", "flow_id")
STREAMS = 2          # the generators a packet law may draw from


def streams(seed: int, n: int) -> list:
    """``n`` independent generators from one seed (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


def find(mix: dict):
    """The module of the mix's law."""
    return importlib.import_module(f"portbench.laws.{mix['law']}")
