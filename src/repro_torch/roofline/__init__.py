"""Roofline analysis of the dry run's per-device step records."""

from repro_torch.roofline.analysis import (HW, collective_bytes_from_ops,
                                           model_flops, roofline_terms)

__all__ = ["HW", "collective_bytes_from_ops", "model_flops",
           "roofline_terms"]
