"""The timeout sweep B6 (``csrc/evict.cu``, its sweep entry): its least
time a launch over its mean device time a launch in the traced slice, in
percent."""

from portbench.harness import kernel_share


def read(r):
    return kernel_share(r, "b6", "evict_sweep_kernel")
