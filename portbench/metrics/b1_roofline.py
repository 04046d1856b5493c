"""The switch kernel B1 (``csrc/ensemble_lookup.cu``, through
``kernels/ops.fused_classify``): its least time a launch (bytes over the
memory rate, above operations over the float32 rate) over its mean device
time a launch in the traced slice, in percent."""

from portbench.harness import kernel_share


def read(r):
    return kernel_share(r, "b1", "ensemble_lookup_kernel")
