"""The register fold B5 (``csrc/stream_update.cu``): its least time a
launch over its mean device time a launch in the traced slice, in
percent."""

from portbench.harness import kernel_share


def read(r):
    return kernel_share(r, "b5", "stream_update_kernel")
