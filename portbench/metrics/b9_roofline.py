"""The grouped expert GEMM B9 (``csrc/grouped_gemm.cu``, both its launches:
gate_up and down): its least time a launch (``portbench/lm_roofline.py``:
the products at the bf16 tensor rate, above the bytes over the memory
rate) over its mean device time a launch in the traced slice, in
percent."""

from portbench.harness import kernel_share


def read(r):
    return kernel_share(r, "b9", "grouped_gemm_kernel")
