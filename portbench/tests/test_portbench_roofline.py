"""The roofline arithmetic pinned to PERF.md's kernel table ("bound ms",
bytes over 3.35 TB/s) at the shapes given there. The data-dependent counts
the table does not print (decision-table entries a batch touches, columns
a window names and register words it changes) are ones that give the
table's rounded bound."""

import pytest

from portbench import roofline


def _ms(work):
    return round(1e3 * roofline.least_s(*work), 7)


def test_peaks_are_the_h100_data_sheets():
    assert roofline.HBM == 3.35e12 and roofline.FP32 == 67e12
    assert roofline.PEAKS["power_limit_w"] == 700


def test_b1_at_the_serve_shape():
    # N=2048, F=5, U=39, T=10, Co=2 (select='matmul'), ~490 entries
    assert _ms(roofline.b1_work(2048, 5, 39, 10, 2, 486)) == 0.0000209


def test_b5_on_the_served_window():
    # N=8192 buckets, W=1024 lanes, all valid
    assert _ms(roofline.b5_work(8192, 1024, 1024, 200, 800)) == 0.0000751


def test_b6_sweep_with_73_evicted():
    assert _ms(roofline.b6_work(8192, 1024, 1024, 73)) == 0.0000218


@pytest.mark.parametrize("work", [roofline.b1_work(2048, 5, 39, 10, 2, 486),
                                  roofline.b5_work(8192, 1024, 1024, 200, 800),
                                  roofline.b6_work(8192, 1024, 1024, 73)])
def test_the_kernels_are_bound_by_bytes(work):
    n_bytes, ops = work
    assert n_bytes / roofline.HBM > ops / roofline.FP32


def test_the_walk_and_the_total():
    rows, f, t, d, c = 64, 8, 16, 6, 2
    n_bytes, ops = roofline.walk_work(rows, f, t, d, c)
    assert n_bytes == 4 * (rows * f + t * 63 * 2 + t * 64 * c + rows)
    assert ops == rows * t * (d + c)
    assert roofline.total((1, 2), (3, 4)) == (4, 6)
