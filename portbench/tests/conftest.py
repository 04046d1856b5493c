"""The harness's tests run on one intra-op thread: their cells are served
on the CPU at small sizes, whose products are too small to share, and on
a loaded host every parallel region waits for threads the scheduler has
not run (a card-less DeepSeek-V3 request took 30-50 s with the default
threads under a full test run, against a few seconds on one)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
