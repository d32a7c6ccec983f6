"""The split workspace of the port's CUDA kernels
(``repro_torch/kernels/workspace.py``), shared by ``rns_matmul`` and the
fused dot and matmul + normalize: its growth rule, its keying by device
and stream, and the rule that no buffer it handed out is ever freed (a
CUDA graph keeps the addresses it captured).  The logic is plain Python
and runs on the CPU; ``tests/test_torch_fused.py`` captures, grows and
replays on the card."""

import pytest
import torch

from repro_torch.kernels import workspace
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(workspace, "_held", {})


@pytest.mark.parametrize("have,need,want", [
    (None, (5, 3), (8, 4)),              # first pair: powers of two
    (None, (1, 1), (1, 1)),
    ((8, 4), (5, 3), None),              # fits: no new pair
    ((8, 4), (8, 4), None),
    ((8, 4), (9, 3), (16, 4)),           # never smaller than the old one
    ((8, 4), (1, 5), (8, 8)),
    ((1024, 2), (1025, 2), (2048, 2)),
])
def test_grow_rule(have, need, want):
    assert workspace.grow(have, *need) == want


def test_growing_keeps_every_pair_alive():
    """A larger call gets a new pair; the old pair stays held, the same
    tensors at the same addresses, so a graph that captured it still
    writes into memory nothing else owns."""
    first = workspace.get("cpu", 100, 3, stream=7)
    ptrs = (first[0].data_ptr(), first[1].data_ptr())
    assert workspace.get("cpu", 90, 2, stream=7) is first    # fits
    second = workspace.get("cpu", 1000, 3, stream=7)
    assert second is not first and second[0].numel() >= 1000
    held = workspace.held("cpu", 7)
    assert [p is q for p, q in zip(held, (first, second))] == [True, True]
    assert (held[0][0].data_ptr(), held[0][1].data_ptr()) == ptrs
    assert workspace.get("cpu", 10, 1, stream=7) is second   # the largest


def test_streams_never_share_a_pair():
    a = workspace.get("cpu", 64, 4, stream=1)
    b = workspace.get("cpu", 64, 4, stream=2)
    assert a is not b
    assert a[0].data_ptr() != b[0].data_ptr()
    assert a[1].data_ptr() != b[1].data_ptr()
    assert workspace.held("cpu", 1) == [a] and workspace.held("cpu", 2) == [b]


def test_counters_start_at_zero_and_sums_are_int32():
    sums, counters = workspace.get("cpu", 33, 17, stream=0)
    assert sums.dtype == counters.dtype == torch.int32
    assert counters.numel() == 32 and not counters.any()
    assert sums.numel() == 64


def test_cpu_key_defaults_to_stream_zero():
    pair = workspace.get(torch.device("cpu"), 4, 1)
    assert workspace.held("cpu", 0) == [pair]
