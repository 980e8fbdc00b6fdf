"""``ConcatDataset`` and ``MixConcatDataset`` in the port against
``eop_tpu``'s, on toy datasets that record what they were asked: the same
items for every index (negative ones too), the same errors, ``pull_item``
and ``input_dim`` passed through, and the batch samplers' ``(mosaic,
index, ...)`` tuples handed to the member with its own index."""

import pytest
import torch

from eop_tpu.data import datasets_wrapper as jdw
from eop_tpu_torch.data import datasets_wrapper as dw


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(base, name: str, n: int, dim=(32, 48)):
    """A dataset of ``n`` items on ``base``'s ``Dataset``: ``__getitem__``
    answers what it was given and its mosaic flag, ``pull_item`` its
    index."""

    class Toy(base):
        def __init__(self):
            super().__init__(dim)

        def __len__(self):
            return n

        @base.mosaic_getitem
        def __getitem__(self, index):
            return (name, index, self.enable_mosaic)

        def pull_item(self, index):
            return ("pull", name, index)

    return Toy()


def pair(kind: str):
    """The port's and eop_tpu's concatenation of three toys (3, 1, 4)."""
    sizes = (("a", 3, (32, 48)), ("b", 1, (64, 64)), ("c", 4, (16, 16)))
    return (getattr(dw, kind)([toy(dw.Dataset, *s) for s in sizes]),
            getattr(jdw, kind)([toy(jdw.Dataset, *s) for s in sizes]))


@pytest.mark.parametrize("kind", ["ConcatDataset", "MixConcatDataset"])
def test_indices_items_and_pull_item_equal_eop_tpu(kind):
    port, ref = pair(kind)
    assert len(port) == len(ref) == 8
    assert port.cumulative_sizes == ref.cumulative_sizes == [3, 4, 8]
    assert port.input_dim == ref.input_dim == (32, 48)
    for i in range(-8, 8):
        assert port[i] == ref[i], i
        assert port.pull_item(i) == ref.pull_item(i), i
    assert port[-5] == ("b", 0, True) and port.pull_item(7) == ("pull", "c",
                                                               3)
    for bad in (-9, -20):
        with pytest.raises(ValueError, match="should not exceed"):
            port[bad]
        with pytest.raises(ValueError, match="should not exceed"):
            ref[bad]
    assert isinstance(port, torch.utils.data.Dataset)


def test_mix_concat_takes_the_samplers_tuples():
    """``(mosaic, index, ...)`` reaches the member as ``(mosaic, its own
    index, ...)``: the flag is set there, as eop_tpu sets it."""
    port, ref = pair("MixConcatDataset")
    for index in [(False, 0), (True, 3), (False, 5), (True, -1),
                  (False, 7)]:
        assert port[index] == ref[index], index
    assert port[(False, 4)] == ("c", 0, False)
    assert port.datasets[2].enable_mosaic is False
    assert port[(True, 4)] == ("c", 0, True)
    # extra tuple members are handed on: a member that reads them sees them
    seen = []

    class Extra(dw.Dataset):
        def __len__(self):
            return 2

        def __getitem__(self, index):
            seen.append(index)
            return index

    mix = dw.MixConcatDataset([toy(dw.Dataset, "a", 3), Extra((8, 8))])
    assert mix[(True, 4, "x")] == (True, 1, "x") and seen == [(True, 1, "x")]


def test_empty_concat_raises():
    with pytest.raises(AssertionError, match="should not be empty"):
        dw.ConcatDataset([])
