"""The control of ``correct``: the reference in the program's place, one
precision lower (bf16 colour arithmetic, fp8 net products), must fail the
limits.  On the CPU at the tiny cells' size; on a card (marked ``cuda``)
at each benchmark cell's own size.

    python -m pytest perfbench/tests -q
    python -m pytest perfbench/tests -q -m cuda   # on a card
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, control, spec  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

CELLS = ("shell800.orbit", "shell800.fast05", "shell800.classic")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    tiny.make(path)
    return path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_control_fails_the_tiny_cells(root, mix):
    cell = spec.cell(f"tiny.{mix}", root)
    for r in control.readings(cell.name, (1, 2, 3), 1, root=root,
                              device=torch.device("cpu")):
        ok, judged = check.verdict(r, cell.limits)
        assert not ok, judged


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_each_cell_at_its_size(card, name):
    cell = spec.cell(name, ROOT)
    (r,) = control.readings(name, (101,), 1, device=card)
    ok, judged = check.verdict(r, cell.limits)
    assert not ok, judged
