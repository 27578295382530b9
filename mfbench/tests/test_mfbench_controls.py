"""The controls fail the output check, at each cell's size, on the card.

The reference in the next precision below the configuration's, put in the
program's place, must read ``correct`` false on three seeds, while the
program reads true on them.  Needs a CUDA card (the ``cuda`` marker; skips
without one): ``python -m pytest --noconftest -m cuda
mfbench/tests/test_mfbench_controls.py`` on the card's machine.
"""

import pytest

# (cell, seconds, window): the SLAM window ends once the frames that a
# 30-second run checks have run
CELLS = [("slam_two_objects", 30.0, 16.0), ("train_b8_1024", 3.0, None)]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cell's size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell, seconds, window", CELLS)
def test_control_fails_where_the_program_passes(card, cell, seconds, window):
    from mfbench.tests import controls

    seeds = [2 ** 33 + 101, 2 ** 33 + 202, 2 ** 33 + 303]
    for r in controls.readings(cell, seeds, seconds, window=window):
        assert r["program_correct"], r
        assert not r["control_passes"], r
