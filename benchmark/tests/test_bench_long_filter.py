"""The published 100-tap filters on the 32-loudspeaker array (the cell
``s32-j100-x1``, JL = 3200) on the card: the program is correct over a
short window, and the comparison fails it with TF32 products (the
precision below the configuration's float32) and with either of the
solver's faults planted in the graphed hop (``harness/faults.py``). The
same scene's CPU counterpart, small, is ``tests/test_torch_long_filter.py``.

    python -m pytest -m cuda benchmark/tests/test_bench_long_filter.py -q
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import run  # noqa: E402
from harness import spec  # noqa: E402

SEED = 2**31 + 1979


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest -m cuda benchmark/tests)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("control", [None, "tf32", "k4_no_sweeps", "tracker_stalled"])
def test_long_filter_cell_on_the_card(card, control):
    cell = spec.load_cell("s32-j100-x1")
    assert cell.config["scene"]["filter_length"] == 100
    out = run.run_cell(cell, SEED, 5.0, False, card, control, t_process=0.0)
    assert out["verdict"]["judged"]
    assert out["verdict"]["correct"] is (control is None), out["verdict"]["compared"]
