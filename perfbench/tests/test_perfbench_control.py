"""The control, at a size a test run holds: the reference one precision
below the configuration's (int4 books for the int8 Tab. VII cells, TF32
products for the fp32 NVSA cells, emulated alike on every device) put in
the program's place over a run's sample must fail a limit, where the
program over the same sample passes them all.  On the chip the control
runs at the cells' own sizes: ``python3 perfbench/control.py``."""
import pytest
import torch

from perfbench.tests.common import small_cell
from perfbench.bench import harness, judge


@pytest.mark.parametrize("name", ["tab7-int8.closed-256",
                                  "nvsa-raven.serve-256"])
def test_control_fails_where_the_program_passes(name):
    cell = small_cell(name)
    if name.startswith("nvsa"):
        cell.traffic.update(sample=12)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    system, win, _ = harness.measure(cell, 2 ** 31 + 77, 3.0, False,
                                     device=device, patience_s=60.0)
    limits = cell.config["limits"]
    sound, _ = harness.judged(cell, system, win, 2 ** 31 + 77)
    assert judge.passed(judge.checks(sound, limits)), sound
    ctrl, _ = harness.judged(cell, system, win, 2 ** 31 + 77,
                             fmt=cell.config["control"])
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl
