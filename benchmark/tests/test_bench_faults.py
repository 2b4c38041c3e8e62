"""The check that decides `correct`, at a small size on the CPU: a run with
its timed path broken underneath comes out not correct, once for each fault
the cell can have, and the control (the reference one precision down) reads
far above the program."""

import pytest
import torch

from benchmark import run as R
from benchmark.lib import registry
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_dialog_token_altered_is_not_correct():
    line = R.run_cell(tiny.cell("s2s.dialog-c32"), 5, 2.0, False, "cpu", fault="token")
    assert line["correct"] is False
    assert line["checks"]["served_logit_gap"]["value"] > line["checks"]["served_logit_gap"]["limit"]


@pytest.mark.parametrize("cell", ["lm.sft-8k", "lm.lora-8k"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_not_correct(cell, fault):
    line = R.run_cell(tiny.cell(cell), 5, 0.5, False, "cpu", fault=fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["s2s.dialog-c32", "lm.sft-8k", "lm.lora-8k"])
def test_sound_run_is_correct(cell):
    line = R.run_cell(tiny.cell(cell), 9, 1.0, False, "cpu")
    assert line["correct"] is True, line["checks"]


def test_dialog_control_reads_far_above_the_program():
    cell = tiny.cell("s2s.dialog-c32")
    drv = registry.driver("dialog")
    res = drv.run(cell, 13, 2.0, False, torch.device("cpu"), R.T_START, control=True)
    program = res["checks"]["served_logit_gap"]["value"]
    assert drv.check.worst["control_gap"] >= 3 * program
    assert drv.check.worst["control_gap"] > 0


@pytest.mark.parametrize("cell", ["lm.sft-8k", "lm.lora-8k"])
def test_training_control_reads_far_above_the_program(cell):
    from benchmark import calibrate

    c = tiny.cell(cell)
    line = R.run_cell(c, 17, 0.5, False, "cpu")
    ctl = calibrate.train_controls(c, 17, torch.device("cpu"))["control_fp8"]
    assert any(ctl[k] >= 3 * line["checks"][k]["value"] for k in ctl if k in line["checks"])


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = R.run_cell(registry.find_cell(registry.load_spec(), "lm.lora-8k"), 3, 2.0, False,
                      "cuda:0")
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
