"""The check fails what it must: the control (the reference in the
program's place, in TF32) and each fault a cell can have, planted under a
run driven end to end on the CPU at a small size; sound runs pass on a few
seeds. ``calibrate.py`` reads the same on the card at the cells' size."""

import pytest

from perfbench import control, registry

from test_perfbench_result import BENCH, small_run

CELLS = [c["name"] for c in BENCH["workloads"]]


def cases():
    for name in CELLS:
        cell = registry.workload(BENCH, name)
        settings = registry.traffic(cell["traffic"])["render"]
        for fault in control.faults_of(settings):
            yield name, fault


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_pass(name):
    for seed in (1, 2**40):
        assert small_run(name, False, seed=seed)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    result = small_run(name, False, program=control.ReferenceProgram)
    assert result["correct"] is False
    assert result["checks"]["frames_max_abs"]["value"] > 0


@pytest.mark.parametrize("name,fault", list(cases()))
def test_faults_fail(name, fault):
    result = small_run(name, False, program=control.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, 3.1415927])
    y = control.tf32_round(x)
    assert y.tolist()[:3] == [1.0, 1.0, 1.0 + 2**-9]
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
