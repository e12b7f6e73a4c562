"""The control: the plain reference computed in bfloat16, put in the
program's place, has to come out not correct in every cell, at the
cell's own population size (the control's work does not depend on it)."""

import pytest
import torch

from harness import control, manifest

M = manifest.Manifest()


@pytest.mark.parametrize("seed", [2**31 + 5, 7_000_000_011])
@pytest.mark.parametrize("workload", sorted(M.workloads))
def test_control_reads_not_correct(workload, seed):
    cell = M.cell(workload)
    correct, checks = control.control(cell, seed, 512, torch.bfloat16)
    assert not correct
    assert checks["logz_mse_n"]["value"] > checks["logz_mse_n"]["limit"]


@pytest.mark.parametrize("workload", sorted(M.workloads))
def test_the_reference_in_its_own_precision_reads_zero(workload):
    cell = M.cell(workload)
    correct, checks = control.control(cell, 3, 512, torch.float64)
    assert correct
    assert checks["logz_mse_n"]["value"] < 1e-12 * cell.traffic["particles"]
