"""The check that decides ``correct``, driven end to end at a tiny size on the
CPU (the look for a card skipped): the frozen reference agrees with the
port's plain path; the timed path broken underneath makes ``correct`` false
under the cells' limits; the control (the reference in float8 in the
program's place) reads past them."""
import math

import pytest
import torch

from perfbench import control, harness
from perfbench.runners import synth, train
from perfbench.tests import tiny

CELLS = {"nollm_train": ("speech_nollm", "finetune_recipe", train),
         "e2e_synth_mixed": ("speech_e2e", "corpus_mixed16", synth),
         "nollm_synth_mixed": ("speech_nollm", "corpus_mixed16", synth)}
# the port in f32 against the f32 reference on the CPU: only the order of sums differs
PLAIN_TOL = 1e-4


def _run(cell, fault=None):
    cfg, mix, runner = CELLS[cell]
    torch.manual_seed(0)
    ctx = tiny.context(cfg, mix, limits=harness.limits_of(tiny.ROOT, cell))
    ctx.fault = fault
    return ctx, runner.run(ctx)


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_matches_the_port_plain_path(cell):
    ctx, out = _run(cell)
    assert out.compared and all(v <= PLAIN_TOL for v in out.compared.values()), out.compared
    assert harness.judge(out.compared, ctx.limits)
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("cell, fault", [
    ("nollm_train", "no_update"),
    ("nollm_train", "half_batch"),
    ("e2e_synth_mixed", "altered"),
    ("nollm_synth_mixed", "altered"),
])
def test_a_broken_path_is_not_correct(cell, fault):
    ctx, out = _run(cell, fault)
    assert not harness.judge(out.compared, ctx.limits), out.compared


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_reads_far_above_the_program(cell):
    """The control (the reference in float8 e4m3 in the program's place)
    reads some number at three times the program's largest or more, on
    every seed; at the cell's own size its readings set the limits."""
    cfg, mix, _ = CELLS[cell]
    ctx = tiny.context(cfg, mix)
    limits = harness.limits_of(tiny.ROOT, cell)
    rows = control.readings(ctx, [11, 12], {11, 12}, faults=())
    sound = [r for r in rows if r["kind"] == "sound"]
    ctrl = [r for r in rows if r["kind"] == "control_fp8"]
    assert len(ctrl) == 2
    top = {k: max(r[k] for r in sound) for k in limits}
    for r in sound:
        assert all(r[k] <= limits[k] for k in limits)
    for r in ctrl:
        assert any(r[k] >= max(3 * top[k], 1e-3) or not math.isfinite(r[k]) for k in limits), r
