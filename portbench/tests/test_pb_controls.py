"""The controls of ``correct``: the program's own W8A8 int8 path (the
control of a bfloat16 cell), the reference with every product of the DiT and
the vocoder in float8 e4m3 put in the program's place (the control of the
stages that int8 leaves in bfloat16, the vocoder among them) and the
reference with W4A4 block products (the control of a W8A8 cell).

On the CPU at a tiny size here, each reading far above the program's; at
each cell's own size on the card (``card``), each failing the cell's
committed limits through ``check.judge``, where ``portbench/calibrate.py``
gives the readings the limits are set from."""

import pytest
import torch

from portbench import calibrate, check, system
from portbench.spec import Bench
from portbench.tests import tiny


def _readings(root, workload, variants, seeds, device):
    bench = Bench(root)
    cell = bench.cell(workload)
    path = root / next(c["file"] for c in bench.doc["configs"] if c["name"] == cell.config_name)
    systems = {}
    return [calibrate.readings(cell, path, systems, s, variants, device) for s in seeds]


@pytest.mark.parametrize("quant,variant,keys", [
    (None, "reference-fp8", ("mel_rel_l2", "wave_rel_l2")),
    (None, "program-int8", ("mel_rel_l2",)),
    ("int8", "reference-int4", ("mel_rel_l2",))])
def test_control_reads_far_above_the_program_tiny(tmp_path, quant, variant, keys):
    torch.set_num_threads(4)
    root = tiny.make_root(tmp_path, quant=quant)
    got = _readings(root, tiny.CELL, ["program", variant], [3, 4], "cpu")
    prog, ctrl = [g["program"] for g in got], [g[variant] for g in got]
    for key in keys:
        assert min(c[key] for c in ctrl) > 3 * max(p[key] for p in prog), (prog, ctrl)


@pytest.mark.card
@pytest.mark.parametrize("workload,variant", [
    ("multilingual.single-1chunk", "program-int8"),
    ("multilingual.single-1chunk", "reference-fp8")])
def test_control_fails_the_limits_at_cell_size(cuda, workload, variant):
    cell = Bench(tiny.REPO).cell(workload)
    system.build_kernels(cuda)
    for got in _readings(tiny.REPO, workload, [variant], [101, 102, 103], cuda):
        ok, checks = check.judge(dict(got[variant], failed_requests=0.0), cell.limits)
        assert not ok, checks
