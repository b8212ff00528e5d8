"""The control: the reference computed in TF32 (the nearest precision
below the configuration's float32 with TF32 off) in the port's place has
to come out not correct, on each cell's own shapes and window, on the
card (the window reaches the frames the check samples and the polishes)."""

import json

import pytest

from benchmark.harness import Bench, main

CELLS = [("euroc_mav.stream", "50")]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seconds", CELLS, ids=[c for c, _ in CELLS])
def test_control_is_not_correct(cuda, capsys, cell, seconds):
    bench = Bench.load()
    rc = main(["--workload", cell, "--seed", "2147483659", "--seconds", seconds, "--trace", "0",
               "--control"], 0.0, bench=bench)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
