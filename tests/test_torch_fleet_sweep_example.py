"""``examples/torch_fleet_sweep.py`` against ``examples/fleet_sweep.py``,
on the CPU.

The twin sweeps in float64 (the DP kernels' plain versions on
``device="cpu"``), which equals the numpy oracle the reference example
defaults to: every line it prints equals the reference's, the first
line's wall time and rate aside."""

from torch_parity import load_example, printed

WALLS = [(r"in [0-9.]+ ms \([0-9,]+ scenarios/s\)", "in <wall> ms (<rate> scenarios/s)")]


def test_twin_prints_the_reference_examples_lines(capsys):
    want, _ = printed(capsys, load_example("fleet_sweep").main, masks=WALLS)
    got, _ = printed(capsys, load_example("torch_fleet_sweep").main, "cpu", masks=WALLS)
    assert got[0].startswith("swept 768 scenarios in <wall> ms")
    assert any("contention × energy budget" in line for line in got)
    assert len(got) == len(want) > 30
    assert got == want
