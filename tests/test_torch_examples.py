"""The port's example twins against the reference examples, on the CPU.

``examples/torch_quickstart.py`` and
``examples/torch_split_mobilenet_inference.py`` run with
``device="cpu"`` and print what ``examples/quickstart.py`` and
``examples/split_mobilenet_inference.py`` print: the planning lines
equal line for line (planner wall times masked), the hops' bytes,
packets and modeled latency too, and every top-1 check agrees."""

import pytest

from torch_parity import load_example as load
from torch_parity import printed

# host wall times of the planners differ from run to run
WALLS = [(r"planner (took )?[0-9.]+ ?ms", "planner <wall> ms")]


@pytest.mark.parametrize("name,agreement", [
    ("quickstart", "split executes correctly: top-1 agreement = True"),
    ("split_mobilenet_inference", "top-1 agreement across batch: 100%"),
])
def test_twin_prints_the_reference_examples_lines(capsys, name, agreement):
    want, _ = printed(capsys, load(name).main, masks=WALLS)
    got, _ = printed(capsys, load(f"torch_{name}").main, "cpu", masks=WALLS)
    assert agreement in got and agreement in want
    assert len(got) == len(want) > 5
    assert got == want
