"""The port's example twins against the reference examples, on the CPU.

``examples/torch_quickstart.py`` and
``examples/torch_split_mobilenet_inference.py`` run with
``device="cpu"`` and print what ``examples/quickstart.py`` and
``examples/split_mobilenet_inference.py`` print: the planning lines
equal line for line (planner wall times masked), the hops' bytes,
packets and modeled latency too, and every top-1 check agrees."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    # host wall times of the planners differ from run to run
    return [re.sub(r"planner (took )?[0-9.]+ ?ms", "planner <wall> ms", line)
            for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("name,agreement", [
    ("quickstart", "split executes correctly: top-1 agreement = True"),
    ("split_mobilenet_inference", "top-1 agreement across batch: 100%"),
])
def test_twin_prints_the_reference_examples_lines(capsys, name, agreement):
    want = printed(capsys, load(name).main)
    got = printed(capsys, load(f"torch_{name}").main, "cpu")
    assert agreement in got and agreement in want
    assert len(got) == len(want) > 5
    assert got == want
