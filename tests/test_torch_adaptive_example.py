"""``examples/torch_adaptive_replanning.py`` against
``examples/adaptive_replanning.py``, on the CPU.

The twin's managers build and re-solve in float64 (the DP kernels' plain
versions on ``device="cpu"``), which equals the numpy oracle the
reference example defaults to: the surface, every decision-log line and
the stale-while-revalidate act equal the reference's, the build and
observe walls aside."""

from torch_parity import load_example, printed

WALLS = [(r"built in [0-9]+ ms", "built in <wall> ms"),
         (r"\[[0-9]+ us/observe\]", "[<wall> us/observe]")]


def test_twin_prints_the_reference_examples_lines(capsys):
    want, _ = printed(capsys, load_example("adaptive_replanning").main, masks=WALLS)
    got, _ = printed(capsys, load_example("torch_adaptive_replanning").main, "cpu",
                     masks=WALLS)
    log = got.index("decision log:")
    # the collapse ends in a protocol switch; act two adopts a rebuild
    assert got[log + 2].startswith("  step   92: udp ")
    assert got[-1].startswith("adopted 2 rebuilt surface(s)")
    assert len(got) == len(want) > 10
    assert got == want
