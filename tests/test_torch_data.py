"""The port's synthetic training data (``repro_torch.data.pipeline``)
against the reference's contract (``repro.data.pipeline``).

The port draws its streams from a seeded ``torch.Generator``, not the
reference's threefry, so tokens differ by design; what must match is
the contract: a pure function of (seed, step), labels the stream shifted
by one, the microbatched layout, the reference's shapes and types for
every frontend, and the Markov stream's bigram structure."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.pipeline import MarkovLMData as RefMarkov
from repro.data.pipeline import SyntheticLMData as RefData
from repro_torch.configs import get_config
from repro_torch.data.pipeline import MarkovLMData, SyntheticLMData, host_generator
from repro_torch.models.config import ModelConfig

CFG = ModelConfig("tiny", "dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=64, vocab=64, head_dim=8, dtype="float32", remat=False,
                  kv_chunk=16, pad_vocab_to=0)


def test_deterministic_and_index_addressable():
    a, b = SyntheticLMData(CFG, 4, 16, seed=7), SyntheticLMData(CFG, 4, 16, seed=7)
    assert torch.equal(a.batch_at(13)["tokens"], b.batch_at(13)["tokens"])
    stream = iter(a)
    for step in range(3):
        assert torch.equal(next(stream)["tokens"], a.batch_at(step)["tokens"])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    assert not torch.equal(a.batch_at(0)["tokens"],
                           SyntheticLMData(CFG, 4, 16, seed=8).batch_at(0)["tokens"])


def test_labels_are_the_stream_shifted_by_one():
    for data in (SyntheticLMData(CFG, 4, 16), MarkovLMData(CFG, 4, 16)):
        b = data.batch_at(3)
        assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])


def test_microbatched_layout():
    cfg = replace(CFG, train_microbatches=2)
    assert SyntheticLMData(cfg, 4, 8).batch_at(0)["tokens"].shape == (2, 2, 8)
    assert MarkovLMData(cfg, 4, 8).batch_at(0)["tokens"].shape == (2, 2, 8)
    with pytest.raises(ValueError, match="microbatches"):
        SyntheticLMData(cfg, 3, 8).batch_at(0)


@pytest.mark.parametrize("arch", ["deepseek-7b", "musicgen-medium", "qwen2-vl-72b"])
@pytest.mark.parametrize("n", [1, 2])
def test_shapes_and_types_are_the_references(arch, n):
    """tokens, codes and embeds with (3, B, S) positions, plain and
    microbatched: every key, shape and type of the reference's batch."""
    cfg = replace(get_config(arch).reduced(), train_microbatches=n)
    rcfg = replace(ref_config(arch).reduced(), train_microbatches=n)
    got = SyntheticLMData(cfg, 4, 12, seed=3).batch_at(5)
    want = RefData(rcfg, 4, 12, seed=3).batch_at(5)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    if "positions" in got:
        pos = got["positions"].reshape(-1, 12)
        assert torch.equal(pos, torch.arange(12, dtype=torch.int32).expand_as(pos))


def test_markov_stream_follows_its_bigram_table():
    """Every transition is one of the token's ``branch`` successors (the
    table drawn from the seed), the successor sets are small, and the
    reference's test property holds: pairs repeat far more than chance."""
    data = MarkovLMData(CFG, global_batch=8, seq_len=32, branch=2, seed=4)
    table = torch.randint(0, CFG.vocab, (CFG.vocab, 2), generator=host_generator(4 ^ 0x5EED))
    b = data.batch_at(1)
    stream = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    prev, nxt = stream[:, :-1].long(), stream[:, 1:].long()
    assert ((table[prev] == nxt[..., None]).any(-1)).all()
    succ = {}
    for p, q in zip(prev.flatten().tolist(), nxt.flatten().tolist()):
        succ.setdefault(p, set()).add(q)
    assert max(len(s) for s in succ.values()) <= 2
    toks = data.batch_at(1)["tokens"].flatten().numpy()
    pairs = set(zip(toks[:-1], toks[1:]))
    assert len(pairs) < 0.9 * (len(toks) - 1)
    ref = RefMarkov(replace(ref_config("deepseek-7b").reduced(), vocab=64), 8, 32, branch=2)
    assert ref.batch_at(1)["tokens"].shape == tuple(data.batch_at(1)["tokens"].shape)


def test_markov_refuses_other_frontends():
    with pytest.raises(ValueError, match="token LMs"):
        MarkovLMData(get_config("musicgen-medium").reduced(), 2, 8).batch_at(0)


def test_streams_are_drawn_on_the_host():
    """A batch is a CPU tensor whatever devices exist: the step moves it."""
    b = SyntheticLMData(CFG, 2, 8).batch_at(0)
    assert all(t.device.type == "cpu" for t in b.values())
    assert np.asarray(b["tokens"]).dtype == np.int32
