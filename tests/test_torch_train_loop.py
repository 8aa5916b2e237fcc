"""The port's fault-tolerant ``Trainer`` (``repro_torch.runtime.train_loop``):
the reference's ``tests/test_fault_tolerance.py`` behaviours on the CPU,
exact resume bit for bit, and the first steps against the reference's
``Trainer`` on the same weights and batches."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as RefStore
from repro.models.config import ModelConfig as RefModelConfig
from repro.runtime.train_loop import Trainer as RefTrainer
from repro.runtime.train_loop import TrainLoopConfig as RefLoopConfig
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import MarkovLMData, SyntheticLMData
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import StepRecord, Trainer, TrainLoopConfig
from torch_parity import lm_port_model

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, head_dim=8, dtype="float32", remat=False, kv_chunk=16,
            pad_vocab_to=0)
CFG = ModelConfig(**TINY)


def trainer(tmp_path, data, name="run", **kw):
    opt = kw.pop("opt_cfg", None)
    hooks = {k: kw.pop(k) for k in ("failure_hook", "straggler_hook") if k in kw}
    return Trainer(CFG, data, CheckpointStore(tmp_path / name), TrainLoopConfig(**kw),
                   opt_cfg=opt, device="cpu", **hooks)


def falls(hist, by=0.1) -> tuple[float, float, bool]:
    first = np.mean([r.loss for r in hist[:5]])
    last = np.mean([r.loss for r in hist[-5:]])
    return first, last, last < first - by


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "compressed"])
def test_loss_falls_on_markov_data(tmp_path, compression):
    """30 steps at lr 1e-3 (the example's) on the bigram stream: the mean
    of the last 5 losses at least 0.1 under the first 5's, with and
    without int8 gradient compression."""
    data = MarkovLMData(CFG, global_batch=8, seq_len=32, branch=2)
    hist = trainer(tmp_path, data, total_steps=30, ckpt_every=50,
                   grad_compression=compression, opt_cfg=AdamWConfig(lr=1e-3)).run()
    first, last, ok = falls(hist)
    assert ok, (first, last)


def test_crash_and_exact_resume(tmp_path):
    """Kill the run at step 12; the resumed trainer's losses equal the
    uninterrupted run's bit for bit (checkpoint + replayable data), and
    so do its final parameters."""
    data = SyntheticLMData(CFG, global_batch=4, seq_len=16)
    ref = trainer(tmp_path, data, "a", total_steps=20, ckpt_every=5)
    ref_hist = ref.run()

    class Boom(RuntimeError):
        pass

    def fail_at_12(step):
        if step == 12:
            raise Boom()

    crashing = trainer(tmp_path, data, "b", total_steps=20, ckpt_every=5,
                       failure_hook=fail_at_12)
    with pytest.raises(Boom):
        crashing.run()
    assert crashing.store.latest_step() == 10  # the last periodic checkpoint survived
    resumed = trainer(tmp_path, data, "b", total_steps=20, ckpt_every=5)
    res_hist = resumed.run()
    assert res_hist[0].step == 10
    tail = {r.step: r.loss for r in ref_hist if r.step >= 10}
    assert [r.loss for r in res_hist] == [tail[r.step] for r in res_hist]
    for (k, a), (_, b) in zip(ref._final[0].state_dict().items(),
                              resumed._final[0].state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(ref._final[1]["mu"]["embed.table"], resumed._final[1]["mu"]["embed.table"])


def test_straggler_detection_fires(tmp_path):
    data = SyntheticLMData(CFG, global_batch=4, seq_len=16)
    seen = []
    trainer(tmp_path, data, total_steps=6, ckpt_every=100, step_deadline_s=0.0,
            straggler_hook=seen.append).run()
    assert len(seen) >= 5
    assert all(isinstance(r, StepRecord) and r.straggler for r in seen)


def test_failure_leaves_the_newest_checkpoint_intact(tmp_path):
    """A failure mid-run flushes the in-flight save (``finally``) and the
    store restores the last published step."""
    data = SyntheticLMData(CFG, global_batch=4, seq_len=16)

    def fail_at_7(step):
        if step == 7:
            raise RuntimeError("node lost")

    t = trainer(tmp_path, data, total_steps=20, ckpt_every=3, failure_hook=fail_at_7)
    with pytest.raises(RuntimeError, match="node lost"):
        t.run()
    assert t.store.steps()[-1] == 6 and t.store._pending is None
    params, opt, start = trainer(tmp_path, data, total_steps=20, ckpt_every=3).restore_or_init()
    assert start == 6 and int(opt["step"]) == 6


def test_trainer_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(CFG, SyntheticLMData(CFG, 4, 16), CheckpointStore(tmp_path))


class FixedBatches:
    """A data object serving the same numpy batches to both trainers."""

    def __init__(self, n=3, seed=5):
        rng = np.random.RandomState(seed)
        self.batches = []
        for _ in range(n):
            t = rng.randint(0, CFG.vocab, (4, 17)).astype(np.int32)
            self.batches.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})

    def batch_at(self, step):
        return self.batches[step]


class RefBatches(FixedBatches):
    def batch_at(self, step):
        return {k: jnp.asarray(v) for k, v in self.batches[step].items()}


def test_first_steps_match_the_reference_trainer(tmp_path):
    """Three steps of the reference's ``Trainer`` and the port's on the
    reference's initial weights (converted) and the same batches: the
    first loss within 1e-6 relative (the same model, ~17 u), the next two
    within 1e-5 (the reference resume test's bound): the updates agree to
    their float32 gradient tolerance, and the few whose sign is
    undetermined move the loss by O(lr x |g| x their share)."""
    rcfg = RefModelConfig(**TINY)
    ref = RefTrainer(rcfg, RefBatches(), RefStore(tmp_path / "ref"),
                     RefLoopConfig(total_steps=3, ckpt_every=10))
    ref_params = ref.init_state()[0]

    class Converted(Trainer):
        def init_state(self):
            params, opt, _ = super().init_state()
            return lm_port_model(CFG, ref_params), opt, 0

    port = Converted(CFG, FixedBatches(), CheckpointStore(tmp_path / "port"),
                     TrainLoopConfig(total_steps=3, ckpt_every=10), device="cpu")
    want = [r.loss for r in ref.run()]
    got = [r.loss for r in port.run()]
    assert math.isclose(got[0], want[0], rel_tol=1e-6), (got, want)
    for g, w in zip(got[1:], want[1:]):
        assert math.isclose(g, w, rel_tol=1e-5), (got, want)
