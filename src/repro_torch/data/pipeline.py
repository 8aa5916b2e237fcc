"""Deterministic synthetic data pipeline (resumable): the reference's
``repro.data.pipeline`` in PyTorch.

Every batch is a pure function of ``(seed, step)``, the property that
makes checkpoint restart exact: resuming at step k regenerates the same
remaining stream with no iterator state to persist. A real deployment
swaps :class:`SyntheticLMData` for a file-backed loader with the same
``batch_at(step)`` contract.

The streams are drawn on the host with a ``torch.Generator`` seeded from
``(seed, step)`` (``numpy.random.SeedSequence``), so they are not the
reference's threefry draws: the two packages give different tokens for
the same seed. Shapes, types and layout are the reference's. Batches are
CPU tensors in the layout the train step takes: microbatched ``(N, B/N,
...)`` when ``cfg.train_microbatches`` > 1, else ``(B, ...)``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype


def host_generator(*entropy: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``entropy`` (any non-negative
    ints) through ``numpy.random.SeedSequence``: distinct tuples give
    independent streams."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


@dataclass(frozen=True)
class SyntheticLMData:
    """Uniform random tokens (codes per codebook for the audio frontend;
    standard-normal embeds with random labels and (3, B, S) positions for
    the vision frontend), with next-token labels."""

    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def _lead(self) -> tuple:
        N = self.cfg.train_microbatches
        if N > 1:
            if self.global_batch % N:
                raise ValueError(f"global batch {self.global_batch} does not split into "
                                 f"{N} microbatches")
            return (N, self.global_batch // N)
        return (self.global_batch,)

    def batch_at(self, step: int) -> dict:
        """The training batch for one step: ``tokens`` / ``codes`` /
        ``embeds`` (with ``positions``) and ``labels``, int32 ids."""
        cfg, S = self.cfg, self.seq_len
        g = host_generator(self.seed, step)
        lead = self._lead()
        if cfg.frontend == "audio_codes":
            codes = torch.randint(0, cfg.vocab, (*lead, S + 1, cfg.n_codebooks), generator=g,
                                  dtype=torch.int32)
            return {"codes": codes[..., :-1, :], "labels": codes[..., 1:, :]}
        if cfg.frontend == "vision_embeds":
            emb = torch.randn((*lead, S, cfg.d_model), generator=g).to(torch_dtype(cfg.dtype))
            labels = torch.randint(0, cfg.vocab, (*lead, S), generator=g, dtype=torch.int32)
            pos = torch.arange(S, dtype=torch.int32).expand(3, lead[-1], S)
            if len(lead) > 1:
                pos = pos.expand(lead[0], 3, lead[-1], S)
            return {"embeds": emb, "positions": pos.contiguous(), "labels": labels}
        toks = torch.randint(0, cfg.vocab, (*lead, S + 1), generator=g, dtype=torch.int32)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass(frozen=True)
class MarkovLMData(SyntheticLMData):
    """Learnable synthetic stream: a fixed random bigram process. Each
    token has ``branch`` possible successors (a table drawn once from the
    seed), so the stream has ~log2(``branch``) bits per token and a
    training run's loss visibly falls."""

    branch: int = 4

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        if cfg.frontend != "none":
            raise ValueError("MarkovLMData is for token LMs")
        table = torch.randint(0, cfg.vocab, (cfg.vocab, self.branch),
                              generator=host_generator(self.seed ^ 0x5EED))
        g = host_generator(self.seed, step)
        lead = self._lead()
        flat = int(np.prod(lead))
        x = torch.randint(0, cfg.vocab, (flat,), generator=g)
        choices = torch.randint(0, self.branch, (flat, self.seq_len), generator=g)
        toks = [x]
        for t in range(self.seq_len):
            x = table[x, choices[:, t]]
            toks.append(x)
        toks = torch.stack(toks, 1).to(torch.int32).reshape(*lead, self.seq_len + 1)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
