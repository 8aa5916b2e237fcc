"""Batched serving runtime with split-aware latency accounting.

The port of the reference's ``repro.runtime.server``:

* :class:`Server`: slot-based continuous batching with greedy sampling.
  Requests occupy cache slots; a prompt is fed token by token through the
  decode step (one step per token, the other slots at position -1, which
  writes nothing); each tick decodes one token for every active slot at
  its own position and retires finished requests. The cache is float32.
  The server never runs a batched prefill, so with ``use_flash_kernel``
  it still launches no flash kernel: every step has one query position.
  Its steps are ``serve_step``s (``decode=True``: MLA's absorbed path,
  the recurrent blocks' one-token steps). A block pattern's cache is the
  per-layer tuple ``serve_step`` returns, kept step to step; as in the
  reference, the recurrent steps ignore positions, so an idle slot
  advances its Mamba2 / mLSTM / sLSTM state with token 0 and a request
  served beside another need not equal serving it alone.
  Like the reference's, it sends ``"tokens"`` only, so it serves the
  token-frontend configs (not musicgen's codes or qwen2-vl's embeds).
* :class:`SplitLatencyMeter`: prices every generated token's hops between
  plan segments on a link profile (the paper's Eq. 7/8 cost model), and
  with a :class:`~repro_torch.core.adaptive.AdaptiveSplitManager` feeds
  every hop to it and follows its replans (the reference's meter, line
  for line).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.latency import LinkProfile
from repro_torch.core.planner import SplitPlan
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class DrainTruncated(RuntimeError):
    """``run_until_drained`` hit ``max_ticks`` with work still queued or
    active. ``result`` carries the partial generations produced so far
    (a :class:`DrainResult`, ``drained=False``)."""

    def __init__(self, result: "DrainResult"):
        super().__init__(
            f"run_until_drained truncated after {result.ticks} ticks "
            f"with requests still pending")
        self.result = result


class DrainResult(dict):
    """``{rid: [tokens]}`` plus ``drained`` (False: ``max_ticks`` was hit
    with work remaining, the generations are partial) and ``ticks``."""

    def __init__(self, out: dict[int, list[int]], drained: bool, ticks: int):
        super().__init__(out)
        self.drained = drained
        self.ticks = ticks


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 16
    generated: list[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclass
class SplitLatencyMeter:
    """Accumulates modeled transmission latency for inter-segment hops.

    ``bytes_per_token``: the RAW bytes a decode step produces at a cut —
    one (B, 1, d_model) activation row (the plan's ``tx_bytes`` is the
    full-sequence prefill activation). What is actually PRICED per hop
    is single-sourced from the adopted plan: when the plan carries a
    bottleneck variant (``plan.variant`` into the manager's bank), the
    per-token payload is the variant-compressed byte count, and a
    mid-stream replan onto a different variant reprices the remaining
    hops immediately (the plan swap carries the new compression). The
    plan is read duck-typed (``plan.segments[i].tx_bytes``).

    Replan hook: when ``manager`` (an
    :class:`~repro_torch.core.adaptive.AdaptiveSplitManager`) and
    ``protocol`` are set, every metered hop is fed to
    ``manager.observe()`` — with a precomputed degradation surface that
    is an O(1) lookup, cheap enough to run on every token; with the
    manager's ``async_rebuild`` on, out-of-envelope drift enqueues a
    background surface rebuild, so the token loop never blocks on one —
    and when the manager adopts a new decision the meter swaps in the
    re-materialized plan (``replans`` counts the swaps). If the adopted
    decision switched protocol, the meter's ``protocol`` AND pricing
    ``link`` follow it (the new protocol's base profile at the adopted
    chunk size)."""

    plan: SplitPlan | None = None
    link: LinkProfile | None = None
    bytes_per_token: int = 0
    hop_seconds: float = 0.0
    hops: int = 0
    manager: object | None = None  # AdaptiveSplitManager (duck-typed)
    protocol: str | None = None
    replans: int = 0

    def observe_hop(self, nbytes: int, latency_s: float,
                    retries: int = 0) -> bool:
        """Feed one externally measured hop (a device-reported transfer)
        to the manager through the same adoption-following logic the
        token loop uses: if the observation triggers a replan the meter
        swaps in the re-materialized plan, and on a cross-protocol
        adoption follows the new protocol's pricing link. Returns True
        when a replan was adopted. No-op without a manager/protocol."""
        if self.manager is None or self.protocol is None:
            return False
        decisions = len(self.manager.history)
        self.manager.observe(self.protocol, nbytes, latency_s, retries)
        if len(self.manager.history) == decisions:
            return False
        self.plan = self.manager.current_plan()
        adopted = self.manager.current
        if adopted is not None and adopted.protocol != self.protocol:
            # cross-protocol replan: hops now ride the NEW protocol's
            # link (at the adopted chunk size)
            self.protocol = adopted.protocol
            base = self.manager.protocols[adopted.protocol]
            self.link = replace(base, mtu_bytes=adopted.chunk_bytes)
        self.replans += 1
        return True

    def _plan_variant(self):
        """The adopted plan's bottleneck variant, resolved through the
        manager's bank (None for plain plans or meters without a
        banked manager)."""
        vi = getattr(self.plan, "variant", None)  # plans are duck-typed
        if vi is None or vi < 0:
            return None
        bank = getattr(self.manager, "variants", None)
        if bank is None:
            return None
        return bank[vi]

    def _hop_bytes(self, seg) -> int:
        """Bytes priced for one hop, single-sourced from the adopted
        plan: prefill pricing reads ``seg.tx_bytes`` (already
        variant-compressed by the planner); per-token pricing compresses
        ``bytes_per_token`` with the plan's adopted variant. A replan
        that switches variants changes this on the very next hop."""
        if not self.bytes_per_token:
            return seg.tx_bytes
        v = self._plan_variant()
        if v is None:
            return self.bytes_per_token
        return v.compressed_bytes(self.bytes_per_token)

    def on_token(self) -> None:
        if self.plan is None or self.link is None:
            return
        # while-loop (not for) so a mid-token replan adoption reprices the
        # REMAINING hops on the newly adopted plan/link
        hop = 0
        while self.plan is not None and hop < len(self.plan.segments) - 1:
            seg = self.plan.segments[hop]
            hop += 1
            nbytes = self._hop_bytes(seg)
            hop_s = self.link.transmission_latency_s(nbytes)
            self.hop_seconds += hop_s
            self.hops += 1
            self.observe_hop(nbytes, hop_s)


class Server:
    """Slot-based batched decode server (greedy sampling) on the device
    that holds ``params``."""

    def __init__(self, cfg: ModelConfig, params: T.Transformer, *, slots: int = 4,
                 max_seq: int = 256, meter: SplitLatencyMeter | None = None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.meter = meter or SplitLatencyMeter()
        self.cache = T.init_cache(cfg, slots, max_seq, dtype=torch.float32,
                                  device=params.device)
        self.lengths = np.zeros(slots, dtype=np.int32)  # tokens in each slot
        self.active: dict[int, Request] = {}  # slot -> request
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> int | None:
        for s in range(self.slots):
            if s not in self.active:
                return s
        return None

    def _token_inputs(self, tokens: np.ndarray, positions: np.ndarray) -> dict:
        """One token per slot at its own position; M-RoPE configs get the
        position broadcast to its three (t, h, w) streams, as text has."""
        dev = self.params.device
        pos = torch.from_numpy(positions[:, None]).to(dev)
        if self.cfg.mrope_sections is not None:
            pos = pos.expand(3, *pos.shape)
        return {"tokens": torch.from_numpy(tokens[:, None]).to(dev), "positions": pos}

    def _decode(self, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        logits, self.cache = T.serve_step(self.cfg, self.params,
                                          self._token_inputs(tokens, positions), self.cache)
        return logits

    def _prefill(self, slot: int, req: Request) -> None:
        """Feed the prompt token by token through the decode step. Only the
        admitted slot's rows are written: every other slot rides at
        position -1, which the cache writer treats as "write nothing"."""
        tokens = np.zeros(self.slots, dtype=np.int32)
        positions = np.full(self.slots, -1, dtype=np.int32)
        for t, tok in enumerate(req.prompt):
            tokens[slot] = tok
            positions[slot] = t
            self._decode(tokens, positions)
        self.lengths[slot] = len(req.prompt)
        self.active[slot] = req

    def step(self) -> list[tuple[int, int]]:
        """One server tick: admit, decode one token for all active slots
        at their own positions (idle slots at -1), retire finished
        requests. Returns [(rid, token)] emitted."""
        while self.queue and (slot := self._free_slot()) is not None:
            self._prefill(slot, self.queue.pop(0))
        if not self.active:
            return []
        emitted = []
        tokens = np.zeros(self.slots, dtype=np.int32)
        positions = np.full(self.slots, -1, dtype=np.int32)
        for s, req in self.active.items():
            tokens[s] = req.generated[-1] if req.generated else int(req.prompt[-1])
            positions[s] = self.lengths[s]
        logits = self._decode(tokens, positions)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        if nxt.ndim > 1:  # multi-codebook heads: take stream 0
            nxt = nxt[..., 0]
        for s in list(self.active):
            req = self.active[s]
            req.generated.append(int(nxt[s]))
            emitted.append((req.rid, int(nxt[s])))
            self.meter.on_token()
            self.lengths[s] += 1
            if req.done or self.lengths[s] >= self.max_seq - 1:
                del self.active[s]
        return emitted

    def run_until_drained(self, max_ticks: int = 10_000, *,
                          on_truncate: str = "return") -> DrainResult:
        """Tick until every request retires or ``max_ticks`` elapse. On
        truncation, ``on_truncate="return"`` gives a :class:`DrainResult`
        with ``drained=False``; ``"raise"`` raises :class:`DrainTruncated`."""
        if on_truncate not in ("return", "raise"):
            raise ValueError(f"on_truncate must be 'return' or 'raise', "
                             f"got {on_truncate!r}")
        out: dict[int, list[int]] = {}
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            for rid, tok in self.step():
                out.setdefault(rid, []).append(tok)
            ticks += 1
        result = DrainResult(out, drained=not (self.queue or self.active),
                             ticks=ticks)
        if not result.drained and on_truncate == "raise":
            raise DrainTruncated(result)
        return result
