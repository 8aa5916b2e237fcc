"""Neural-net primitives of the dense decoder stack, in PyTorch.

The port's counterpart of the dense subset of ``repro.models.layers``:
RMSNorm, standard RoPE, the three attention cores and their dispatch,
the GQA attention layer with its KV-cache writer, the MLP, the embedding
and the LM head. Conventions follow the reference:

* activations are (B, S, d_model) and attention heads (B, S, H, Dh); the
  weights keep the reference's layouts (``wq`` is (d, H, Dh), ``wo``
  (H*Dh, d), ``w_in`` (d, f), the head (d, V_padded));
* every projection's output is rounded to the activation type, which a
  matmul in that type does (float32 accumulation, one rounding); norms,
  RoPE and softmax compute in float32 and cast back;
* attention scores and the LM head's logits are float32: products of the
  stored values are formed in float32 (exact for bfloat16 inputs), as
  the reference's ``preferred_element_type=float32`` does;
* the probabilities are rounded to V's type before the PV product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch type."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _weight(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> None:
    """The reference's ``_dense_init``: a float32 normal times ``scale``
    (default 1/sqrt(fan_in), fan_in = the first dim), cast to ``w``'s type."""
    fan_in = w.shape[0] if w.dim() >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(w.shape, generator=generator, device=w.device,
                    dtype=torch.float32)
    w.copy_((x * scale).to(w.dtype))


# ---------------------------------------------------------------------------
# Norm and RoPE
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.scale = _weight(d, device=device, dtype=dtype)

    def init_weights(self, generator=None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x, eps: float):
        return rmsnorm(x, self.scale, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dim."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (B, S, H, Dh) by (B, S) positions. Pairs are interleaved
    (``x[..., 0::2]``, ``x[..., 1::2]``), as in the reference."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * inv  # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def plain_attention(q, k, v, *, q_positions, kv_positions, scale) -> torch.Tensor:
    """O(Sq*Skv) attention with causal position masking (decode path).

    q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv);
    q_positions (B, Sq), kv_positions (Skv,). A row whose every kv
    position is masked (an idle slot at position -1) takes uniform weights
    over the -1e30 scores: it averages v and yields no NaN."""
    B, Sq, H, Dk = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    qr = q.reshape(B, Sq, Hkv, H // Hkv, Dk)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr.float(), k.float()) * scale
    mask = kv_positions[None, None, :] <= q_positions[:, :, None]  # (B, Sq, Skv)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def chunked_attention(q, k, v, *, q_positions, kv_positions, scale,
                      kv_chunk: int, q_chunk: int = 512,
                      causal_skip: bool = False) -> torch.Tensor:
    """Online-softmax attention tiled over query and KV chunks (the
    reference's pure-JAX flash path). Padded kv rows sit at position
    2^30; padded q rows repeat the last position and are cut off. With
    ``causal_skip`` a q chunk stops after the kv chunk holding its largest
    position (forward only: the serving paths)."""
    B, Sq, H, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv

    n_kv = -(-Skv // kv_chunk)
    pad_kv = n_kv * kv_chunk - Skv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        kv_positions = torch.cat([kv_positions, kv_positions.new_full((pad_kv,), 2**30)])

    qc = min(q_chunk, Sq)
    n_q = -(-Sq // qc)
    pad_q = n_q * qc - Sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = torch.cat(
            [q_positions, q_positions[:, -1:].expand(B, pad_q)], dim=1)

    blocks = []
    for qi in range(n_q):
        qpos = q_positions[:, qi * qc:(qi + 1) * qc]
        qr = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, Hkv, G, Dk).float()
        m = torch.full((B, qc, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, qc, Hkv, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, qc, Hkv, G, Dv), dtype=torch.float32, device=q.device)
        n_needed = n_kv
        if causal_skip:
            hi = int(qpos.max())  # the last q position of this chunk
            n_needed = min(n_kv, (hi + kv_chunk) // kv_chunk)
        for ci in range(n_needed):
            sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
            s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k[:, sl].float()) * scale
            mask = kv_positions[sl][None, None, :] <= qpos[:, :, None]
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v[:, sl].float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        blocks.append(out.reshape(B, qc, H, Dv).to(q.dtype))
    return torch.cat(blocks, dim=1)[:, :Sq]


def attention_core(cfg: ModelConfig, q, k, v, q_positions, kv_positions) -> torch.Tensor:
    """The reference's dispatch: the flash kernel when
    ``cfg.use_flash_kernel`` and Sq > 8, plain attention for Sq <= 8
    (decode), chunked attention otherwise."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if cfg.use_flash_kernel and q.shape[1] > 8:
        # The kernel computes in float32 from either type. A cache of
        # another type holds values written from q's type, so the cast
        # is exact.
        return flash_attention(q, k.to(q.dtype), v.to(q.dtype),
                               q_positions=q_positions,
                               kv_positions=kv_positions, scale=scale)
    if q.shape[1] <= 8:
        return plain_attention(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, scale=scale)
    return chunked_attention(q, k, v, q_positions=q_positions,
                             kv_positions=kv_positions, scale=scale,
                             kv_chunk=cfg.kv_chunk, q_chunk=cfg.q_chunk,
                             causal_skip=cfg.causal_skip)


# ---------------------------------------------------------------------------
# GQA attention layer (with optional KV cache)
# ---------------------------------------------------------------------------


def cache_write(c: torch.Tensor, u: torch.Tensor, pos_ids: torch.Tensor,
                offset: int) -> None:
    """Write ``u`` (B, S, Hkv, Dh) into the cache ``c`` (B, Smax, Hkv, Dh)
    in place (the reference's ``_cache_writer`` returns a new array).

    Decode (S == 1) writes per row: row ``b`` lands at ``pos_ids[b, 0]``,
    and a position outside [0, Smax) (an idle slot at -1) writes nothing.
    Prefill (S > 1) writes one slice for all rows from ``offset``, which
    is ``pos_ids[0, 0]``, clamped as ``dynamic_update_slice`` clamps it."""
    B, S = u.shape[:2]
    s_max = c.shape[1]
    if S > s_max:
        raise ValueError(f"cannot write {S} positions into a cache of {s_max}")
    if S == 1:
        pos = pos_ids[:, 0].long()
        hit = (pos >= 0) & (pos < s_max)
        rows = torch.arange(B, device=c.device)
        at = torch.where(hit, pos, 0)
        # rows that write nothing store back what they hold: no host sync
        c[rows, at] = torch.where(hit[:, None, None], u[:, 0].to(c.dtype), c[rows, at])
    else:
        start = min(max(offset, 0), s_max - S)
        c[:, start:start + S] = u.to(c.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _weight(d, H, Dh, device=device, dtype=dtype)
        self.wk = _weight(d, Hkv, Dh, device=device, dtype=dtype)
        self.wv = _weight(d, Hkv, Dh, device=device, dtype=dtype)
        self.wo = _weight(H * Dh, d, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator)
        dense_init_(self.wo, generator, scale=1.0 / math.sqrt(self.wo.shape[0]))

    @staticmethod
    def _proj(x, w):  # (B, S, d) x (d, H, Dh) -> (B, S, H, Dh)
        return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
            *x.shape[:2], *w.shape[1:])

    def forward(self, cfg: ModelConfig, x, positions, cache=None, offset: int = 0):
        """x: (B, S, D); positions (B, S); ``cache``: {"k", "v": (B, Smax,
        Hkv, Dh)}, written in place at ``positions``. Returns (B, S, D)."""
        B, S, _ = x.shape
        q = apply_rope(self._proj(x, self.wq), positions, cfg.rope_theta)
        k = apply_rope(self._proj(x, self.wk), positions, cfg.rope_theta)
        v = self._proj(x, self.wv)
        if cache is not None:
            cache_write(cache["k"], k, positions, offset)
            cache_write(cache["v"], v, positions, offset)
            k, v = cache["k"], cache["v"]
        kv_positions = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        out = attention_core(cfg, q, k, v, positions, kv_positions)
        return torch.matmul(out.reshape(B, S, -1), self.wo)


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.gated = cfg.gated_mlp
        self.w_in = _weight(d, f, device=device, dtype=dtype)
        self.w_out = _weight(f, d, device=device, dtype=dtype)
        if self.gated:
            self.w_gate = _weight(d, f, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator)
        if self.gated:
            dense_init_(self.w_gate, generator)

    def forward(self, x):
        h = torch.matmul(x, self.w_in)
        if self.gated:
            h = F.silu(torch.matmul(x, self.w_gate)) * h
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return torch.matmul(h, self.w_out)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.table = _weight(cfg.vocab, cfg.d_model, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.table, generator, scale=0.02)

    def forward(self, tokens):
        return self.table[tokens]


class LMHead(nn.Module):
    """Float32 logits over the padded vocab (a multiple of
    ``pad_vocab_to``); padded slots are set to -1e30 and never win."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.vocab = cfg.vocab
        self.w = _weight(cfg.d_model, cfg.vocab_padded, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.w, generator, scale=0.02)

    def forward(self, x):
        logits = torch.matmul(x.float(), self.w.float())
        if self.w.shape[1] > self.vocab:
            slot = torch.arange(self.w.shape[1], device=x.device)
            logits = torch.where(slot < self.vocab, logits, NEG_INF)
        return logits
