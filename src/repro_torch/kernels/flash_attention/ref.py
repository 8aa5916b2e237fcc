"""Plain PyTorch version of the flash attention kernel: the arithmetic of
the reference's ``attention_ref`` (materialized float32 scores, the
``-1e30`` mask, softmax). The CPU path of the wrapper and the kernel's
yardstick on the card. :func:`split_hi_lo` states how the wgmma kernel
carries the float32 probabilities into bf16 products."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, q_positions, kv_positions, scale):
    """q: (BH, Sq, D); k/v: (BHkv, Skv, D); positions (Sq,) and (Skv,).
    q head ``h`` reads kv head ``h // (BH // BHkv)``."""
    group = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    mask = kv_positions[None, None, :] <= q_positions[None, :, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def split_hi_lo(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The wgmma kernel's two bf16 pieces of float32 probabilities:
    ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, each rounded to nearest
    even. ``hi + lo`` keeps ~16 significant bits of p: for p in [0, 1],
    ``|p - (hi + lo)| <= 2^-16 p`` wherever the rounding of ``lo`` stays
    in bf16's normal range (p >= 2^-118), and ``<= 2^-134`` below it;
    p = 0 gives 0. Each piece times a bf16 V is exact in float32."""
    p = p.float()
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi, lo
