"""Plain PyTorch version of the flash attention kernel: the arithmetic of
the reference's ``attention_ref`` (materialized float32 scores, the
``-1e30`` mask, softmax). The CPU path of the wrapper and the kernel's
yardstick on the card."""

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
