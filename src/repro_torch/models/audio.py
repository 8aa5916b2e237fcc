"""Audio-codes utilities for the musicgen backbone (EnCodec token streams).

MusicGen's *delay pattern* (Copet et al. 2023, §2.2): codebook k of frame
t is predicted at step t + k, so all K codebooks can be decoded
autoregressively with a single transformer pass per step instead of K.
These helpers convert between the aligned (B, T, K) frame grid and the
delayed (B, T + K - 1, K) training/decoding layout. The port of the
reference's ``repro.models.audio``."""

from __future__ import annotations

import torch

__all__ = ["delay_mask", "delay_pattern", "undelay_pattern"]


def delay_pattern(codes: torch.Tensor, pad_id: int) -> torch.Tensor:
    """(B, T, K) aligned codes -> (B, T + K - 1, K) delayed layout;
    codebook k is shifted right by k steps, holes filled with ``pad_id``."""
    B, T, K = codes.shape
    out = torch.full((B, T + K - 1, K), pad_id, dtype=codes.dtype, device=codes.device)
    for k in range(K):
        out[:, k:k + T, k] = codes[:, :, k]
    return out


def undelay_pattern(delayed: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Inverse of :func:`delay_pattern`: (B, T + K - 1, K) -> (B, T, K)."""
    K = delayed.shape[2]
    return torch.stack([delayed[:, k:k + n_frames, k] for k in range(K)], dim=-1)


def delay_mask(n_frames: int, n_codebooks: int, device=None) -> torch.Tensor:
    """(T + K - 1, K) bool mask of REAL (non-pad) positions in the delayed
    layout, used to exclude pad slots from the training loss."""
    S = n_frames + n_codebooks - 1
    t = torch.arange(S, device=device)[:, None]
    k = torch.arange(n_codebooks, device=device)[None, :]
    return (t >= k) & (t < k + n_frames)
