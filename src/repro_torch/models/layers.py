"""Neural-net primitives of the decoder stack, in PyTorch.

The port's counterpart of ``repro.models.layers``: RMSNorm, RoPE and
M-RoPE, the three attention cores and their dispatch, the GQA attention
layer with its KV-cache writer and the int8 KV cache, MLA latent
attention, the MLP, the top-k routed MoE, the embedding (one table per
audio codebook) and the LM head (per codebook, or tied to the
embedding). Conventions follow the reference:

* activations are (B, S, d_model) and attention heads (B, S, H, Dh); the
  weights keep the reference's layouts (``wq`` is (d, H, Dh), ``wo``
  (H*Dh, d), ``w_in`` (d, f), the head (d, V_padded));
* every projection's output is rounded to the activation type, which a
  matmul in that type does (float32 accumulation, one rounding); norms,
  RoPE and softmax compute in float32 and cast back;
* attention scores and the LM head's logits are float32: products of the
  stored values are formed in float32 (exact for bfloat16 inputs), as
  the reference's ``preferred_element_type=float32`` does;
* the probabilities are rounded to V's type before the PV product;
* a product of two types (a float32 cache read by a bfloat16 layer)
  computes in the wider one, as the reference's mixed einsums do.

Under a tensor-parallel context (:mod:`repro_torch.parallel.tensor_parallel`,
the counterpart of the reference's ``constrain`` calls under ``with
mesh:``) each layer takes its local sizes from its weights' shapes and
lays its leaves out for its own call: the embedding looks its d columns
up, attention computes its local heads, the MLP its f columns, each
followed by a row-parallel product summed over "model" in float32; the
LM head gives vocab-sharded logits; the MoE runs the experts the rank
holds (or each expert's f columns) and sums the float32 partial combines
over "model". MLA gathers its leaves and runs replicated. Decode over a
cache whose sequence is split attends on the rank's rows and combines
the partial softmaxes over the axes that split it (:func:`split_attention`).
Outside a context every layer runs as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantization import true_divide
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import tensor_parallel as TP

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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Rotate (B, S, H, Dh) by (B, S) positions, or for M-RoPE (Qwen2-VL)
    by (3, B, S) position streams: the Dh/2 frequency slots split into
    (t, h, w) sections of ``mrope_sections`` slots, each section driven by
    its own stream. Pairs are interleaved (``x[..., 0::2]``,
    ``x[..., 1::2]``), as in the reference."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)
    if mrope_sections is None:
        angles = positions.float()[..., None] * inv  # (B, S, dh/2)
    else:
        if positions.dim() != 3 or sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE needs positions (3, B, S) and sections "
                             f"summing to {half}, got {tuple(positions.shape)} "
                             f"and {mrope_sections}")
        section = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(mrope_sections, device=x.device),
            output_size=half)  # stream of each slot
        angles = positions.float()[section].permute(1, 2, 0) * inv
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


def split_attention(q, k, v, *, q_positions, kv_positions, scale, axes) -> torch.Tensor:
    """:func:`plain_attention` on this rank's kv rows of a sequence split
    over the mesh ``axes`` (``kv_positions`` their global positions), as
    XLA partitions the reference's decode: float32 scores masked as there,
    the row max all-reduced (MAX), the sums of exp(s - max) all-reduced,
    the probabilities exp(s - max) / sum cast to v's type, and the float32
    P·V partials all-reduced before the one cast. It differs from the
    meshless form only in the order of the two float32 sums. An idle slot
    (every row masked) averages v over every rank's rows, as there."""
    B, Sq, H, Dk = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    qr = q.reshape(B, Sq, Hkv, H // Hkv, Dk)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr.float(), k.float()) * scale
    mask = kv_positions[None, None, :] <= q_positions[:, :, None]  # (B, Sq, Skv)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = _split_softmax(s, axes)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return _split_sum(o, axes).reshape(B, Sq, H, Dv).to(q.dtype)


def _split_sum(t: torch.Tensor, axes, op=None) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over the mesh ``axes``."""
    return TP.reduce_axes_(t.contiguous(), TP.current().mesh, axes, op)


def _split_softmax(s: torch.Tensor, axes) -> torch.Tensor:
    """The softmax over the last dim of scores whose columns are split
    over the mesh ``axes``: exp(s - M) / L, M and L reduced over them."""
    import torch.distributed as dist

    top = _split_sum(s.amax(dim=-1), axes, dist.ReduceOp.MAX)
    e = torch.exp(s - top[..., None])
    return e / _split_sum(e.sum(dim=-1), axes)[..., None]


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
# GQA attention layer (with optional KV cache, bf16 or int8)
# ---------------------------------------------------------------------------


def cache_write(c: torch.Tensor, u: torch.Tensor, pos_ids: torch.Tensor,
                offset: int) -> None:
    """Write ``u`` (B, S, ...) into the cache ``c`` (B, Smax, ...) in place
    (the reference's ``_cache_writer`` returns a new array).

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
        hit = hit.reshape(B, *([1] * (u.dim() - 2)))
        # rows that write nothing store back what they hold: no host sync
        c[rows, at] = torch.where(hit, u[:, 0].to(c.dtype), c[rows, at])
    else:
        start = min(max(offset, 0), s_max - S)
        c[:, start:start + S] = u.to(c.dtype)


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 KV cache's quantizer: symmetric int8 per (token, head).
    ``t`` (B, S, Hkv, Dh) -> values (B, S, Hkv, Dh) int8 and float32
    scales (B, S, Hkv): ``scale = amax / 127`` (1 for a row of zeros),
    values rounded half to even, then clipped to [-127, 127]."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, true_divide(amax, 127.0), 1.0)
    vals = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return vals.to(torch.int8), scale


def dequantize_kv(vals: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Values times scales, both cast to ``dtype`` first (the reference's
    order: the product rounds once in ``dtype``)."""
    return vals.to(dtype) * scale[..., None].to(dtype)


def _promoted(*ts: torch.Tensor) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _head_proj(x, w):  # (B, S, d) x (d, H, Dh) -> (B, S, H, Dh)
    dt = _promoted(x, w)
    return torch.matmul(x.to(dt), w.to(dt).reshape(w.shape[0], -1)).reshape(
        *x.shape[:2], *w.shape[1:])


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

    def forward(self, cfg: ModelConfig, x, positions, cache=None, offset: int = 0,
                partial: bool = False):
        """x: (B, S, D); positions (B, S), or (3, B, S) for M-RoPE (masks
        take the t stream). ``cache``: {"k", "v": (B, Smax, Hkv, Dh)},
        plus {"k_scale", "v_scale": (B, Smax, Hkv)} float32 for the int8
        cache, written in place at ``positions``. The int8 cache is
        dequantized into x's type before the attention core. Returns
        (B, S, D).

        Tensor-parallel where "model" divides H (``TP.attention_plan``):
        the local q heads (and kv heads where it divides Hkv, else k/v
        whole and the kv heads the local q heads read, GQA's ``h //
        group``), the attention core on them, ``wo`` row-parallel; with
        ``partial`` the float32 partial comes back unreduced
        (``TP.Partial``, the parallel residual sums it with the FFN's).
        Elsewhere the layer runs whole on weights gathered for the call.
        A one-token step over a cache whose sequence is split
        (``TP.kv_split``) writes and attends on the rank's rows
        (:func:`split_attention`), q gathered over the heads first where
        the sequence is split over "model" and the q heads are too."""
        keep, part = TP.attention_plan(cfg.n_heads, cfg.n_kv_heads)
        split = TP.kv_split(cache) if x.shape[1] == 1 else None
        if not keep:
            with TP.gathered(self), TP.layer_cache(cache, split=split) as cache:
                out = self._attend(cfg, x, positions, cache, offset, split=split)
                return torch.matmul(out.reshape(*x.shape[:2], -1), self.wo)
        # the sequence is split over "model" only where the kv heads are not
        whole_q = split is not None and "model" in split.axes
        with TP.gathered(self, (keep, part)), \
                TP.layer_cache(cache, heads=not part, split=split) as cache:
            kv = TP.kv_heads(cfg.n_heads, cfg.n_kv_heads) if part and not whole_q else None
            out = self._attend(cfg, TP.copy_to_model(x), positions, cache, offset, kv, split,
                               whole_q)
            y = TP.row_parallel(out.reshape(*x.shape[:2], -1), self.wo)
        return y if partial else TP.reduce(y, x.dtype)

    def _attend(self, cfg: ModelConfig, x, positions, cache, offset: int, kv=None,
                split=None, whole_q: bool = False):
        """The attention core's output (B, S, H, Dv) on this layer's heads;
        ``kv`` (a slice or index list) picks the kv heads they read.
        ``split`` (``TP.SeqSplit``): the cache holds the rank's rows of a
        split sequence; ``whole_q``: q is gathered over "model" for every
        head and the rank keeps its own heads of the output."""
        rope = (cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(_head_proj(x, self.wq), positions, *rope)
        k = apply_rope(_head_proj(x, self.wk), positions, *rope)
        v = _head_proj(x, self.wv)
        pos_ids = positions[0] if positions.dim() == 3 else positions
        # a split cache is written at the rank's own rows: nothing lands
        # outside [0, its rows)
        at = pos_ids if split is None else pos_ids - split.first
        if cache is not None and "k_scale" in cache:
            for name, t in (("k", k), ("v", v)):
                vals, scale = quantize_kv(t)
                cache_write(cache[name], vals, at, offset)
                cache_write(cache[name + "_scale"], scale, at, offset)
            k = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
            v = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
        elif cache is not None:
            cache_write(cache["k"], k, at, offset)
            cache_write(cache["v"], v, at, offset)
            k, v = cache["k"], cache["v"]
        if isinstance(kv, slice):
            k, v = k[:, :, kv], v[:, :, kv]
        elif kv is not None:
            idx = torch.tensor(kv, device=x.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        kv_positions = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        if split is None:
            return attention_core(cfg, q, k, v, pos_ids, kv_positions)
        if whole_q:
            q = TP.gather_from_model(q, 2)
        out = split_attention(q, k, v, q_positions=pos_ids, kv_positions=kv_positions
                              + split.first, scale=1.0 / math.sqrt(q.shape[-1]),
                              axes=split.axes)
        if not whole_q:
            return out
        local = out.shape[2] // TP.model_size()  # this rank's heads of the output
        return out.narrow(2, TP.current().coords["model"] * local, local)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """Latent attention. The cache holds only the compressed latent
    ``c_kv`` (B, Smax, kv_lora_rank) and the shared rope key ``k_rope``
    (B, Smax, rope_dim). Prefill expands per-head K and V and runs the
    chunked (Sq > 8) or plain attention core directly, never the flash
    kernel, as the reference does; ``absorbed=True`` (decode) scores in
    latent space and never expands K or V."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_down = _weight(d, qlr, **kw)
        self.q_up = _weight(qlr, H, dn + dr, **kw)
        self.kv_down = _weight(d, kvlr + dr, **kw)
        self.kv_up_k = _weight(kvlr, H, dn, **kw)
        self.kv_up_v = _weight(kvlr, H, dv, **kw)
        self.wo = _weight(H * dv, d, **kw)

    def init_weights(self, generator) -> None:
        for w in (self.q_down, self.q_up, self.kv_down, self.kv_up_k, self.kv_up_v,
                  self.wo):
            dense_init_(w, generator)

    def forward(self, cfg: ModelConfig, x, positions, cache=None, offset: int = 0,
                absorbed: bool = False):
        """Under a tensor-parallel context the layer runs whole on weights
        gathered for the call, its cache entries gathered for this layer;
        the absorbed one-token step over a latent cache whose sequence is
        split (``TP.kv_split``) writes and attends on the rank's rows
        instead, combining the partial softmaxes over the axes that split
        it."""
        split = TP.kv_split(cache) if absorbed and x.shape[1] == 1 else None
        with TP.gathered(self), TP.layer_cache(cache, split=split) as cache:
            return self._forward(cfg, x, positions, cache, offset, absorbed, split)

    def _forward(self, cfg: ModelConfig, x, positions, cache, offset: int, absorbed: bool,
                 split=None):
        B, S, _ = x.shape
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        pos_ids = positions[0] if positions.dim() == 3 else positions
        q = _head_proj(torch.matmul(x, self.q_down), self.q_up)
        q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)
        kv = torch.matmul(x, self.kv_down)
        c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
        if cache is not None:
            at = pos_ids if split is None else pos_ids - split.first
            cache_write(cache["c_kv"], c_kv, at, offset)
            cache_write(cache["k_rope"], k_rope, at, offset)
            c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        kv_positions = torch.arange(c_kv.shape[1], dtype=torch.int32, device=x.device)
        if split is not None:
            kv_positions = kv_positions + split.first
        scale = 1.0 / math.sqrt(dn + dr)

        if absorbed:
            # score = (q_nope W_uk) . c + q_rope . k_rope, all in latent space
            dt = _promoted(q_nope, self.kv_up_k)
            q_abs = torch.einsum("bshe,rhe->bshr", q_nope.to(dt),
                                 self.kv_up_k.to(dt)).to(x.dtype)
            s = torch.einsum("bshr,bkr->bshk", q_abs.float(), c_kv.float())
            s = s + torch.einsum("bshe,bke->bshk", q_rope.float(), k_rope.float())
            s = s * scale
            mask = kv_positions[None, None, :] <= pos_ids[:, :, None]
            s = torch.where(mask[:, :, None, :], s, NEG_INF)
            if split is None:
                prob = torch.softmax(s, dim=-1)
                o_lat = torch.einsum("bshk,bkr->bshr", prob.to(x.dtype).float(),
                                     c_kv.float()).to(x.dtype)
            else:
                prob = _split_softmax(s, split.axes)
                o_lat = _split_sum(torch.einsum("bshk,bkr->bshr", prob.to(x.dtype).float(),
                                                c_kv.float()), split.axes).to(x.dtype)
            dt = _promoted(o_lat, self.kv_up_v)
            out = torch.einsum("bshr,rhe->bshe", o_lat.to(dt),
                               self.kv_up_v.to(dt)).to(x.dtype)
        else:
            k_nope = _head_proj(c_kv, self.kv_up_k).to(x.dtype)
            v = _head_proj(c_kv, self.kv_up_v).to(x.dtype)
            H = self.kv_up_k.shape[1]
            dt = _promoted(k_nope, k_rope)
            k_full = torch.cat([k_nope.to(dt), k_rope[:, :, None, :].to(dt).expand(
                *k_rope.shape[:2], H, dr)], dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            if S > 8:
                out = chunked_attention(q_full, k_full, v, q_positions=pos_ids,
                                        kv_positions=kv_positions, scale=scale,
                                        kv_chunk=cfg.kv_chunk, q_chunk=cfg.q_chunk)
            else:
                out = plain_attention(q_full, k_full, v, q_positions=pos_ids,
                                      kv_positions=kv_positions, scale=scale)
        return torch.matmul(out.reshape(B, S, -1), self.wo)


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------


def _hidden(x, w_in, w_gate):
    h = torch.matmul(x, w_in)
    if w_gate is not None:
        return F.silu(torch.matmul(x, w_gate)) * h
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def _ffn(x, w_in, w_out, w_gate):
    return torch.matmul(_hidden(x, w_in, w_gate), w_out)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.gated, self.d_ff = cfg.gated_mlp, f
        self.w_in = _weight(d, f, device=device, dtype=dtype)
        self.w_out = _weight(f, d, device=device, dtype=dtype)
        if self.gated:
            self.w_gate = _weight(d, f, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator)
        if self.gated:
            dense_init_(self.w_gate, generator)

    def forward(self, x, partial: bool = False):
        """Tensor-parallel where "model" divides f: ``w_in`` / ``w_gate``
        column-parallel, ``w_out`` row-parallel (``partial`` as
        :meth:`Attention.forward`); elsewhere whole on gathered weights."""
        keep, _ = TP.mlp_plan(self.d_ff)
        if not keep:
            with TP.gathered(self):
                return _ffn(x, self.w_in, self.w_out, self.w_gate if self.gated else None)
        with TP.gathered(self, (keep, ())):
            h = _hidden(TP.copy_to_model(x), self.w_in, self.w_gate if self.gated else None)
            y = TP.row_parallel(h, self.w_out)
        return y if partial else TP.reduce(y, x.dtype)


def top_k_lower_index(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last dim, largest
    first, ties to the lower index (``jax.lax.top_k``'s order; a stable
    descending sort keeps equal entries in index order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def queue_positions(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, slot) pair's place in its expert's queue, (n, g, K).
    Slot-major, as the reference's: every token's first choice queues
    before any token's second choice, tokens in order within a slot, so
    an expert's overflow drops later slots first."""
    n, g, K = top_i.shape
    flat = top_i.transpose(1, 2).reshape(n, K * g)
    seen = F.one_hot(flat, n_experts).cumsum(dim=1)  # (n, K*g, E)
    pos = seen.gather(-1, flat[..., None])[..., 0] - 1
    return pos.reshape(n, K, g).transpose(1, 2)


class MoE(nn.Module):
    """Top-k routed experts with capacity-bounded grouped dispatch
    (GShard semantics; the reference's ``apply_moe``).

    Tokens go in groups of ``moe_group_size`` (the last zero-padded; its
    pad rows are routed and queue like tokens). Per group the float32
    router's softmax picks ``top_k`` experts per token
    (:meth:`select`), their probabilities renormalised by their sum
    (floored at 1e-9) are the gates, and each expert takes at most
    ``C = ceil(g * top_k / E * moe_capacity_factor)`` pairs in
    :func:`queue_positions` order; the rest are dropped. Kept tokens are
    gathered into an (E, groups x (C + 1), d) buffer (row C of each
    group collects the dropped pairs and is never read), the experts run
    as batched products over the stacked (E, d, f) weights, and each
    token sums its kept experts' outputs times its gates, cast to the
    activation type first, in float32."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.gated = cfg.gated_mlp
        self.router = _weight(d, E, device=device, dtype=torch.float32)
        self.w_in = _weight(E, d, f, device=device, dtype=dtype)
        self.w_out = _weight(E, f, d, device=device, dtype=dtype)
        if self.gated:
            self.w_gate = _weight(E, d, f, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        # fan_in is the first dim: E for the stacked experts, as in the reference
        for w in (self.router, self.w_in, self.w_out) + ((self.w_gate,) if self.gated else ()):
            dense_init_(w, generator)

    def select(self, probs: torch.Tensor, k: int) -> torch.Tensor:
        """The experts each token of each group takes, (n, g, k)."""
        return top_k_lower_index(probs, k)

    def forward(self, cfg: ModelConfig, x):
        """Tensor-parallel where "model" divides E or f (``TP.moe_plan``):
        every rank routes the same tokens (x replicated over "model", the
        router whole), runs the experts it holds on the pairs routed to
        them (or every expert on its f columns), and sums its kept pairs'
        gates x outputs in float32; the partials are summed over "model"
        in float32 and rounded once, as XLA's combine all-reduce is.
        Elsewhere the experts run whole on weights gathered for the call."""
        keep, part = TP.moe_plan(cfg.n_experts, cfg.d_ff)
        if not keep:
            with TP.gathered(self):
                return self._forward(cfg, x)
        with TP.gathered(self, (keep, part)):
            y = self._forward(cfg, TP.copy_to_model(x), partial=True)
        return TP.reduce(y, x.dtype)

    def _forward(self, cfg: ModelConfig, x, partial: bool = False):
        """The layer on the experts it holds (``w_in``'s first dim: all of
        them, or the rank's E / m in "model" order); ``partial``: the
        float32 combine of those experts' kept pairs, unreduced
        (``TP.Partial``)."""
        B, S, D = x.shape
        E, K = cfg.n_experts, cfg.top_k
        E_local = self.w_in.shape[0]
        T = B * S
        g = min(cfg.moe_group_size, T)
        n = -(-T // g)
        xg = F.pad(x.reshape(T, D), (0, 0, 0, n * g - T)).reshape(n, g, D)

        probs = torch.softmax(torch.matmul(xg.float(), self.router), dim=-1)
        top_i = self.select(probs, K)
        top_p = probs.gather(-1, top_i)
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
        C = max(1, int(math.ceil(g * K / E * cfg.moe_capacity_factor)))
        pos = queue_positions(top_i, E)
        keep = pos < C
        expert = top_i
        if E_local < E:  # the pairs routed to this rank's experts
            first = TP.current().coords["model"] * E_local
            local = (top_i >= first) & (top_i < first + E_local)
            keep = keep & local
            expert = torch.where(local, top_i - first, 0)
        row = torch.where(keep, pos, C)
        groups = torch.arange(n, device=x.device)[:, None, None]
        at = ((expert * n + groups) * (C + 1) + row).reshape(-1)  # (n*g*K,)

        # expert-major rows, so each expert's products are one batched
        # matmul over its (groups x (C + 1)) rows against its own weights
        expert_in = xg.new_zeros((E_local * n * (C + 1), D))
        expert_in[at] = xg[:, :, None, :].expand(n, g, K, D).reshape(-1, D)
        expert_in = expert_in.reshape(E_local, n * (C + 1), D)
        w_gate = self.w_gate if self.gated else None
        if partial and E_local == E:  # f kept: each expert's float32 partial product
            out = TP.row_parallel(_hidden(expert_in, self.w_in, w_gate), self.w_out).value
        else:
            out = _ffn(expert_in, self.w_in, self.w_out, w_gate)
        picked = out.reshape(-1, D)[at].reshape(n, g, K, D)
        gates = top_p.to(x.dtype).float()
        y = torch.where(keep[..., None], gates[..., None] * picked.float(), 0.0).sum(dim=2)
        if partial:
            return TP.Partial(y.reshape(n * g, D)[:T].reshape(B, S, D))
        return y.to(x.dtype).reshape(n * g, D)[:T].reshape(B, S, D)


def moe_aux_loss(cfg: ModelConfig, router_probs: torch.Tensor,
                 top_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss: the mean fraction of (token, slot)
    picks each expert takes, times its mean router probability, summed
    and scaled by E. ``router_probs`` (n, g, E) and ``top_idx`` (n, g, k),
    as :meth:`MoE.select` sees them. Neither package's ``loss_fn`` adds it."""
    E = cfg.n_experts
    frac = torch.mean(F.one_hot(top_idx.long(), E).float(), dim=(0, 1, 2))
    prob = torch.mean(router_probs, dim=tuple(range(router_probs.dim() - 1)))
    return torch.sum(frac * prob) * E


# ---------------------------------------------------------------------------
# Embedding, head
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """One table of ``vocab`` rows, or for audio codes one per codebook,
    stacked (table k's rows start at ``k * vocab``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.vocab, self.n_codebooks, self.d_model = cfg.vocab, cfg.n_codebooks, cfg.d_model
        self.table = _weight(max(1, cfg.n_codebooks) * cfg.vocab, cfg.d_model,
                             device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.table, generator, scale=0.02)

    def forward(self, tokens):
        """tokens (B, S), or codes (B, S, n_codebooks): a frame embeds as
        the sum of its codebooks' embeddings (summed in float32, rounded
        once). Tensor-parallel where "model" divides d: the rank looks its
        columns of the d-sharded table up and the columns are gathered."""
        keep, _ = TP.embed_plan(self.d_model)
        with TP.gathered(self, (keep, ())):
            x = self._lookup(tokens)
        return TP.gather_from_model(x, -1) if keep else x

    def _lookup(self, tokens):
        if self.n_codebooks and tokens.dim() == 3:
            offsets = torch.arange(self.n_codebooks, device=tokens.device) * self.vocab
            return self.table[tokens + offsets].float().sum(dim=2).to(self.table.dtype)
        return self.table[tokens]


class LMHead(nn.Module):
    """Float32 logits over the padded vocab (a multiple of
    ``pad_vocab_to``); padded slots are set to -1e30 and never win. With
    audio codebooks, one head per codebook: (B, S, n_codebooks, Vp).
    ``tie_embeddings``: the head is the embedding table transposed and
    holds no weight of its own."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.vocab, self.padded, self.n_codebooks = cfg.vocab, cfg.vocab_padded, cfg.n_codebooks
        self.tied = cfg.tie_embeddings
        if self.tied and self.padded != cfg.vocab:
            # the reference's mask (Vp,) cannot broadcast over tied (vocab,) logits
            raise ValueError(f"{cfg.name}: tie_embeddings needs vocab_padded "
                             f"({self.padded}) == vocab ({cfg.vocab})")
        if not self.tied:
            self.w = _weight(cfg.d_model, max(1, cfg.n_codebooks) * self.padded,
                             device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        if not self.tied:
            dense_init_(self.w, generator, scale=0.02)

    def forward(self, x, table=None):
        """Tensor-parallel where "model" divides Vp (untied): this rank's
        vocab shard of the logits, the fused (codebooks x Vp) columns it
        holds, padded slots masked by their global index
        (``TP.vocab_sharded``); elsewhere whole on a gathered weight."""
        keep, _ = TP.head_plan(self.padded, self.tied)
        if keep:
            with TP.gathered(self, (keep, ())):
                logits = torch.matmul(TP.copy_to_model(x.float()), self.w.float())
            if self.padded > self.vocab:
                c = logits.shape[-1]
                col = TP.current().coords["model"] * c + torch.arange(c, device=x.device)
                logits = torch.where(col % self.padded < self.vocab, logits, NEG_INF)
            return logits
        with TP.gathered(self):
            return self._logits(x, table)

    def _logits(self, x, table):
        w = table.T if self.tied else self.w
        logits = torch.matmul(x.float(), w.float())
        if self.n_codebooks:
            logits = logits.reshape(*x.shape[:2], self.n_codebooks, self.padded)
        if self.padded > self.vocab:
            slot = torch.arange(self.padded, device=x.device)
            logits = torch.where(slot < self.vocab, logits, NEG_INF)
        return logits
