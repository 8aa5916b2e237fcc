"""Recurrent and state-space blocks: Mamba2 (SSD), mLSTM, sLSTM, in PyTorch.

The port's counterpart of ``repro.models.ssm``, which powers the hybrid
(zamba2-1.2b: Mamba2 with a shared attention block) and SSM (xlstm-1.3b:
mLSTM and sLSTM) configs. Each mixer is an ``nn.Module`` holding the
reference's leaves under their names (:class:`Mamba2`, :class:`MLSTM`,
:class:`SLSTM`); the plain functions beside them take the module as
``p``, as the reference's take its parameter dict:

* :func:`mamba_chunked` (prefill: the chunked SSD form) and
  :func:`mamba_step` (decode: one token on the (ph, ds) state);
* :func:`mlstm_chunked` (chunk-parallel linear attention with scalar decay
  gates) and :func:`mlstm_step`;
* :func:`slstm_forward` (the sequential scalar-memory cell, over a whole
  sequence or one step);
* ``init_*_cache``: the decode states (:func:`init_slstm_cache`'s
  stabilizer m starts at -10).

Types follow the reference step by step: projections round to the
activation type (a matmul in that type: float32 accumulation, one
rounding), except sLSTM's input projection, which stays float32; the
causal conv sums its products in the activation type in tap order; the
scans, gates and states are float32. ``A_log``, ``D``, ``dt_bias``,
``f_bias`` and sLSTM's recurrent ``r`` are float32 leaves in a bfloat16
model.

The Mamba2 chunk loop is :func:`mamba_scan`: CUDA tensors launch the SSD
kernel (``kernels.ssm_scan``, ``csrc/ssm_scan.cu``) with x, B and C cast
to float32, CPU tensors run the reference's chunk body
(:func:`mamba_scan_plain`); where autograd records (training), every
device runs the chunk body, since the kernel has no backward. Neither
falls back to the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import holds_no_data
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _weight, dense_init_

__all__ = ["MLSTM", "SLSTM", "Mamba2", "init_mamba_cache", "init_mlstm_cache",
           "init_slstm_cache", "mamba_chunked", "mamba_scan", "mamba_scan_plain",
           "mamba_step", "mlstm_chunked", "mlstm_step", "slstm_forward"]


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


class Mamba2(nn.Module):
    """``in_proj`` (d, 2 di + 2 ds + nh) projects to [z, x, B, C, dt];
    ``conv_w`` (d_conv, di + 2 ds) and ``conv_b`` the depthwise causal
    conv over [x, B, C]; float32 ``A_log``, ``D``, ``dt_bias`` (nh);
    ``out_proj`` (di, d)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = _weight(d, 2 * di + 2 * ds + nh, **kw)
        self.conv_w = _weight(cfg.d_conv, di + 2 * ds, **kw)
        self.conv_b = _weight(di + 2 * ds, **kw)
        self.A_log = _weight(nh, **f32)
        self.D = _weight(nh, **f32)
        self.dt_bias = _weight(nh, **f32)
        self.out_proj = _weight(di, d, **kw)

    def init_weights(self, generator) -> None:
        dense_init_(self.in_proj, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        self.conv_b.zero_()
        nh = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        dense_init_(self.out_proj, generator)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq. x: (B, S, C); w: (K, C); ``state``:
    (B, K-1, C) trailing context from earlier steps (cast to x's type).
    The K products are summed in x's type in tap order, then the bias
    and SiLU. Returns (out, the new trailing context)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else x[:, :0]
    return F.silu(out + b), new_state


def _cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefix sums of ``t`` along ``dim`` in its type, summed in float64 and
    rounded once: the correctly rounded ones, whatever order the device's
    scan takes. A float32 scan's error depends on that order, and
    exp(cum_i - cum_j) turns it into a relative error of the decays: on
    the card torch's float32 cumsum is a parallel scan, several times
    less accurate than the CPU's sequential one, and at zamba2-1.2b's
    prefill (|cum| in the thousands within a chunk) that alone took the
    chunk body outside the SSD kernel's contract
    (``tools/ssd_prefix_sum_check.py`` measures it)."""
    return torch.cumsum(t.double(), dim=dim).to(t.dtype)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < t <= i} dA_t for j <= i else -inf. dA: (..., C);
    the prefix sums correctly rounded (:func:`_cumsum`)."""
    C = dA.shape[-1]
    cs = _cumsum(dA, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def mamba_scan_plain(x, Bm, Cm, dA, dt, chunk: int) -> torch.Tensor:
    """The reference's chunk body (``mamba_chunked``'s ``lax.scan``), in
    PyTorch on any device: x (B, S, nh, ph); Bm, Cm (B, S, ds) shared by
    the heads; dA, dt (B, S, nh) float32. The sequence is zero-padded to
    whole chunks of ``chunk``; the (nh, ph, ds) state starts at zero and
    is carried in float32. One departure: the chunk's prefix sums of dA
    are correctly rounded (:func:`_cumsum`, as the SSD kernel forms them),
    so the result does not hang on the device's scan order. Returns y
    (B, S, nh, ph) float32, without the ``x * D`` skip."""
    B, S, nh, ph = x.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm, Cm, dA, dt = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm, dA, dt))

    def rs(t):  # (B, S', ...) -> (B, n, chunk, ...)
        return t.reshape(B, n, chunk, *t.shape[2:])

    xc, bc, cc, dac, dtc = rs(x), rs(Bm), rs(Cm), rs(dA), rs(dt)
    h = torch.zeros((B, nh, ph, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for k in range(n):
        xk, bk, ck = xc[:, k].float(), bc[:, k].float(), cc[:, k].float()
        dak, dtk = dac[:, k], dtc[:, k]
        L = torch.exp(_segsum(dak.transpose(1, 2)))  # (B, nh, C, C)
        # intra-chunk: Y = (C B^T o L) (dt x)
        scores = torch.einsum("bis,bjs->bij", ck, bk)[:, None] * L
        xdt = xk * dtk[..., None]  # (B, C, nh, ph)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xdt)
        # the carried state: y += (C_t o exp(cum dA)) h_prev
        cum = _cumsum(dak, 1)  # (B, C, nh)
        y_state = torch.einsum("bis,bhps->bihp", ck, h) * torch.exp(cum)[..., None]
        # h = exp(total) h_prev + sum_t exp(total - cum_t) dt_t B_t x_t
        total = cum[:, -1]
        decay_out = torch.exp(total[:, None] - cum)  # (B, C, nh)
        h = torch.exp(total)[:, :, None, None] * h + torch.einsum(
            "bis,bihp->bhps", bk, xdt * decay_out[..., None])
        ys.append(y_intra + y_state)
    return torch.stack(ys, 1).reshape(B, n * chunk, nh, ph)[:, :S]


def mamba_scan(x, Bm, Cm, dA, dt, chunk: int) -> torch.Tensor:
    """:func:`mamba_scan_plain`'s function. The route is chosen by mode
    and device, never by a failure:

    * where autograd records (grad mode on and an input requires grad:
      the train path), the chunk body runs on the tensors' device, as the
      reference trains on its own chunk body (the SSD kernel has no
      backward);
    * otherwise CPU tensors run the chunk body, and CUDA tensors launch
      the SSD kernel through ``ssm_scan`` with x, B and C cast to float32
      (exact: the chunk body casts them itself), so y comes back float32,
      as the reference keeps it. A shape outside the kernel's range
      raises its ``ValueError``. Tensors that hold no data (``meta``,
      ``FakeTensorMode``: the dry run's trace) take the SSD op too, which
      returns an empty y."""
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, Bm, Cm, dA, dt))
    if records or (x.device.type == "cpu" and not holds_no_data(x)):
        return mamba_scan_plain(x, Bm, Cm, dA, dt, chunk)
    return ssm_scan(x.float(), Bm.float(), Cm.float(), dA, dt, chunk=chunk)


def _mamba_split(cfg: ModelConfig, p: Mamba2, xin: torch.Tensor):
    di, ds = cfg.d_inner, cfg.ssm_state
    proj = torch.matmul(xin, p.in_proj)
    return proj.split([di, di + 2 * ds, di // cfg.ssm_head_dim], dim=-1)


def mamba_chunked(cfg: ModelConfig, p: Mamba2, xin: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """Chunk-parallel SSD over a full sequence (prefill). xin: (B, S, d)."""
    B, S, _ = xin.shape
    di, ds, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // ph
    z, xBC, dt_raw = _mamba_split(cfg, p, xin)
    xBC, _ = _causal_conv(xBC, p.conv_w, p.conv_b)
    x, Bm, Cm = xBC.split([di, ds, ds], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B, S, nh)
    dA = dt * -torch.exp(p.A_log)
    xh = x.reshape(B, S, nh, ph)
    y = mamba_scan(xh, Bm, Cm, dA, dt, chunk)
    y = y + xh.float() * p.D[:, None]
    y = y.reshape(B, S, di).to(xin.dtype) * F.silu(z)
    return torch.matmul(y, p.out_proj)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
                     device=None) -> dict:
    """``{"h": (B, nh, ph, ds) float32, "conv": (B, d_conv - 1, di + 2 ds)
    of dtype}`` of zeros."""
    di, ds = cfg.d_inner, cfg.ssm_state
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, di // cfg.ssm_head_dim, cfg.ssm_head_dim, ds),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * ds), dtype=dtype, device=dev),
    }


def mamba_step(cfg: ModelConfig, p: Mamba2, xin: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent step. xin: (B, 1, d). Returns the output and
    a new cache (``cache`` is not written)."""
    B = xin.shape[0]
    di, ds, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // ph
    z, xBC, dt_raw = _mamba_split(cfg, p, xin)
    xBC, conv_state = _causal_conv(xBC, p.conv_w, p.conv_b, state=cache["conv"])
    x, Bm, Cm = xBC[:, 0].split([di, ds, ds], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)  # (B, nh)
    dA = torch.exp(dt * -torch.exp(p.A_log))
    xh = x.reshape(B, nh, ph).float()
    h = cache["h"] * dA[:, :, None, None] + \
        (xh * dt[..., None])[..., None] * Bm.float()[:, None, None, :]
    y = torch.einsum("bs,bhps->bhp", Cm.float(), h)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(B, 1, di).to(xin.dtype) * F.silu(z)
    return torch.matmul(y, p.out_proj), {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``in_proj`` (d, 3 di + 2 nh) projects to q, k, v and the input and
    forget gate logits; ``out_proj`` (di, d); float32 ``f_bias`` (nh), 3 at
    init (open forget gates)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
        self.in_proj = _weight(d, 3 * di + 2 * nh, device=device, dtype=dtype)
        self.out_proj = _weight(di, d, device=device, dtype=dtype)
        self.f_bias = _weight(nh, device=device, dtype=torch.float32)

    def init_weights(self, generator) -> None:
        dense_init_(self.in_proj, generator)
        dense_init_(self.out_proj, generator)
        self.f_bias.fill_(3.0)


def mlstm_chunked(cfg: ModelConfig, p: MLSTM, xin: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """Chunk-parallel mLSTM: linear attention with scalar decay gates, the
    (ph, ph) memory C and normalizer n carried across chunks in float32.
    A ragged tail is zero-padded, its input-gate logits at -1e30."""
    B, S, _ = xin.shape
    di, nh = cfg.d_inner, cfg.n_heads
    ph = di // nh
    proj = torch.matmul(xin, p.in_proj)
    q, k, v, gates = proj.split([di, di, di, 2 * nh], dim=-1)
    i_log = gates[..., :nh].float()  # log input gate
    f_log = F.logsigmoid(gates[..., nh:].float() + p.f_bias)

    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q, k, v, f_log = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, f_log))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=-1e30)

    qc, kc, vc = (t.reshape(B, n_chunks, chunk, nh, ph) for t in (q, k, v))
    ic, fc = (t.reshape(B, n_chunks, chunk, nh) for t in (i_log, f_log))
    scale = 1.0 / math.sqrt(ph)
    C = torch.zeros((B, nh, ph, ph), dtype=torch.float32, device=xin.device)
    n = torch.zeros((B, nh, ph), dtype=torch.float32, device=xin.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xin.device))
    ys = []
    for c in range(n_chunks):
        qf = qc[:, c].float() * scale  # (B, C, nh, ph)
        kf, vf = kc[:, c].float(), vc[:, c].float()
        ik, fk = ic[:, c], fc[:, c]  # (B, C, nh)
        cumf = torch.cumsum(fk, dim=1)
        total = cumf[:, -1]
        # intra-chunk decay D_ij = exp(cumf_i - cumf_j + i_j), j <= i
        dmat = cumf[:, :, None, :] - cumf[:, None, :, :] + ik[:, None, :, :]
        w = torch.exp(torch.where(mask[None, :, :, None], dmat, -torch.inf))
        sw = torch.einsum("bihp,bjhp->bijh", qf, kf) * w  # (B, i, j, nh)
        y_intra = torch.einsum("bijh,bjhp->bihp", sw, vf)
        z_intra = sw.sum(dim=2)[..., None]
        # the carried state: y += exp(cumf_i) q_i C; the normalizer likewise
        din = torch.exp(cumf)[..., None]  # (B, C, nh, 1)
        y_state = torch.einsum("bihp,bhpq->bihq", qf, C) * din
        z_state = torch.einsum("bihp,bhp->bih", qf, n)[..., None] * din
        dout = torch.exp(total[:, None, :] - cumf + ik)[..., None]  # (B, C, nh, 1)
        decay = torch.exp(total)
        C = decay[:, :, None, None] * C + torch.einsum("bjhp,bjhq->bhpq", kf * dout, vf)
        n = decay[:, :, None] * n + (kf * dout).sum(dim=1)
        ys.append((y_intra + y_state) / torch.clamp_min(torch.abs(z_intra + z_state), 1.0))
    y = torch.stack(ys, 1).reshape(B, n_chunks * chunk, di)[:, :S]
    return torch.matmul(y.to(xin.dtype), p.out_proj)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """``{"C": (B, nh, ph, ph), "n": (B, nh, ph)}`` float32 zeros."""
    nh, ph = cfg.n_heads, cfg.d_inner // cfg.n_heads
    dev = resolve_device(device)
    return {"C": torch.zeros((batch, nh, ph, ph), dtype=torch.float32, device=dev),
            "n": torch.zeros((batch, nh, ph), dtype=torch.float32, device=dev)}


def mlstm_step(cfg: ModelConfig, p: MLSTM, xin: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
    """O(1) decode step. xin: (B, 1, d). Returns the output and a new
    cache."""
    B = xin.shape[0]
    di, nh = cfg.d_inner, cfg.n_heads
    ph = di // nh
    proj = torch.matmul(xin, p.in_proj)
    q, k, v, gates = proj[:, 0].split([di, di, di, 2 * nh], dim=-1)
    i_g = torch.exp(gates[..., :nh].float())[..., None]
    f_g = torch.sigmoid(gates[..., nh:].float() + p.f_bias)[..., None]
    qh = q.reshape(B, nh, ph).float() / math.sqrt(ph)
    kh, vh = k.reshape(B, nh, ph).float(), v.reshape(B, nh, ph).float()
    C = cache["C"] * f_g[..., None] + i_g[..., None] * (kh[..., :, None] * vh[..., None, :])
    n = cache["n"] * f_g + i_g * kh
    y = torch.einsum("bhp,bhpq->bhq", qh, C)
    z = torch.abs((qh * n).sum(dim=-1))[..., None]
    y = (y / torch.clamp_min(z, 1.0)).reshape(B, 1, di)
    return torch.matmul(y.to(xin.dtype), p.out_proj), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block, sequential)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """``w_in`` (d, 4 di): the i, f, z, o pre-activations; float32 ``r``
    (nh, ph, 4 ph): block-diagonal recurrent mixing, normal / sqrt(ph) at
    init; ``out_proj`` (di, d)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
        ph = di // nh
        self.w_in = _weight(d, 4 * di, device=device, dtype=dtype)
        self.r = _weight(nh, ph, 4 * ph, device=device, dtype=torch.float32)
        self.out_proj = _weight(di, d, device=device, dtype=dtype)

    def init_weights(self, generator) -> None:
        dense_init_(self.w_in, generator)
        dense_init_(self.r, generator, scale=1.0 / math.sqrt(self.r.shape[1]))
        dense_init_(self.out_proj, generator)


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """``{"c", "n", "h", "m"}``, each (B, di) float32: zeros, and the
    stabilizer m at -10."""
    return _slstm_state(cfg, batch, resolve_device(device))


def _slstm_state(cfg: ModelConfig, batch: int, dev: torch.device) -> dict:
    z = torch.zeros((batch, cfg.d_inner), dtype=torch.float32, device=dev)
    return {"c": z, "n": z.clone(), "h": z.clone(), "m": z - 10.0}


def _slstm_cell(cfg: ModelConfig, p: SLSTM, wx_t: torch.Tensor, state: dict
                ) -> tuple[dict, torch.Tensor]:
    """One sLSTM time step with exponential gating and the stabilizer m.
    The recurrent product is head-major, (B, nh, 4 ph) flattened, then
    split into the four gates, as in the reference."""
    B = wx_t.shape[0]
    di, nh = cfg.d_inner, cfg.n_heads
    h_prev = state["h"].reshape(B, nh, di // nh)
    rec = torch.einsum("bhp,hpq->bhq", h_prev, p.r).reshape(B, 4 * di)
    i_r, f_r, z_r, o_r = (wx_t.float() + rec).chunk(4, dim=-1)
    m_new = torch.maximum(f_r + state["m"], i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(f_r + state["m"] - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_r)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_r) * c / torch.clamp_min(n, 1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_forward(cfg: ModelConfig, p: SLSTM, xin: torch.Tensor, cache: dict | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Sequence or single-step sLSTM. xin: (B, S, d); ``cache`` the state
    to start from (default: :func:`init_slstm_cache`). Returns the output
    and the state after the last step."""
    B, S, _ = xin.shape
    # float32 products of the stored values, as preferred_element_type=float32
    wx = torch.matmul(xin.float(), p.w_in.float())
    state = cache or _slstm_state(cfg, B, xin.device)  # the input's device, as it is
    hs = []
    for t in range(S):
        state, h = _slstm_cell(cfg, p, wx[:, t], state)
        hs.append(h)
    y = torch.stack(hs, 1)
    return torch.matmul(y.to(xin.dtype), p.out_proj), state
