"""Public op: causal flash attention in model layout (B, S, H, D).

:func:`flash_attention` folds batch and heads as the reference's
``kernels/flash_attention/ops.py`` does and calls
:func:`flash_attention_kernel`, which launches the hand-written CUDA
kernel ``csrc/flash_attention.cu``. For tensors on the CPU it runs the
plain version (:func:`.ref.attention_ref`) instead; for any other device
it launches the kernel or raises. Tensors that hold no data (``meta``,
``FakeTensorMode``: the dry run's trace) take neither: the kernel
function returns an empty output and tells the op counters.

The source holds two kernels. :func:`_variant` names the one a call takes:
``"wgmma"`` (bf16 tensor cores fed by TMA) for bfloat16 with a head dim
that is a multiple of 16 up to 256, ``"simt"`` (float32 FMAs on the CUDA
cores) for float32 and for any other head dim. :data:`FLASH_LAUNCHES`
counts launches of either, :data:`FLASH_WGMMA_LAUNCHES` those of the
first.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, holds_no_data, note_kernel, refuse_autograd
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["FLASH_LAUNCHES", "FLASH_WGMMA_LAUNCHES", "MAX_HEAD_DIM", "VARIANTS",
           "flash_attention", "flash_attention_kernel", "reset_launch_count"]

# Kernel launches since the last reset_launch_count(), of either kernel and
# of the wgmma kernel; bumped only where a kernel is launched, never by
# the plain version.
FLASH_LAUNCHES = 0
FLASH_WGMMA_LAUNCHES = 0

VARIANTS = ("wgmma", "simt")

# Largest head dim the kernels are compiled for (their register tiles).
MAX_HEAD_DIM = 256

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_count() -> None:
    global FLASH_LAUNCHES, FLASH_WGMMA_LAUNCHES
    FLASH_LAUNCHES = FLASH_WGMMA_LAUNCHES = 0


def _variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel ``flash_attention_fwd`` runs for this type and head dim
    (its C twin is ``flash_attention_variant``): the wgmma kernel takes
    bfloat16 with a head dim that is a multiple of 16 up to 256; float32
    and every other head dim take the CUDA-core kernel."""
    if dtype == torch.bfloat16 and 16 <= head_dim <= MAX_HEAD_DIM and head_dim % 16 == 0:
        return "wgmma"
    return "simt"


def _check(q, k, v, q_positions, kv_positions) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (BH, Sq, D) and k, v "
                         f"one (BHkv, Skv, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    BHkv, Skv, Dk = k.shape
    if Dk != D or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D} (q) and {Dk} (kv) "
                         f"must agree and lie in [1, {MAX_HEAD_DIM}]")
    if BHkv == 0 or BH % BHkv or Skv == 0:
        raise ValueError(f"flash_attention: {BH} q heads cannot share {BHkv} "
                         f"kv heads of length {Skv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, pos, n in (("q_positions", q_positions, Sq),
                         ("kv_positions", kv_positions, Skv)):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (n,):
            raise ValueError(f"flash_attention: {name} must be int32 ({n},), "
                             f"got {pos.dtype} {tuple(pos.shape)}")
    for name, t in (("k", k), ("v", v), ("q_positions", q_positions),
                    ("kv_positions", kv_positions)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def flash_attention_kernel(q, k, v, q_positions, kv_positions, *,
                           scale: float, variant: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel on folded inputs: q (BH, Sq, D), k/v
    (BHkv, Skv, D), contiguous CUDA tensors of one type (float32 or
    bfloat16), int32 positions (Sq,) and (Skv,). ``variant`` None takes
    :func:`_variant`'s kernel; ``"simt"`` forces the CUDA-core kernel (any
    type and head dim); ``"wgmma"`` is refused where :func:`_variant`
    would not pick it. Raises if the kernel cannot be built or launched;
    it never computes the result otherwise. Inputs that hold no data
    (:func:`~repro_torch.kernels.holds_no_data`) get an empty output of
    the kernel's shape and type, and no launch."""
    global FLASH_LAUNCHES, FLASH_WGMMA_LAUNCHES
    _check(q, k, v, q_positions, kv_positions)
    chosen = _variant(q.dtype, q.shape[2])
    if variant not in (None, *VARIANTS) or (variant == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"flash_attention_kernel: variant {variant!r} cannot run "
                         f"{q.dtype} with head dim {q.shape[2]} (it takes {chosen!r})")
    chosen = variant or chosen
    if holds_no_data(q):
        out = torch.empty_like(q)
        note_kernel("flash_attention", (q, k, v, q_positions, kv_positions), out)
        return out
    built = build.load("flash_attention.cu")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel: needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_positions", q_positions),
                    ("kv_positions", kv_positions)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_kernel: {name} must be contiguous")
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    launch = (built.lib.flash_attention_fwd if chosen == "wgmma"
              else built.lib.flash_attention_fwd_simt)
    with torch.cuda.device(q.device):
        code = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), BH, k.shape[0], Sq,
            k.shape[1], D, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(built, code, f"flash_attention ({chosen})")
    FLASH_LAUNCHES += 1
    FLASH_WGMMA_LAUNCHES += int(chosen == "wgmma")
    note_kernel("flash_attention", (q, k, v, q_positions, kv_positions), out)
    return out


def flash_attention(q, k, v, *, q_positions, kv_positions, scale) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); GQA by head grouping.

    ``q_positions`` may be (B, Sq) (uniform across the batch: prefill
    satisfies this, and row 0 is taken) or (Sq,); ``kv_positions`` is
    (Skv,). Returns (B, Sq, H, D) in q's type. Raises ``RuntimeError``
    where autograd would record it, on either device: it has no backward."""
    refuse_autograd("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if q_positions.dim() == 2:
        q_positions = q_positions[0]
    # (B, S, H, D) -> (B*H, S, D): where B or H is 1, reshape returns a
    # strided view, and the kernels read contiguous rows
    qf = q.transpose(1, 2).reshape(B * H, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, k.shape[1], k.shape[3]).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, v.shape[1], v.shape[3]).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    kpos = kv_positions.to(torch.int32).contiguous()
    if q.device.type == "cpu" and not holds_no_data(q):
        _check(qf, kf, vf, qpos, kpos)
        out = attention_ref(qf, kf, vf, qpos, kpos, scale)
    else:
        out = flash_attention_kernel(qf, kf, vf, qpos, kpos, scale=scale)
    return out.reshape(B, H, Sq, D).transpose(1, 2)
