"""Decoder-only LM: the reference's ``repro.models.transformer`` in PyTorch.

One model, configured by :class:`ModelConfig`, covers every config:

* dense / GQA / MQA attention (deepseek-7b, granite-34b), with the
  parallel residual (stablelm-12b: attention and FFN both read the same
  normed input, ``x + a + f``);
* MLA latent attention (minicpm3-4b), with the absorbed decode;
* the grouped top-k MoE FFN (granite-moe-1b-a400m, qwen3-moe-235b-a22b);
* the audio-codes frontend (musicgen-medium: one embedding table per
  codebook, one head per codebook) and the vision-embeds frontend with
  M-RoPE and the int8 KV cache (qwen2-vl-72b);
* the tied head (``tie_embeddings``);
* block patterns (``cfg.pattern``): Mamba2 with one shared attention
  block applied at every ``attn`` position (zamba2-1.2b,
  ``shared_attn``), mLSTM and sLSTM stacks (xlstm-1.3b); the mixers are
  :mod:`repro_torch.models.ssm`'s.

:class:`Transformer` holds the weights: an embedding, the blocks and a
final norm with the LM head. An all-attention stack without
``shared_attn`` is homogeneous: ``blocks`` is a ``ModuleList`` of
pre-norm attention blocks, one per layer. Any other pattern is
heterogeneous: ``blocks`` is a ``ModuleDict`` of per-kind stacks in
pattern order (``blocks.mamba.<i>``, ``blocks.mlstm.<i>``, ...; an
``attn`` stack, or the one ``blocks.attn_shared`` block), as the
reference's per-kind parameter stacks. There is no ``lax.scan``: the
blocks run in a Python loop, so no run grouping is needed. The
reference's functional entry points keep their names and take the module
as ``params``:

* :func:`forward` ``(cfg, params, inputs, cache, decode)`` ->
  ``(logits, cache)``;
* :func:`prefill` runs it with a cache, :func:`serve_step` with a cache
  and ``decode=True`` (MLA's absorbed path, the recurrent steps);
* :func:`loss_fn` is the uncached forward's :func:`cross_entropy`,
  differentiable where grad mode is on (``launch.steps.make_train_step``
  takes its gradients), with blocks checkpointed under ``cfg.remat``;
  :func:`param_count` counts the parameters;
* :func:`init_params` makes a module of random weights from a seeded
  ``torch.Generator``; :func:`init_cache` a homogeneous stack's stacked
  cache of shape (L, B, Smax, ...): ``{"k", "v"}``, ``{"c_kv",
  "k_rope"}`` for MLA, or int8 ``{"k", "v"}`` with float32 ``{"k_scale",
  "v_scale"}``; a heterogeneous pattern's tuple of per-layer caches.

Inputs: ``tokens`` (B, S) int, ``codes`` (B, S, n_codebooks) int for the
audio frontend, or ``embeds`` (B, S, d_model) for the vision frontend
(cast to the compute type); optional ``positions`` (B, S), or (3, B, S)
for M-RoPE, and ``cur_index``.

Attention caches are updated IN PLACE and returned (the reference returns
new ones): a full-width cache is too large to copy per step. A
heterogeneous forward with a cache returns a new tuple: the attention
entries are the dicts it was given, written in place; a recurrent entry
is the block's new state. As in the reference, a Mamba2 or mLSTM block
run without ``decode`` (``prefill``) returns ``None`` for its state, and
the recurrent steps ignore ``positions``: a slot idle at -1 still
advances its state.

Under a tensor-parallel context (:mod:`repro_torch.parallel.tensor_parallel`,
entered by ``launch.steps``' cells) the layers compute on their local
shards and gather what else they need for their own call; the block
boundaries stay (B, S, D), replicated over "model" (the reference's
``maybe_constrain_act``), a cache entry is read where it is stored (its
DP batch shard, its kv heads or, in decode, its sequence split) or else
gathered for its own layer, and the logits come back vocab-sharded where
"model" divides the padded vocab (``TP.vocab_sharded``: the rank's
columns, (..., n_codebooks x Vp / m)),
as the reference's ``maybe_constrain_logits`` pins them; :func:`loss_fn`
then takes the vocab-parallel cross entropy.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import ieee_float32, resolve_device
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLA,
    MLP,
    Attention,
    Embed,
    LMHead,
    MoE,
    RMSNorm,
    torch_dtype,
)
from repro_torch.parallel import tensor_parallel as TP

__all__ = ["Block", "MixerBlock", "Transformer", "check_supported", "cross_entropy", "forward",
           "init_cache", "init_params", "is_homogeneous", "loss_fn", "param_count", "prefill",
           "serve_step"]

BLOCK_KINDS = ("attn", "mamba", "mlstm", "slstm")


def is_homogeneous(cfg: ModelConfig) -> bool:
    """All-attention blocks without a shared block: one stacked layout."""
    return all(k == "attn" for k in cfg.pattern) and not cfg.shared_attn


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` naming a block kind of ``cfg.pattern`` that
    neither the reference nor the port knows."""
    for kind in cfg.pattern:
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")


class Block(nn.Module):
    """The pre-norm attention block: attention (MLA or GQA), then the MLP
    or MoE, sequential or with the parallel residual."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.d_model, **kw)
        self.attn = MLA(cfg, **kw) if cfg.use_mla else Attention(cfg, **kw)
        # norm2 is held (and unused) with the parallel residual, as in the reference
        self.norm2 = RMSNorm(cfg.d_model, **kw)
        self.ff = MoE(cfg, **kw) if cfg.is_moe else MLP(cfg, **kw)

    def _ff(self, cfg, h, partial: bool = False):
        return self.ff(cfg, h) if cfg.is_moe else self.ff(h, partial=partial)

    def forward(self, cfg: ModelConfig, x, positions, cache=None, offset: int = 0,
                decode: bool = False):
        """With the parallel residual, tensor-parallel attention and FFN
        partials are summed in float32 before one reduction over "model"
        (``TP.residual``; ``x + a + f`` outside a mesh)."""
        h = self.norm1(x, cfg.norm_eps)
        if cfg.use_mla:
            a = self.attn(cfg, h, positions, cache, offset,
                          absorbed=decode and cfg.mla_absorbed_decode)
        else:
            a = self.attn(cfg, h, positions, cache, offset, partial=cfg.parallel_residual)
        if cfg.parallel_residual:
            return TP.residual(x, a, self._ff(cfg, h, partial=True))
        x = x + a
        return x + self._ff(cfg, self.norm2(x, cfg.norm_eps))


_MIXERS = {"mamba": ssm.Mamba2, "mlstm": ssm.MLSTM, "slstm": ssm.SLSTM}


class MixerBlock(nn.Module):
    """A recurrent block: RMSNorm, then the ``kind`` mixer of
    :mod:`repro_torch.models.ssm`, added to the residual."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, dtype):
        super().__init__()
        self.kind = kind
        self.norm = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mixer = _MIXERS[kind](cfg, device=device, dtype=dtype)

    def forward(self, cfg: ModelConfig, x, cache=None, decode: bool = False):
        """(x + mixer(norm(x)), the new state). Mamba2 and mLSTM run their
        chunked forms without ``decode`` and return no state; sLSTM always
        runs its cell from ``cache`` (or a fresh state) and returns it.
        Under a tensor-parallel context the mixer runs whole on weights and
        a state gathered for the call; the new state comes back as the
        rank's shards."""
        h = self.norm(x, cfg.norm_eps)
        with TP.gathered(self.mixer), TP.layer_cache(cache, write_back=False) as state:
            if self.kind == "slstm":
                y, new = ssm.slstm_forward(cfg, self.mixer, h, state)
            elif decode:
                step = ssm.mamba_step if self.kind == "mamba" else ssm.mlstm_step
                y, new = step(cfg, self.mixer, h, state)
            else:
                chunked = ssm.mamba_chunked if self.kind == "mamba" else ssm.mlstm_chunked
                y, new = chunked(cfg, self.mixer, h, chunk=cfg.scan_chunk), None
        return x + y, TP.local_state(new, cache)


class Transformer(nn.Module):
    """The weights of one decoder. ``forward(cfg, inputs, cache, decode)``
    takes the config per call, so a step may run with its own settings
    (``make_prefill_step`` turns on ``causal_skip``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=resolve_device(device), dtype=dtype or torch_dtype(cfg.dtype))
        self.embed = Embed(cfg, **kw)
        if is_homogeneous(cfg):
            self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_layers))
        else:
            stacks = {}
            for kind in dict.fromkeys(cfg.pattern):  # kinds in pattern order
                if kind == "attn" and cfg.shared_attn:
                    stacks["attn_shared"] = Block(cfg, **kw)
                    continue
                n = cfg.pattern.count(kind)
                stacks[kind] = nn.ModuleList(
                    Block(cfg, **kw) if kind == "attn" else MixerBlock(cfg, kind, **kw)
                    for _ in range(n))
            self.blocks = nn.ModuleDict(stacks)
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.lm_head = LMHead(cfg, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _pattern_blocks(self, cfg: ModelConfig) -> list:
        """(kind, block) per position of a heterogeneous ``cfg.pattern``:
        the i-th block of a kind is its stack's i-th, and every ``attn``
        position of a ``shared_attn`` config takes the one shared block."""
        seen: dict[str, int] = {}
        out = []
        for kind in cfg.pattern:
            if kind == "attn" and cfg.shared_attn:
                out.append((kind, self.blocks["attn_shared"]))
                continue
            i = seen[kind] = seen.get(kind, -1) + 1
            out.append((kind, self.blocks[kind][i]))
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def _embed_inputs(self, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
        dev = self.device
        if cfg.frontend == "vision_embeds":
            # precomputed patch / text embeddings arrive directly
            return torch.as_tensor(inputs["embeds"], device=dev).to(self.embed.table.dtype)
        key = "codes" if cfg.frontend == "audio_codes" else "tokens"
        return self.embed(torch.as_tensor(inputs[key], device=dev).long())

    def float32_scope(self):
        """On the card, :func:`~repro_torch.device.ieee_float32`: the float32
        products (attention scores and PV, MLA's absorbed decode, the
        recurrent mixers, the LM head) run in IEEE float32 whatever the
        caller's TF32 settings. Entered once per pass, not per product,
        because decode is bound by the host's enqueue; the train step holds
        it over the backward too. A no-op on the CPU."""
        return ieee_float32() if self.device.type == "cuda" else nullcontext()

    @torch.no_grad()
    def forward(self, cfg: ModelConfig, inputs: dict, cache: dict | tuple | None = None,
                decode: bool = False):
        with self.float32_scope():
            return self._forward(cfg, inputs, cache, decode)

    def _forward(self, cfg: ModelConfig, inputs: dict, cache, decode: bool):
        dev = self.device
        x = self._embed_inputs(cfg, inputs)
        B, S = x.shape[:2]
        positions = inputs.get("positions")
        if positions is None:
            offset = int(inputs.get("cur_index", 0))
            positions = (offset + torch.arange(S, dtype=torch.int32, device=dev)
                         ).expand(B, S)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, B, S)
        else:
            positions = torch.as_tensor(positions, device=dev).to(torch.int32)
            pos_ids = positions[0] if positions.dim() == 3 else positions
            # the prefill cache write's offset (one host read per call)
            offset = int(pos_ids[0, 0]) if cache is not None and S > 1 else 0
        # activation checkpointing where autograd records an uncached pass
        # (the train path): the reference's jax.checkpoint(nothing_saveable)
        remat = cfg.remat and cache is None and not decode and torch.is_grad_enabled()
        if isinstance(self.blocks, nn.ModuleList) and cache is None:
            x = self._stack(cfg, x, positions, decode, remat)
        elif isinstance(self.blocks, nn.ModuleList):
            for i, block in enumerate(self.blocks):
                layer_cache = {k: t[i] for k, t in cache.items()}
                x = block(cfg, x, positions, layer_cache, offset, decode)
        else:
            states = []
            for i, (kind, block) in enumerate(self._pattern_blocks(cfg)):
                layer_cache = None if cache is None else cache[i]
                if remat:
                    x = checkpoint(self._block_fn(cfg, kind, block, positions), x,
                                   use_reentrant=False)
                elif kind == "attn":
                    x = block(cfg, x, positions, layer_cache, offset, decode)
                else:
                    x, layer_cache = block(cfg, x, layer_cache, decode)
                states.append(layer_cache)
            cache = None if cache is None else tuple(states)
        x = self.final_norm(x, cfg.norm_eps)
        # a tied head reads the table whole, gathered for the call
        with TP.gathered(self.embed) if cfg.tie_embeddings else nullcontext():
            return self.lm_head(x, self.embed.table), cache

    def _stack(self, cfg: ModelConfig, x, positions, decode: bool, remat: bool):
        """A homogeneous stack without a cache. With ``remat`` each block is
        checkpointed, or each group of ``cfg.remat_group`` blocks where that
        divides the depth (only the group boundaries are kept)."""
        g = cfg.remat_group if remat and cfg.n_layers % cfg.remat_group == 0 else 1
        blocks = list(self.blocks)
        for i in range(0, len(blocks), g):
            def run(h, group=blocks[i:i + g]):
                # a checkpointed group's recompute gathers its leaves again
                with TP.hooks_off() if remat else nullcontext():
                    for block in group:
                        h = block(cfg, h, positions, None, 0, decode)
                return h

            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        return x

    @staticmethod
    def _block_fn(cfg: ModelConfig, kind: str, block, positions):
        """One uncached block of a pattern as a function of x alone (a
        mixer's state is dropped), for checkpointing; its recompute gathers
        its leaves again."""
        def run(h):
            with TP.hooks_off():
                if kind == "attn":
                    return block(cfg, h, positions, None, 0, False)
                return block(cfg, h, None, False)[0]

        return run


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (default: the card) with the
    reference's init distribution: every projection normal / sqrt(fan_in)
    with fan_in its first dim (the attention output normal / sqrt(H*Dh);
    the stacked experts (E, d, f) / sqrt(E); the MoE router float32;
    Mamba2's conv normal * 0.5 with a zero bias, ``A_log = log(linspace(1,
    16, nh))``, ``D`` one, ``dt_bias`` zero; mLSTM's ``f_bias`` 3; sLSTM's
    float32 ``r`` normal / sqrt(ph)), embedding and head normal * 0.02,
    norm scales one. ``generator`` must
    live on ``device`` (default: a fresh one seeded 0)."""
    model = Transformer(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    model.init_weights(generator)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, device=None) -> dict | tuple:
    """Decode cache of zeros. A homogeneous stack's is one dict, each entry
    (L, B, Smax, ...): ``{"k", "v"}`` (Hkv, Dh) of ``dtype`` (default:
    the config's activation type); MLA's latents ``{"c_kv":
    kv_lora_rank, "k_rope": rope_dim}``; and with ``kv_cache_dtype="int8"``
    and no ``dtype`` given, int8 ``{"k", "v"}`` with float32 ``{"k_scale",
    "v_scale"}`` (Hkv). A heterogeneous pattern's is a tuple with one
    cache per position: the same attention entries without the L axis
    (each application of a shared block has its own), or the mixer's
    state (``ssm.init_mamba_cache`` with its conv context of ``dtype``,
    ``init_mlstm_cache``, ``init_slstm_cache``)."""
    check_supported(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device)
    if cfg.use_mla:
        shapes = {"c_kv": ((cfg.kv_lora_rank,), dt), "k_rope": ((cfg.qk_rope_head_dim,), dt)}
    elif dtype is None and cfg.kv_cache_dtype == "int8":
        kv = ((cfg.n_kv_heads, cfg.head_dim), torch.int8)
        scale = ((cfg.n_kv_heads,), torch.float32)
        shapes = {"k": kv, "v": kv, "k_scale": scale, "v_scale": scale}
    else:
        kv = ((cfg.n_kv_heads, cfg.head_dim), dt)
        shapes = {"k": kv, "v": kv}

    def attn_cache(lead):
        return {name: torch.zeros(lead + shape, dtype=t, device=dev)
                for name, (shape, t) in shapes.items()}

    if is_homogeneous(cfg):
        return attn_cache((cfg.n_layers, batch, max_seq))
    states = {"mamba": lambda: ssm.init_mamba_cache(cfg, batch, dtype=dt, device=dev),
              "mlstm": lambda: ssm.init_mlstm_cache(cfg, batch, device=dev),
              "slstm": lambda: ssm.init_slstm_cache(cfg, batch, device=dev),
              "attn": lambda: attn_cache((batch, max_seq))}
    return tuple(states[kind]() for kind in cfg.pattern)


def forward(cfg: ModelConfig, params: Transformer, inputs: dict,
            cache: dict | tuple | None = None, decode: bool = False):
    """``(logits, cache)``; ``inputs`` as the module docstring says.
    Logits are float32 over the padded vocab, (B, S, Vp) or (B, S,
    n_codebooks, Vp). ``decode`` takes MLA's absorbed path where
    ``cfg.mla_absorbed_decode`` and the recurrent blocks' one-token
    steps."""
    return params(cfg, inputs, cache, decode)


def serve_step(cfg: ModelConfig, params: Transformer, inputs: dict, cache):
    """One decode step: new token(s) + cache -> next-token logits + cache."""
    return forward(cfg, params, inputs, cache, decode=True)


def prefill(cfg: ModelConfig, params: Transformer, inputs: dict, cache):
    """Prefill a prompt into the cache; attention reads the whole cache.
    On a heterogeneous pattern the Mamba2 and mLSTM entries come back
    ``None``, as the reference's do (their chunked forms keep no state):
    such a cache cannot be decoded from, so a prompt for decode goes
    token by token through :func:`serve_step`, as the ``Server`` feeds
    it."""
    return forward(cfg, params, inputs, cache, decode=False)


def param_count(params) -> int:
    """Number of parameter values (a module's parameters, or a mapping's
    tensors): the reference's leaf sizes summed."""
    leaves = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(p.numel() for p in leaves)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over every leading axis (codebooks
    included). logits (..., V) in float32; labels (...) ids. The gold
    logit is taken with an index-compare mask, as the reference does (no
    scatter: its backward is the elementwise softmax minus one-hot)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    slot = torch.arange(logits.shape[-1], device=logits.device)
    onehot = labels.long()[..., None] == slot
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    return torch.mean(lse - gold)


def loss_fn(cfg: ModelConfig, params: Transformer, batch: dict) -> torch.Tensor:
    """The uncached forward's mean cross entropy against ``batch["labels"]``,
    differentiable where grad mode is on (the module's parameters must
    require grad for a gradient to reach them; ``launch.steps`` turns that
    on for the step). With ``cfg.remat`` and grad mode, blocks are
    checkpointed. The reference's ``maybe_constrain_logits`` pins the
    logits vocab-sharded on a mesh and is the identity outside one; the
    port's counterpart is the tensor-parallel context: where the head's
    logits come back vocab-sharded (``TP.vocab_sharded``) the loss is
    :func:`~repro_torch.parallel.tensor_parallel.cross_entropy`, reduced
    over "model". On the card the pass runs in IEEE float32
    (:meth:`Transformer.float32_scope`); hold the scope over the backward
    too, as the train step does, or checkpointed blocks recompute under
    the caller's TF32 settings."""
    with params.float32_scope():
        logits, _ = params._forward(cfg, batch, None, False)
        labels = torch.as_tensor(batch["labels"], device=params.device)
        if TP.vocab_sharded(cfg):
            return TP.cross_entropy(logits, labels, cfg.n_codebooks, cfg.vocab_padded)
        return cross_entropy(logits, labels)
