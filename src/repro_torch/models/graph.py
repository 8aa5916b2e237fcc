"""Static layer graphs: per-layer FLOPs / parameter bytes / activation bytes.

These tables are the planner's view of a model (the paper's "measured
per-layer inference and transmission costs"). They are pure-Python shape
math, the port's own copy of the reference's graphs, node for node: the
CNNs (MobileNet-V2, ResNet50) and the LM block chains
(:func:`transformer_layer_graph`, :func:`arch_layer_graph` for any
:class:`~repro_torch.models.config.ModelConfig`, :func:`ssm_layer_graph`),
whose nodes equal the reference's with ``==``.

Conventions:
  * ``flops`` counts multiply-adds as 2 ops.
  * ``act_bytes`` is the size of the single tensor crossing a cut placed
    *after* the node, in deployment dtype (int8 for the TinyML path)
    — the paper's Eq. 1 sequential-chain view
    (Table II packet counts confirm only the main tensor is shipped).
  * ``work_bytes`` approximates the peak resident activation set for the
    node (input + output), used for device memory feasibility.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.latency import LayerCost, ModelCostProfile


@dataclass(frozen=True)
class LayerNode:
    name: str
    flops: float
    param_count: int
    out_elems: int  # elements of the output tensor (act bytes = elems * act_dtype)
    work_elems: int  # peak resident activation elements


@dataclass(frozen=True)
class LayerGraph:
    name: str
    nodes: tuple[LayerNode, ...]
    input_elems: int

    @property
    def num_layers(self) -> int:
        return len(self.nodes)

    @property
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    @property
    def total_params(self) -> int:
        return sum(n.param_count for n in self.nodes)

    def node_index(self, name: str) -> int:
        """1-indexed position of a named layer (for paper split points)."""
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i + 1
        raise KeyError(name)

    def cost_profile(
        self,
        flops_per_s: float,
        act_dtype_bytes: int = 1,
        param_dtype_bytes: int = 1,
    ) -> ModelCostProfile:
        """Convert to a ``ModelCostProfile`` with FLOP-proportional per-layer
        inference times at ``flops_per_s`` (the reference device rate)."""
        layers = [
            LayerCost(
                name=n.name,
                t_infer_s=n.flops / flops_per_s,
                act_bytes=n.out_elems * act_dtype_bytes,
                param_bytes=n.param_count * param_dtype_bytes,
                work_bytes=n.work_elems * act_dtype_bytes,
                flops=n.flops,
            )
            for n in self.nodes
        ]
        return ModelCostProfile(
            name=self.name, layers=tuple(layers), input_bytes=self.input_elems * act_dtype_bytes
        )


# ---------------------------------------------------------------------------
# MobileNet-V2 (paper model 1) — width multiplier, Keras block naming
# ---------------------------------------------------------------------------


def make_divisible(v: float, divisor: int = 8) -> int:
    """TF-slim channel rounding used by MobileNet width multipliers."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (expansion t, base channels c, repeats n, first stride s)
_MBV2_GROUPS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def mobilenet_v2_graph(
    width: float = 0.35, image_size: int = 224, num_classes: int = 1000
) -> LayerGraph:
    """MobileNet-V2 flattened to its sequential sub-layer chain.

    Paper split points exist by name: ``block_2_expand`` (56x56x48 @224),
    ``block_15_project`` (7x7x56), ``block_16_project_BN`` (7x7x112)."""
    nodes: list[LayerNode] = []
    h = image_size // 2
    c_in = 3
    c1 = make_divisible(32 * width)
    in_elems = image_size * image_size * 3

    def conv(name, h_out, c_out, c_in, k, in_elems_):
        out = h_out * h_out * c_out
        nodes.append(
            LayerNode(
                name,
                flops=2.0 * h_out * h_out * c_out * c_in * k * k,
                param_count=c_in * c_out * k * k + c_out,
                out_elems=out,
                work_elems=in_elems_ + out,
            )
        )
        return out

    def dwconv(name, h_out, c, k, in_elems_):
        out = h_out * h_out * c
        nodes.append(
            LayerNode(
                name,
                flops=2.0 * h_out * h_out * c * k * k,
                param_count=c * k * k + c,
                out_elems=out,
                work_elems=in_elems_ + out,
            )
        )
        return out

    cur = conv("Conv1", h, c1, 3, 3, in_elems)
    c_in = c1
    block_id = 0
    for t, c_base, n, s in _MBV2_GROUPS:
        c_out = make_divisible(c_base * width)
        for i in range(n):
            stride = s if i == 0 else 1
            h_out = h // stride
            prefix = "expanded_conv" if block_id == 0 else f"block_{block_id}"
            if t != 1:
                cur = conv(f"{prefix}_expand", h, c_in * t, c_in, 1, cur)
                c_mid = c_in * t
            else:
                c_mid = c_in
            cur = dwconv(f"{prefix}_depthwise", h_out, c_mid, 3, cur)
            # project conv + folded BN (+ residual add when stride=1, c_in==c_out)
            cur = conv(f"{prefix}_project_BN", h_out, c_out, c_mid, 1, cur)
            h, c_in = h_out, c_out
            block_id += 1
    cur = conv("Conv_1", h, make_divisible(1280 * max(1.0, width)), c_in, 1, cur)
    c_last = make_divisible(1280 * max(1.0, width))
    # global average pool
    nodes.append(
        LayerNode("global_pool", flops=float(h * h * c_last), param_count=0,
                  out_elems=c_last, work_elems=cur + c_last)
    )
    # classifier
    nodes.append(
        LayerNode("Logits", flops=2.0 * c_last * num_classes,
                  param_count=c_last * num_classes + num_classes,
                  out_elems=num_classes, work_elems=c_last + num_classes)
    )
    return LayerGraph(f"mobilenet_v2_{width}", tuple(nodes), in_elems)


# ---------------------------------------------------------------------------
# ResNet50 (paper model 2)
# ---------------------------------------------------------------------------

_R50_STAGES = [  # (mid channels, out channels, repeats, first stride)
    (64, 256, 3, 1),
    (128, 512, 4, 2),
    (256, 1024, 6, 2),
    (512, 2048, 3, 2),
]


def resnet50_graph(image_size: int = 224, num_classes: int = 1000) -> LayerGraph:
    nodes: list[LayerNode] = []
    in_elems = image_size * image_size * 3

    def conv(name, h_out, c_out, c_in, k, in_elems_):
        out = h_out * h_out * c_out
        nodes.append(
            LayerNode(
                name,
                flops=2.0 * h_out * h_out * c_out * c_in * k * k,
                param_count=c_in * c_out * k * k + c_out,
                out_elems=out,
                work_elems=in_elems_ + out,
            )
        )
        return out

    h = image_size // 2
    cur = conv("conv1", h, 64, 3, 7, in_elems)
    h //= 2  # maxpool
    nodes.append(LayerNode("pool1", flops=float(h * h * 64 * 9), param_count=0,
                           out_elems=h * h * 64, work_elems=cur + h * h * 64))
    cur = h * h * 64
    c_in = 64
    for stage, (c_mid, c_out, n, s) in enumerate(_R50_STAGES, start=2):
        for i in range(n):
            stride = s if i == 0 else 1
            h_out = h // stride
            name = f"conv{stage}_block{i + 1}"
            cur = conv(f"{name}_1", h, c_mid, c_in, 1, cur)
            cur = conv(f"{name}_2", h_out, c_mid, c_mid, 3, cur)
            # 1x1 expand; downsample projection folded into the first block
            proj = c_in * c_out + c_out if i == 0 else 0
            out = h_out * h_out * c_out
            nodes.append(
                LayerNode(
                    f"{name}_3",
                    flops=2.0 * h_out * h_out * c_out * c_mid
                    + (2.0 * h_out * h_out * c_out * c_in if i == 0 else 0.0),
                    param_count=c_mid * c_out + c_out + proj,
                    out_elems=out,
                    work_elems=cur + out,
                )
            )
            cur = out
            h, c_in = h_out, c_out
    nodes.append(LayerNode("avg_pool", flops=float(h * h * c_in), param_count=0,
                           out_elems=c_in, work_elems=cur + c_in))
    nodes.append(LayerNode("fc", flops=2.0 * c_in * num_classes,
                           param_count=c_in * num_classes + num_classes,
                           out_elems=num_classes, work_elems=c_in + num_classes))
    return LayerGraph("resnet50", tuple(nodes), in_elems)


# ---------------------------------------------------------------------------
# Transformer-family graphs (the 10 assigned architectures)
# ---------------------------------------------------------------------------


def _attn_flops(b: int, s: int, d: int, n_heads: int, n_kv: int, head_dim: int,
                kv_len: int | None = None) -> float:
    """QKV + scores + AV + out-proj flops for one attention layer."""
    kv_len = s if kv_len is None else kv_len
    q_proj = 2.0 * b * s * d * (n_heads * head_dim)
    kv_proj = 2.0 * b * s * d * (2 * n_kv * head_dim)
    scores = 2.0 * b * n_heads * s * kv_len * head_dim
    av = 2.0 * b * n_heads * s * kv_len * head_dim
    out = 2.0 * b * s * (n_heads * head_dim) * d
    return q_proj + kv_proj + scores + av + out


def transformer_layer_graph(
    *,
    name: str,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    vocab: int,
    batch: int,
    seq: int,
    head_dim: int | None = None,
    n_experts: int = 0,
    top_k: int = 0,
    gated_mlp: bool = True,
    kv_len: int | None = None,
    tie_embeddings: bool = False,
) -> LayerGraph:
    """Per-block layer graph for a decoder-only LM.

    Each transformer block is one node (split candidates are block
    boundaries — KV caches make intra-block cuts impractical). The
    embedding and LM head are separate nodes. ``kv_len`` models decode
    steps (s=1 query against a long cache)."""
    head_dim = head_dim or d_model // n_heads
    nodes: list[LayerNode] = []
    act = batch * seq * d_model
    in_elems = batch * seq  # token ids

    nodes.append(
        LayerNode("embed", flops=0.0, param_count=vocab * d_model,
                  out_elems=act, work_elems=batch * seq + act)
    )
    mlp_mats = 3 if gated_mlp else 2
    for i in range(n_layers):
        attn = _attn_flops(batch, seq, d_model, n_heads, n_kv_heads, head_dim, kv_len)
        if n_experts > 0:
            ff = 2.0 * batch * seq * d_model * d_ff * mlp_mats * top_k
            router = 2.0 * batch * seq * d_model * n_experts
            ff_params = n_experts * (mlp_mats * d_model * d_ff) + d_model * n_experts
            ff += router
        else:
            ff = 2.0 * batch * seq * d_model * d_ff * mlp_mats
            ff_params = mlp_mats * d_model * d_ff
        attn_params = (n_heads + 2 * n_kv_heads) * head_dim * d_model + n_heads * head_dim * d_model
        nodes.append(
            LayerNode(
                f"block_{i}",
                flops=attn + ff,
                param_count=attn_params + ff_params + 2 * d_model,
                out_elems=act,
                work_elems=2 * act,
            )
        )
    head_params = 0 if tie_embeddings else vocab * d_model
    nodes.append(
        LayerNode("lm_head", flops=2.0 * batch * seq * d_model * vocab,
                  param_count=head_params, out_elems=batch * seq * vocab,
                  work_elems=act + batch * seq * vocab)
    )
    return LayerGraph(name, tuple(nodes), in_elems)


def arch_layer_graph(cfg, batch: int, seq: int, kv_len: int | None = None,
                     act_dtype_bytes: int = 2) -> LayerGraph:
    """LayerGraph for any assigned :class:`ModelConfig` — walks the block
    pattern with per-kind FLOP/param/activation formulas. Used by the
    analytic roofline terms and by :func:`plan_pipeline` on real archs."""
    d = cfg.d_model
    nodes: list[LayerNode] = []
    act = batch * seq * d
    embed_params = cfg.vocab * d * max(1, cfg.n_codebooks)
    nodes.append(LayerNode("embed", flops=0.0, param_count=embed_params,
                           out_elems=act, work_elems=2 * act))
    for i, kind in enumerate(cfg.pattern):
        if kind == "attn":
            if cfg.use_mla:
                dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
                H = cfg.n_heads
                kv = seq if kv_len is None else kv_len
                f = 2.0 * batch * seq * (
                    d * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
                    + d * (cfg.kv_lora_rank + dr))
                # absorbed-score decode path: latent-space attention
                f += 2.0 * batch * H * seq * kv * (cfg.kv_lora_rank + dr) * 2
                f += 2.0 * batch * seq * H * dv * d
                p = (d * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
                     + d * (cfg.kv_lora_rank + dr)
                     + cfg.kv_lora_rank * H * (dn + dv) + H * dv * d)
            else:
                f = _attn_flops(batch, seq, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, kv_len)
                p = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * d
                     + cfg.n_heads * cfg.head_dim * d)
            if cfg.is_moe:
                mats = 3 if cfg.gated_mlp else 2
                f += 2.0 * batch * seq * d * cfg.d_ff * mats * cfg.top_k
                f += 2.0 * batch * seq * d * cfg.n_experts
                p += cfg.n_experts * mats * d * cfg.d_ff + d * cfg.n_experts
            elif cfg.d_ff:
                mats = 3 if cfg.gated_mlp else 2
                f += 2.0 * batch * seq * d * cfg.d_ff * mats
                p += mats * d * cfg.d_ff
            nodes.append(LayerNode(f"block_{i}_attn", flops=f, param_count=p + 2 * d,
                                   out_elems=act, work_elems=2 * act))
        elif kind == "mamba":
            di, ds = cfg.d_inner, cfg.ssm_state
            nh = di // cfg.ssm_head_dim
            f = 2.0 * batch * seq * (d * (2 * di + 2 * ds + nh)  # in_proj
                                     + (di + 2 * ds) * cfg.d_conv  # conv
                                     + 2 * di * ds  # scan state update + out
                                     + di * d)  # out_proj
            p = (d * (2 * di + 2 * ds + nh) + (di + 2 * ds) * cfg.d_conv
                 + 2 * nh + nh + di * d)
            nodes.append(LayerNode(f"block_{i}_mamba", flops=f, param_count=p + d,
                                   out_elems=act, work_elems=2 * act))
        elif kind in ("mlstm", "slstm"):
            di = cfg.d_inner
            f = 2.0 * batch * seq * (d * (3 * di + 2 * cfg.n_heads) + di * d)
            if kind == "mlstm":
                ph = di // cfg.n_heads
                # chunk-parallel matrix-memory terms
                f += 2.0 * batch * seq * cfg.n_heads * ph * ph * 2
            else:
                ph = di // cfg.n_heads
                f += 2.0 * batch * seq * cfg.n_heads * ph * 4 * ph
            p = d * (4 * di if kind == "slstm" else 3 * di + 2 * cfg.n_heads) + di * d
            nodes.append(LayerNode(f"block_{i}_{kind}", flops=f, param_count=p + d,
                                   out_elems=act, work_elems=2 * act))
    head_p = 0 if cfg.tie_embeddings else cfg.vocab_padded * d * max(1, cfg.n_codebooks)
    nodes.append(LayerNode(
        "lm_head",
        flops=2.0 * batch * seq * d * cfg.vocab_padded * max(1, cfg.n_codebooks),
        param_count=head_p,
        out_elems=batch * seq * cfg.vocab_padded,
        work_elems=act + batch * seq * cfg.vocab_padded))
    return LayerGraph(cfg.name, tuple(nodes), batch * seq)


def ssm_layer_graph(
    *,
    name: str,
    n_layers: int,
    d_model: int,
    d_state: int,
    vocab: int,
    batch: int,
    seq: int,
    expand: int = 2,
    conv_dim: int = 4,
) -> LayerGraph:
    """Mamba2-style SSM block chain (used for zamba2 / xlstm planning)."""
    d_inner = expand * d_model
    nodes: list[LayerNode] = []
    act = batch * seq * d_model
    nodes.append(LayerNode("embed", flops=0.0, param_count=vocab * d_model,
                           out_elems=act, work_elems=act))
    for i in range(n_layers):
        in_proj = 2.0 * batch * seq * d_model * (2 * d_inner)
        conv = 2.0 * batch * seq * d_inner * conv_dim
        scan = 2.0 * batch * seq * d_inner * d_state * 2
        out_proj = 2.0 * batch * seq * d_inner * d_model
        params = d_model * 2 * d_inner + d_inner * conv_dim + d_inner * d_state * 2 + d_inner * d_model
        nodes.append(LayerNode(f"ssm_block_{i}", flops=in_proj + conv + scan + out_proj,
                               param_count=params + 2 * d_model, out_elems=act, work_elems=2 * act))
    nodes.append(LayerNode("lm_head", flops=2.0 * batch * seq * d_model * vocab,
                           param_count=vocab * d_model, out_elems=batch * seq * vocab,
                           work_elems=act + batch * seq * vocab))
    return LayerGraph(name, tuple(nodes), batch * seq)
