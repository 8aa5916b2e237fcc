"""Static layer graphs: per-layer FLOPs / parameter bytes / activation bytes.

These tables are the planner's view of a model (the paper's "measured
per-layer inference and transmission costs"). They are pure-Python shape
math, the port's own copy of the reference's CNN graphs (MobileNet-V2
and ResNet50), node for node.

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
