"""MobileNet-V2 (paper model 1) as a sequential layer-list model.

The port's copy of the reference's ``models/mobilenetv2.py``. Layer names
align 1:1 with :func:`repro_torch.models.graph.mobilenet_v2_graph`, so the
split executor, the cost model and the forward pass share the same chain
indices, including the paper's split points ``block_2_expand``,
``block_15_project_BN`` and ``block_16_project_BN``.

Residual skips are carried through the chain explicitly: the carry is
``{"h": main, "res": skip}``. At an intra-block cut the live set is
therefore main + skip; the skip is kept so split execution stays exactly
equal to the unsplit model.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.cnn_common import (
    conv2d,
    dense,
    global_avg_pool,
    init_conv,
    init_dense,
)
from repro_torch.models.graph import _MBV2_GROUPS, make_divisible


class MobileNetV2:
    def __init__(self, width: float = 0.35, image_size: int = 224,
                 num_classes: int = 1000):
        self.width = width
        self.image_size = image_size
        self.num_classes = num_classes
        self._build()

    def _build(self):
        # (name, kind, dict(meta)) in chain order; mirrors graph.py exactly
        specs: list[tuple[str, str, dict]] = []
        c1 = make_divisible(32 * self.width)
        specs.append(("Conv1", "conv", dict(k=3, c_in=3, c_out=c1, stride=2)))
        c_in = c1
        block_id = 0
        for t, c_base, n, s in _MBV2_GROUPS:
            c_out = make_divisible(c_base * self.width)
            for i in range(n):
                stride = s if i == 0 else 1
                prefix = "expanded_conv" if block_id == 0 else f"block_{block_id}"
                residual = stride == 1 and c_in == c_out
                c_mid = c_in * t
                if t != 1:
                    specs.append((f"{prefix}_expand", "expand",
                                  dict(k=1, c_in=c_in, c_out=c_mid, stride=1,
                                       residual=residual)))
                specs.append((f"{prefix}_depthwise", "dw",
                              dict(k=3, c=c_mid, stride=stride,
                                   residual=residual and t == 1)))
                specs.append((f"{prefix}_project_BN", "project",
                              dict(k=1, c_in=c_mid, c_out=c_out, stride=1,
                                   residual=residual)))
                c_in = c_out
                block_id += 1
        c_last = make_divisible(1280 * max(1.0, self.width))
        specs.append(("Conv_1", "conv", dict(k=1, c_in=c_in, c_out=c_last, stride=1)))
        specs.append(("global_pool", "pool", {}))
        specs.append(("Logits", "dense", dict(d_in=c_last, d_out=self.num_classes)))
        self._specs = specs
        self._by_name = {name: (kind, m) for name, kind, m in specs}
        self.layer_names = [name for name, _, _ in specs]

    # -- SequentialModel protocol -------------------------------------------
    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        """He-normal parameters drawn layer by layer in chain order from
        ``generator`` (default: seed 0) on the CPU, then moved to
        ``device`` (``None`` is the card; raises without one)."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        params = {}
        for name, kind, m in self._specs:
            if kind in ("conv", "expand", "project"):
                params[name] = init_conv(g, m["k"], m["c_in"], m["c_out"], device=dev)
            elif kind == "dw":
                params[name] = init_conv(g, m["k"], m["c"], m["c"], depthwise=True,
                                         device=dev)
            elif kind == "dense":
                params[name] = init_dense(g, m["d_in"], m["d_out"], device=dev)
            else:
                params[name] = {}
        return params

    def apply_layer(self, name: str, p: dict, carry):
        kind, m = self._by_name[name]
        if isinstance(carry, torch.Tensor):  # input image
            carry = {"h": carry}
        h = carry["h"]
        if kind == "conv":
            h = conv2d(p, h, stride=m["stride"])
            return {"h": h}
        if kind == "expand":
            out = {"h": conv2d(p, h, stride=1)}
            if m["residual"]:
                out["res"] = h
            return out
        if kind == "dw":
            out = {"h": conv2d(p, h, stride=m["stride"], depthwise=True)}
            if m.get("residual"):
                out["res"] = h
            elif "res" in carry:
                out["res"] = carry["res"]
            return out
        if kind == "project":
            y = conv2d(p, h, stride=1, act="none")
            if m["residual"]:
                y = y + carry["res"]
            return {"h": y}
        if kind == "pool":
            return {"h": global_avg_pool(h)}
        if kind == "dense":
            return {"h": dense(p, h)}
        raise ValueError(kind)

    def input_shape(self, batch: int = 1):
        return (batch, self.image_size, self.image_size, 3)
