"""ResNet50 (paper model 2) as a sequential layer-list model.

The port's copy of the reference's ``models/resnet50.py``. Layer names
align 1:1 with :func:`repro_torch.models.graph.resnet50_graph`.
Bottleneck residuals are carried explicitly; the downsample projection of
each stage's first block (a strided 1x1 conv) is folded into its ``_3``
unit, as in the cost table."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.cnn_common import (
    conv2d,
    dense,
    global_avg_pool,
    init_conv,
    init_dense,
    max_pool,
)
from repro_torch.models.graph import _R50_STAGES


class ResNet50:
    def __init__(self, image_size: int = 224, num_classes: int = 1000):
        self.image_size = image_size
        self.num_classes = num_classes
        self._build()

    def _build(self):
        specs: list[tuple[str, str, dict]] = []
        specs.append(("conv1", "conv", dict(k=7, c_in=3, c_out=64, stride=2, act="relu")))
        specs.append(("pool1", "maxpool", {}))
        c_in = 64
        for stage, (c_mid, c_out, n, s) in enumerate(_R50_STAGES, start=2):
            for i in range(n):
                stride = s if i == 0 else 1
                name = f"conv{stage}_block{i + 1}"
                specs.append((f"{name}_1", "b1",
                              dict(k=1, c_in=c_in, c_out=c_mid, stride=1)))
                specs.append((f"{name}_2", "b2",
                              dict(k=3, c_in=c_mid, c_out=c_mid, stride=stride)))
                specs.append((f"{name}_3", "b3",
                              dict(k=1, c_in=c_mid, c_out=c_out,
                                   proj=(i == 0), proj_c_in=c_in, stride=stride)))
                c_in = c_out
        specs.append(("avg_pool", "pool", {}))
        specs.append(("fc", "dense", dict(d_in=c_in, d_out=self.num_classes)))
        self._specs = specs
        self._by_name = {name: (kind, m) for name, kind, m in specs}
        self.layer_names = [name for name, _, _ in specs]

    def init(self, generator: torch.Generator | None = None, device=None) -> dict:
        """He-normal parameters drawn layer by layer in chain order from
        ``generator`` (default: seed 0) on the CPU, then moved to
        ``device`` (``None`` is the card; raises without one)."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        params = {}
        for name, kind, m in self._specs:
            if kind in ("conv", "b1", "b2"):
                params[name] = init_conv(g, m["k"], m["c_in"], m["c_out"], device=dev)
            elif kind == "b3":
                p = {"main": init_conv(g, m["k"], m["c_in"], m["c_out"], device=dev)}
                if m["proj"]:
                    p["proj"] = init_conv(g, 1, m["proj_c_in"], m["c_out"], device=dev)
                params[name] = p
            elif kind == "dense":
                params[name] = init_dense(g, m["d_in"], m["d_out"], device=dev)
            else:
                params[name] = {}
        return params

    def apply_layer(self, name: str, p: dict, carry):
        kind, m = self._by_name[name]
        if isinstance(carry, torch.Tensor):
            carry = {"h": carry}
        h = carry["h"]
        if kind == "conv":
            return {"h": conv2d(p, h, stride=m["stride"], act=m.get("act", "relu"))}
        if kind == "maxpool":
            return {"h": max_pool(h, 3, 2)}
        if kind == "b1":
            return {"h": conv2d(p, h, stride=1, act="relu"), "res": h}
        if kind == "b2":
            return {"h": conv2d(p, h, stride=m["stride"], act="relu"),
                    "res": carry["res"]}
        if kind == "b3":
            y = conv2d(p["main"], h, stride=1, act="none")
            res = carry["res"]
            if m["proj"]:
                res = conv2d(p["proj"], res, stride=m["stride"], act="none")
            return {"h": torch.relu(y + res)}
        if kind == "pool":
            return {"h": global_avg_pool(h)}
        if kind == "dense":
            return {"h": dense(p, h)}
        raise ValueError(kind)

    def input_shape(self, batch: int = 1):
        return (batch, self.image_size, self.image_size, 3)
