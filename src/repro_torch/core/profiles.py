"""Measured device/link profiles (paper Tables I-IV).

Calibration notes (all constants traceable to the paper):

* **Packet counts** follow exactly from activation byte sizes and MTUs
  (Table I): e.g. block_2_expand = 56*56*48 = 150528 B int8 ->
  ceil(150528/1460) = 104 UDP packets (Table II row 2). BLE's MTU is 512 B
  (GATT); Table II's 603-packet BLE row corresponds to app-level 250 B
  chunking — we keep MTU=512 and note the discrepancy in the benchmark.

* **Per-packet times** are least-squares fits of Eq. 7 to the Table II
  block_15_project / block_16_project_BN rows (the block_2_expand rows are
  dominated by ESP32 TCP-buffer stalls the paper itself flags as
  anomalous):
      UDP      0.78 ms/packet   (serialization-only at ~1.87 MB/s)
      TCP      4.71 ms/packet   (UDP serialization + 3.93 ms ack overhead)
      ESP-NOW  3.1455 ms/packet (2 ms @1 Mbps PHY + 1.1455 ms MAC ack)
      BLE     26.6  ms/packet   (2.05 ms @2 Mbps PHY + 24.5 ms conn-interval)

* **Setup / feedback** delays are Table IV verbatim.

* **ESP32-S3 compute** is FLOP-proportional, calibrated piecewise so that
  the block_16_project_BN split reproduces Table III exactly
  (device 1 inference 3053.75 ms, device 2 inference 437 ms).

* **Sanity**: with these constants the model reproduces the Table IV RTTs
  within ~2% for all four protocols.

* **Pipeline stages** (:class:`StageHardware`, :data:`H100_SXM`,
  :data:`NVLINK`, :data:`INFINIBAND`): the accelerator and the links
  that :func:`repro_torch.core.planner.plan_pipeline` prices an LM's
  block chain on, in place of the reference's fixed stage hardware.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

from repro_torch.core.latency import (
    BottleneckVariant,
    DeviceProfile,
    LinkProfile,
    ModelCostProfile,
    SplitCostModel,
    bottleneck_variants,
)

# NOTE: repro_torch.models.graph is imported inside the builder functions
# below: models.graph depends on repro_torch.core.latency, and the planner
# (imported by repro_torch.core.__init__) imports this module, so a
# module-scope import would close a cycle through the package.

# ---------------------------------------------------------------------------
# Wireless protocol profiles (Tables I, II, IV)
# ---------------------------------------------------------------------------

UDP = LinkProfile(
    name="udp",
    mtu_bytes=1460,
    rate_bytes_per_s=1460 / 0.78e-3,  # 0.78 ms serialization per packet
    loss_p=0.0,
    t_prop_s=0.0,
    t_ack_s=0.0,
    t_setup_s=2.1349,
    t_feedback_s=0.649e-3,
    max_devices=None,
)

TCP = LinkProfile(
    name="tcp",
    mtu_bytes=1460,
    rate_bytes_per_s=1460 / 0.78e-3,
    loss_p=0.0,
    t_prop_s=0.0,
    t_ack_s=3.93e-3,  # ack + retransmission overhead per packet
    t_setup_s=2.590623,
    t_feedback_s=2.645e-3,
    max_devices=10,
)

ESP_NOW = LinkProfile(
    name="esp_now",
    mtu_bytes=250,
    rate_bytes_per_s=125_000.0,  # 1 Mbps ESP-NOW PHY -> 2 ms per 250 B packet
    loss_p=0.0,
    t_prop_s=0.0,
    t_ack_s=1.1455e-3,  # MAC-level ack, no connection handshake
    t_setup_s=48e-3,
    t_feedback_s=1.115e-3,
    max_devices=20,
)

BLE = LinkProfile(
    name="ble",
    mtu_bytes=512,
    rate_bytes_per_s=250_000.0,  # 2 Mbps PHY -> 2.05 ms serialization
    loss_p=0.0,
    t_prop_s=0.0,
    t_ack_s=24.5e-3,  # connection-interval + GATT overhead per packet
    t_setup_s=6.37852,
    t_feedback_s=24.550e-3,
    max_devices=7,
)

PROTOCOLS: dict[str, LinkProfile] = {p.name: p for p in (UDP, TCP, ESP_NOW, BLE)}

# Chunk-size variants exercised by Table II (bytes-per-chunk column).
TABLE2_CHUNKS: dict[str, tuple[int, ...]] = {
    "udp": (1472, 1460, 1200),
    "tcp": (1472, 1460, 1200),
    "esp_now": (250,),
    "ble": (512,),
}


# ---------------------------------------------------------------------------
# ESP32-S3 device profile (Table III)
# ---------------------------------------------------------------------------

# Piecewise-calibrated inference totals at the block_16_project_BN split.
MBV2_PART1_INFER_S = 3.05375  # device 1 (camera node)
MBV2_PART2_INFER_S = 0.437  # device 2 (classifier node)
MBV2_SPLIT_LAYER = "block_16_project_BN"

ESP32_MEM_LIMIT_BYTES = 8.5e6  # 8 MB PSRAM + 0.5 MB SRAM

# Tensor-arena allocation: affine fit to Table III (43 ms @ 753 KB peak
# arena on device 1, 10 ms @ 68 KB on device 2 — peak in+out activation
# bytes of the largest layer in each segment).
_ALLOC_BASE_S = 6.7113e-3
_ALLOC_PER_BYTE_S = 4.822e-8

ESP32 = DeviceProfile(
    name="esp32_s3",
    compute_scale=1.0,
    t_model_load_s=0.01e-3,  # Table III: 0.0001-0.01 ms (memory-mapped flash)
    model_load_s_per_byte=0.0,
    t_input_load_s=9.8e-3,  # camera frame read, first device only
    t_tensor_alloc_s=_ALLOC_BASE_S,
    tensor_alloc_s_per_byte=_ALLOC_PER_BYTE_S,
    t_buffer_s=0.0,
    buffer_s_per_byte=3.6e-9,  # 0.02 ms for the 5488 B block_16 activation
    mem_limit_bytes=ESP32_MEM_LIMIT_BYTES,
)


def _piecewise_calibrate(
    profile: ModelCostProfile, split_layer: str, t1_s: float, t2_s: float
) -> ModelCostProfile:
    """Rescale per-layer FLOP-proportional times so the two parts of the
    paper's two-device split sum to the measured totals (Table III)."""
    idx = next(i for i, lc in enumerate(profile.layers) if lc.name == split_layer) + 1
    part1 = sum(lc.t_infer_s for lc in profile.layers[:idx])
    part2 = sum(lc.t_infer_s for lc in profile.layers[idx:])
    f1 = t1_s / part1
    f2 = t2_s / part2
    new_layers = tuple(
        replace(lc, t_infer_s=lc.t_infer_s * (f1 if i < idx else f2))
        for i, lc in enumerate(profile.layers)
    )
    return replace(profile, layers=new_layers)


def esp32_flops_per_s() -> float:
    """Effective ESP32-S3 int8 TFLM throughput implied by Table III."""
    from repro_torch.models.graph import mobilenet_v2_graph

    g = mobilenet_v2_graph(width=0.35, image_size=224)
    return g.total_flops / (MBV2_PART1_INFER_S + MBV2_PART2_INFER_S)


def mobilenet_cost_profile() -> ModelCostProfile:
    """MobileNet-V2 0.35 per-layer costs on ESP32-S3, Table-III calibrated."""
    from repro_torch.models.graph import mobilenet_v2_graph

    g = mobilenet_v2_graph(width=0.35, image_size=224)
    prof = g.cost_profile(flops_per_s=esp32_flops_per_s(), act_dtype_bytes=1, param_dtype_bytes=1)
    return _piecewise_calibrate(prof, MBV2_SPLIT_LAYER, MBV2_PART1_INFER_S, MBV2_PART2_INFER_S)


def resnet50_cost_profile() -> ModelCostProfile:
    """ResNet50 per-layer costs on ESP32-S3 (FLOP-proportional at the
    MobileNet-calibrated rate; no per-part measurement exists in the paper)."""
    from repro_torch.models.graph import resnet50_graph

    g = resnet50_graph(image_size=224)
    return g.cost_profile(flops_per_s=esp32_flops_per_s(), act_dtype_bytes=1, param_dtype_bytes=1)


def paper_cost_model(
    model: str = "mobilenet_v2",
    protocol: str = "esp_now",
    objective: str = "sum",
) -> SplitCostModel:
    """The paper's experimental configuration as a ready SplitCostModel."""
    prof = mobilenet_cost_profile() if model.startswith("mobilenet") else resnet50_cost_profile()
    return SplitCostModel(
        profile=prof, devices=(ESP32,), link=PROTOCOLS[protocol], objective=objective
    )


# ---------------------------------------------------------------------------
# Bottleneck variant bank (split-computing feature compression)
# ---------------------------------------------------------------------------

# The split-computing exemplars ship a feature_compression_factor at the
# cut (×4 in the reference client); ×1 keeps the paper's uncompressed
# baseline in the bank so every joint solve can still pick it.
PAPER_COMPRESSION_FACTORS: tuple[float, ...] = (1.0, 2.0, 4.0)


def esp32_variant_bank(
    factors: Sequence[float] = PAPER_COMPRESSION_FACTORS,
    encoder_flops_per_byte: float = 16.0,
    accuracy_drop_per_octave: float = 0.03,
) -> tuple[BottleneckVariant, ...]:
    """Bottleneck-variant bank priced at the ESP32-S3's calibrated rate.

    Each factor becomes a :class:`repro_torch.core.latency.BottleneckVariant`
    whose encoder cost is ``encoder_flops_per_byte`` of extra
    sensor-side work per raw activation byte (a small 1×1-conv
    bottleneck head), converted to seconds with
    :func:`esp32_flops_per_s` — so the latency the joint
    (split, variant) solvers trade against the shrunken payload uses
    the same device calibration as the per-layer costs. Factor 1.0
    yields the identity variant (no encoder, accuracy proxy 1.0): the
    bit-exact uncompressed path."""
    per_byte = encoder_flops_per_byte / esp32_flops_per_s()
    return bottleneck_variants(
        factors,
        encoder_s_per_byte=per_byte,
        accuracy_drop_per_octave=accuracy_drop_per_octave,
    )


# ---------------------------------------------------------------------------
# Pipeline-stage hardware (plan_pipeline)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageHardware:
    """One accelerator of a pipeline stage, as the pipeline planner sees
    it: a dense peak rate, a memory rate and a memory size. A stage of
    ``n`` of them divides both roofline terms by ``n`` and holds ``n``
    times the memory."""

    name: str
    peak_flops: float  # dense FLOP/s at the type the stages compute in
    hbm_bytes_per_s: float
    hbm_bytes: int

    def layer_time_s(self, flops: float, bytes_moved: float, n: int = 1) -> float:
        """Analytic per-layer time: max of the compute and memory roofline
        terms."""
        return max(flops / (n * self.peak_flops), bytes_moved / (n * self.hbm_bytes_per_s))

    def stage_device(self, n: int, mem_fraction: float = 0.9) -> DeviceProfile:
        """A pipeline stage made of ``n`` of these accelerators.

        Per-layer inference times in stage cost profiles are produced
        analytically (:meth:`layer_time_s`); the stage device then just
        scales by the count."""
        return DeviceProfile(
            name=f"{self.name}_x{n}",
            compute_scale=1.0 / n,
            t_model_load_s=0.0,
            t_tensor_alloc_s=0.0,
            mem_limit_bytes=n * self.hbm_bytes * mem_fraction,
        )


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
# 989 TFLOP/s dense bf16 (the sheet's 1,979 counts 2:4 sparsity), 3.35
# TB/s of HBM3, 80 GB. A card reports its own usable size in
# ``torch.cuda.get_device_properties(0).total_memory``.
H100_SXM = StageHardware(name="h100_sxm", peak_flops=989e12, hbm_bytes_per_s=3.35e12,
                         hbm_bytes=80 * 10**9)

# Links between stages. No datasheet gives per-hop propagation, setup or
# feedback times, so those are 0; both fabrics are lossless (credit-based
# flow control), so loss_p is 0.
NVLINK = LinkProfile(
    name="nvlink",
    # NVLink 4 on the H100 SXM5 datasheet: 900 GB/s counts both directions
    # of 18 links; one direction, the rate a stage hands its activations
    # on at, is 450 GB/s
    mtu_bytes=256,  # an NVLink transaction carries at most 256 bytes of data
    rate_bytes_per_s=450e9,
)

INFINIBAND = LinkProfile(
    name="infiniband",
    mtu_bytes=4096,  # InfiniBand's largest MTU
    rate_bytes_per_s=50e9,  # one NDR port: 400 Gb/s
)

H100_LINKS: dict[str, LinkProfile] = {"nvlink": NVLINK, "infiniband": INFINIBAND}
