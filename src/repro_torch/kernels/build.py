"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``repro_torch/csrc`` is compiled on first use into a
shared library with a plain C interface, keyed on a hash of the source,
the headers beside it (``csrc/*.cuh``) and the flags, in
``build/repro_torch/`` at the root of the checkout (an
installed package uses ``$XDG_CACHE_HOME/repro_torch``, and
``$REPRO_TORCH_BUILD_DIR`` overrides both). A library that already exists
for the same hash is loaded without a rebuild. Nothing here runs at import time: the
CPU tests import every module of the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of every exported function, per source file.
SIGNATURES: dict[str, dict[str, tuple[list, object]]] = {
    "split_dp.cu": {
        # C, ns, dp0, dps, args, S, N, L, is_f64, is_max, stream
        "split_dp_dense": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        # bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, B, is_f64, is_max,
        # stream: the kernel split_dp_fused_variant names
        "split_dp_fused": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                           _I),
        # the same arguments; always the first kernel (one block per scenario)
        "split_dp_fused_per_scenario": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P], _I),
        # B, L, is_f64 -> 1 when split_dp_fused runs the tiled kernel
        "split_dp_fused_variant": ([_I, _I, _I], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention.cu": {
        # q, k, v, qpos, kpos, out, BH, BHkv, Sq, Skv, D, scale, is_bf16, stream
        "flash_attention_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 ctypes.c_float, _I, _P], _I),
        # the same arguments; always the first (CUDA-core) kernel
        "flash_attention_fwd_simt": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      ctypes.c_float, _I, _P], _I),
        # is_bf16, D -> 1 when flash_attention_fwd runs the wgmma kernel
        "flash_attention_variant": ([_I, _I], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "quant_matmul.cu": {
        # a, w, a_scale, a_zp, w_scale, colsum, wT, out, M, K, N, out_bf16, stream
        "quant_matmul_w8a8": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # the same arguments but wT; always the mma.sync kernel
        "quant_matmul_w8a8_mma": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # K, a -> 1 when quant_matmul_w8a8 runs the wgmma kernel
        "quant_matmul_w8a8_variant": ([_I, _P], _I),
        # x, w, w_scale, out, M, K, N, x_bf16, out_bf16, stream
        "quant_matmul_w8a16": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "ssm_scan.cu": {
        # x, b, c, dA, dt, y, states, decay, hp, BH, BG, S, ph, ds, ck, is_bf16, stream
        "ssm_scan_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
}


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_time_s: float  # 0.0 when an existing library was loaded
    log: str  # nvcc's output (ptxas register and shared-memory report)


_LOADED: dict[str, BuiltLibrary] = {}


def build_dir(csrc: Path = CSRC) -> Path:
    """``$REPRO_TORCH_BUILD_DIR``; else ``build/repro_torch`` at the root of
    the checkout that holds ``csrc``; else, for an installed package, a
    per-user cache directory."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = csrc.parents[2]  # <root>/src/repro_torch/csrc
    if csrc.parents[1].name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA toolkit is needed to build the port's kernels")


def source_digest(src: Path) -> str:
    """The build key of ``src``: a hash of the source, of every header
    beside it (``*.cuh``, which a source may include) and of the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def load(source: str = "split_dp.cu") -> BuiltLibrary:
    """The loaded library for ``csrc/<source>``, built on first use."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{src.stem}_{source_digest(src)}.so"
    build_time, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        # build to a private name, then rename: processes building the
        # same source never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_time = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    built = BuiltLibrary(lib=lib, path=so, build_time_s=build_time, log=log)
    _LOADED[source] = built
    return built


def check_launch(built: BuiltLibrary, code: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error (0 = launched). Every
    library exports ``cuda_error_string`` for its codes."""
    if code != 0:
        msg = built.lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


def check_cuda(kernel: str, **tensors: torch.Tensor) -> torch.device:
    """The one CUDA device that all ``tensors`` lie on; raises unless they
    are contiguous CUDA tensors on one device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: needs CUDA tensors, got {dev}")
    return dev
