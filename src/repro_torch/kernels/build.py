"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``repro_torch/csrc`` is compiled on first use into a
shared library with a plain C interface, keyed on a hash of the source
and the flags, in ``build/repro_torch/`` at the root of the checkout (an
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
        # bank, bank_idx, tx, ns, dp0, dps, args, S, N, L, is_f64, is_max, stream
        "split_dp_fused": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                           _I),
        "split_dp_error_string": ([_I], ctypes.c_char_p),
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


def load(source: str = "split_dp.cu") -> BuiltLibrary:
    """The loaded library for ``csrc/<source>``, built on first use."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
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
    """Raise when a launcher reported a CUDA error (0 = launched)."""
    if code != 0:
        msg = built.lib.split_dp_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
