"""Build, load and dispatch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded through ``ctypes``.  The build happens at first
use, into ``build/repro_torch_kernels/`` at the repository root, keyed by a
hash of the sources and flags, so a stale library is never loaded.  A
missing ``nvcc`` or a failed compile raises; nothing falls back.

Dispatch rule shared by every kernel wrapper: a tensor on the CPU takes the
kernel's plain PyTorch version, a tensor on the card launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches per kernel name (only real
launches on the card, incremented by the wrappers right after a launch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

KERNEL_NAMES = ("pack_codes", "unpack_codes", "fused_zone_filter",
                "remap_pack_codes", "fused_zone_agg", "zone_histogram",
                "multi_range_filter_packed", "range_filter_codes",
                "remap_codes", "range_filter_packed", "bloom_probe",
                "ssm_scan", "ssm_scan_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}

_lock = threading.Lock()
# ``LAUNCHES[k] += 1`` is a read-modify-write: the maintenance workers
# launch beside the caller's thread, so counts change under this lock
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "repro_pack_codes": [_P, _P, _I64, _INT, _P],
    "repro_unpack_codes": [_P, _P, _I64, _INT, _P],
    "repro_fused_zone_filter": [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P],
    "repro_remap_pack_codes": [_P] * 5 + [_I64, _INT, _INT, _P],
    "repro_fused_zone_agg": [_P] * 9 + [_I64] + [_INT] * 6 + [_P],
    "repro_zone_histogram": [_P] * 5 + [_I64] + [_INT] * 5 + [_P],
    "repro_multi_range_filter": [_P] * 4 + [_I64, _INT, _INT, _INT, _P],
    "repro_range_filter_codes": [_P, _INT, _INT, _P, _P, _I64, _INT, _INT,
                                 _P],
    "repro_remap_codes": [_P] * 5 + [_I64, _INT, _P],
    "repro_range_filter_packed": [_P, _U32, _U32, _P, _P, _I64, _INT, _INT,
                                  _INT, _P],
    "repro_bloom_probe": [_P, _I64, _U32, _U32, _INT, _INT, _P, _I64, _INT,
                          _P, _P],
    "repro_ssm_scan": [_P] * 7 + [_I64] + [_INT] * 4 + [_P],
    "repro_ssm_scan_bwd": [_P] * 15 + [_I64] + [_INT] * 3 + [_I64] * 2 +
                          [_INT] * 3 + [_P],
}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card, False when every tensor lies
    on the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands must all be on the CPU or all on the "
                     f"card, got devices {sorted(kinds)}")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _flags() -> list:
    """``NVCC_FLAGS`` and the tile constants that the kernel modules own."""
    from repro_torch.kernels import (bitpack, merge_remap, packed_filter,
                                     ssm_scan)

    return NVCC_FLAGS + [
        f"-DREPRO_UNPACK_THREADS={bitpack.UNPACK_THREADS}",
        f"-DREPRO_UNPACK_GROUPS={bitpack.UNPACK_GROUPS}",
        f"-DREPRO_PACK_THREADS={bitpack.PACK_THREADS}",
        f"-DREPRO_PACK_GROUPS={bitpack.PACK_GROUPS}",
        f"-DREPRO_REMAP_THREADS={merge_remap.REMAP_THREADS}",
        f"-DREPRO_REMAP_GROUPS={merge_remap.REMAP_GROUPS}",
        f"-DREPRO_SSM_STATES={ssm_scan.STATES_PER_LANE}",
        f"-DREPRO_SSM_ROUND={ssm_scan.STEPS_PER_ROUND}",
        f"-DREPRO_SSM_BWD_STATES={ssm_scan.BWD_STATES}",
        f"-DREPRO_SSM_BWD_STEPS={ssm_scan.BWD_STEPS}",
        f"-DREPRO_SSM_BWD_ROUND={ssm_scan.BWD_ROUND}",
        f"-DREPRO_SSM_BWD_THREADS={ssm_scan.BWD_THREADS}",
        f"-DREPRO_SSM_BWD_BLOCKS={ssm_scan.BWD_BLOCKS}",
        f"-DREPRO_FILTER_THREADS={packed_filter.FILTER_THREADS}",
        f"-DREPRO_FILTER_LOADS={packed_filter.FILTER_LOADS}"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link them; returns the library.

    The compiler's output (``-Xptxas=-v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_flags(), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    Path(str(out) + ".log").write_text("\n".join(log))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C launcher on the current stream of ``device``, raise on a
    non-zero CUDA status, and count the launch under ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
    with _count_lock:
        LAUNCHES[kernel] += 1


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  ndim: int, contiguous: bool = True) -> None:
    """Validate one kernel operand before its pointer goes to C (with
    ``contiguous=False`` the kernel takes the operand's strides)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the card, got {t.device}")
