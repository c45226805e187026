"""Build, load and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source under ``csrc/`` into one shared library with a
plain C interface, once, at first use, into ``build/repro_torch/`` at the
root of the checkout: one ``nvcc -c`` per source, all started together, then
one link.  The library's name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.  It is
loaded with ``ctypes``; every pointer and the stream pass as ``c_void_p``.

No PyTorch header is compiled, so the build takes seconds, not the minutes
of ``torch.utils.cpp_extension.load``.  A failed build raises with nvcc's
stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# No --use_fast_math: the kernels rely on IEEE sqrtf/division and on
# denormals not being flushed.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "gee_kernels_max_classes": ([], ctypes.c_int),
    "gee_kernels_error_string": ([ctypes.c_int], ctypes.c_char_p),
    # ylab, contrib, out, R, D, K, stream
    "gee_spmm_launch": ([_P, _P, _P, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int, _P], ctypes.c_int),
    # ylab, contrib, rowlab, dadd, out, R, D, K, correlation, eps, stream
    "gee_spmm_fused_launch": ([_P, _P, _P, _P, _P, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, _P], ctypes.c_int),
    # z, out, N, K, eps, stream
    "row_norm_launch": ([_P, _P, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float, _P], ctypes.c_int),
    "topk_kernels_max_topk": ([], ctypes.c_int),
    # q, x, valid, out, Q, M, K, metric, stream
    "pairwise_scores_launch": ([_P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                _P], ctypes.c_int),
    # cand, q, mask, out, Q, M, K, metric, stream
    "gathered_scores_launch": ([_P, _P, _P, _P, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                _P], ctypes.c_int),
    # q, x, valid, part_s, part_m, out_s, out_ids, Q, M, K, metric, k,
    # chunks, stream
    "scored_topk_launch": ([_P, _P, _P, _P, _P, _P, _P, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    # cand, q, mask, ids, part_s, part_m, out_s, out_ids, Q, M, K, metric,
    # k, chunks, stream
    "scored_topk_gathered_launch": ([_P, _P, _P, _P, _P, _P, _P, _P,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _P], ctypes.c_int),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgee_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing.

    Returns ``(path, compiler_output)``; the output is empty when the
    library already existed.  Raises ``RuntimeError`` with nvcc's stderr
    when the build fails.
    """
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu = [s for s in sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s.stem + ".o") for s in cu]
        tmp = os.path.join(tmpdir, path.name)
        # one compile per source, all running at once, then one link
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        for cmd, proc, out in zip(cmds, procs, outs):
            _check_nvcc(cmd, proc.returncode, out)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        outs.append(link.stdout)
        _check_nvcc(cmd, link.returncode, link.stdout)
        os.replace(tmp, path)         # atomic: a concurrent loader sees all
    return path, "".join(outs)


def _check_nvcc(cmd: list[str], rc: int, out: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed (rc={rc}): {' '.join(cmd)}\n{out}")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; argtypes are declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 like: torch.Tensor | None = None) -> None:
    """Validate a kernel operand: dtype, rank, contiguity and (with
    ``like``) the same device and shape as another operand."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}; the kernels take CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{like.device}")
        if t.shape[:like.dim()] != like.shape[:t.dim()]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"incompatible with {tuple(like.shape)}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launcher did not return cudaSuccess."""
    if rc != 0:
        msg = lib.gee_kernels_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "nvcc_path",
           "library_path", "build", "load_library", "check_tensor",
           "stream_of", "check_launch"]
