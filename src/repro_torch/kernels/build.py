"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` (RMSNorm, flash attention and the fused
cross-entropy, each forward and backward) is compiled by ``nvcc`` for
``sm_90a`` into an object file, all sources at once in parallel, and the
objects are linked into
one shared library with a plain C interface under ``build/repro_torch/``
at the repository root.  The library's name carries a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is.  ``library()`` builds at first use, once per process.

There is no fallback: when ``nvcc`` is missing or a source fails to
compile, ``KernelBuildError`` is raised with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""            # nvcc's output (with ptxas register counts)


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source did not compile or link."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "repro_torch CUDA kernels are built on a machine with the CUDA "
            "toolkit; on the CPU the plain PyTorch versions run instead")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    log, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        log.append(f"--- {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    text = "\n".join(log)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n{text}")
    return text


def build(force: bool = False) -> Path:
    """Compile and link the kernels; returns the library's path."""
    global BUILD_LOG
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists() and not force:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = _run(procs)
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]
    log += "\n" + _run([("link", subprocess.Popen(
        link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    os.replace(tmp, lib_path)     # atomic: a concurrent build never loads half a file
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_LOG = log
    return lib_path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.rms_norm_launch.argtypes = [ptr, ptr, ptr, i64, i32, f32, i32, ptr]
    lib.rms_norm_launch.restype = i32
    lib.rms_norm_bwd_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,       # dx, dscale, part, x, scale, dy
        i64, i32, f32, i32, ptr]            # rows, d, eps, dtype, stream
    lib.rms_norm_bwd_launch.restype = i32
    lib.rms_norm_bwd_rows_per_block.argtypes = []
    lib.rms_norm_bwd_rows_per_block.restype = i32
    lib.flash_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # o, lse, q, k, v
        i32, i32, i32, i32, i32, i32,       # B, H, KV, Sq, Sk, D
        f32, i32, i32, f32,                 # scale, causal, window, logit_cap
        i32, ptr]                           # dtype, stream
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_bwd_launch.argtypes = [
        ptr, ptr, ptr, ptr,                 # dq, dk, dv, delta
        ptr, ptr, ptr, ptr, ptr, ptr,       # q, k, v, o, lse, dout
        i32, i32, i32, i32, i32, i32,       # B, H, KV, Sq, Sk, D
        f32, i32, i32, f32,                 # scale, causal, window, logit_cap
        i32, ptr]                           # dtype, stream
    lib.flash_attention_bwd_launch.restype = i32
    lib.ce_loss_fwd_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # loss, logz, x, table, labels
        i32, i32, i32, i32, ptr]            # T, V, d, dtype, stream
    lib.ce_loss_fwd_launch.restype = i32
    lib.ce_loss_bwd_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # dx, dW, x, table, labels, logz, g
        i32, i32, i32, i32, ptr]            # T, V, d, dtype, stream
    lib.ce_loss_bwd_launch.restype = i32
    lib.repro_torch_error_string.argtypes = [i32]
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().repro_torch_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
