"""Lazy build of the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for Hopper (`sm_90a`), one nvcc
process per source and all of them started together, and the objects are
linked into one shared library with a plain C interface, loaded with
`ctypes`. Nothing is built when a module is imported: the first kernel
launch calls `library()`.

The library lands in `<repo>/build/videoitg_tpu_torch/<hash>/`, where the
hash covers every source file and the nvcc flags, so editing a source
rebuilds on the next launch. `VIDEOITG_TORCH_BUILD_DIR` moves the build root
and `VIDEOITG_NVCC` names the compiler (default: `nvcc` on PATH, then
`/usr/local/cuda/bin/nvcc`).

A failed build raises; no caller falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(CSRC))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int.
SIGNATURES = {
    # q, k, v, out, B, H, S, D, sm_scale, stream
    "videoitg_flash_mha_short_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, valid (nullable uint8 [B, S]), out, B, Hq, Hkv, S, D, causal,
    # sm_scale, stream
    "videoitg_flash_mha_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, x_scale (written if compute_scale), x_q, M, K, compute_scale, stream
    "videoitg_row_quant_int8_bf16": (_P, _P, _P, _I, _I, _I, _P),
    # x_q, x_scale, w_qt, w_scale, out, M, K, N, stream
    "videoitg_act8_gemm_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # LN + row quantisation, launch 1 of G and of H. x, ln scale, ln bias, yq,
    # ys, rows, H, eps, stream
    "videoitg_ln_row_quant_int8_bf16": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    # G's launch 2. yq, ys, packed w_qt, scale, bias, q, k, v, rows, H, dq,
    # dk, dv, stream
    "videoitg_qkv_gemm_s8": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # H's launches 2 to 4.
    # yq, ys, fc1 w_qt, scale, bias, amax, rows, H, M, activation, stream
    "videoitg_mlp_fc1_amax_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # yq, ys, fc1 w_qt, scale, bias, amax, gq, rows, H, M, activation, stream
    "videoitg_mlp_fc1_quant_s8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # gq, amax, fc2 w_qt, scale, bias, x, out, rows, M, H, stream
    "videoitg_mlp_fc2_residual_s8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # I's launch 2 (launch 1: videoitg_row_quant_int8_bf16). aq, a_scale,
    # o w_qt, scale, bias, residual, out, rows, D, H, stream
    "videoitg_proj_residual_s8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, valid (nullable), out, lse, B, Hq, Hkv, S, D, causal, sm_scale, stream
    "videoitg_flash_train_fwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, valid (nullable), dout, lse, delta, dq, B, Hq, Hkv, S, D, causal,
    # sm_scale, stream
    "videoitg_flash_train_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, valid (nullable), dout, lse, delta, dk, dv, B, Hq, Hkv, S, D,
    # causal, sm_scale, stream
    "videoitg_flash_train_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, q_ids, kv_ids (int32 [B, S]), out, lse, B, H, S, D, causal, sm_scale, stream
    "videoitg_flash_segment_fwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, q_ids, kv_ids, dout, lse, delta, dq, B, H, S, D, causal, sm_scale, stream
    "videoitg_flash_segment_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, q_ids, kv_ids, dout, lse, delta, dk, dv, B, H, S, D, causal, sm_scale, stream
    "videoitg_flash_segment_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _F, _P),
    # q (scaled), k, v, q_seg, kv_seg (int32 [B, S]), out, B, Hq, Hkv, S, D, stream
    "videoitg_splash_mqa_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, n, stream
    "videoitg_double_literal_f32": (_P, _P, _I, _P),
    "videoitg_double_no_literal_f32": (_P, _P, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc runs, None if cached
build_log = ""  # what nvcc printed (ptxas -v: registers, shared memory, spills)


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    explicit = os.environ.get("VIDEOITG_NVCC")
    if explicit:
        if not os.path.isfile(explicit):
            raise RuntimeError(f"VIDEOITG_NVCC={explicit!r} does not exist")
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of videoitg_tpu_torch are built on "
        "first use and need the CUDA toolkit (set VIDEOITG_NVCC)")


def build_dir() -> str:
    root = os.environ.get("VIDEOITG_TORCH_BUILD_DIR") or os.path.join(
        _REPO_ROOT, "build", "videoitg_tpu_torch")
    return os.path.join(root, source_hash())


def build() -> str:
    """Compile csrc/*.cu into the hashed build directory; return the .so path."""
    global build_seconds, build_log
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, "libvideoitg_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = nvcc_path()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    # One nvcc per source, all started together; then one link.
    jobs = []
    for src in sources():
        if src.endswith(".cu"):
            obj = os.path.join(out_dir, f"{os.path.basename(src)}.{os.getpid()}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
    failures, logs = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                            f"{stdout}\n{stderr}")
    objects = [obj for _, obj, _ in jobs]
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.videoitg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.videoitg_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().videoitg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
