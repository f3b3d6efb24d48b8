"""Build the native videodec shared library with g++ against libav.

Called on the first use of videoitg_tpu_torch.data.video (and by
`python -m videoitg_tpu_torch.native.build`). The library lands in
`<repo>/build/videoitg_tpu_torch/native/<source hash>/`, beside the CUDA
kernels' build, so editing the source rebuilds; `VIDEOITG_TORCH_BUILD_DIR`
moves the build root.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(SRC_DIR, "videodec.cpp")
_REPO_ROOT = os.path.dirname(os.path.dirname(SRC_DIR))

PKGS = ["libavformat", "libavcodec", "libavutil", "libswscale"]


def _pkg_config(flag: str) -> list[str]:
    out = subprocess.check_output(["pkg-config", flag] + PKGS, text=True)
    return out.split()


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    root = os.environ.get("VIDEOITG_TORCH_BUILD_DIR") or os.path.join(
        _REPO_ROOT, "build", "videoitg_tpu_torch")
    return os.path.join(root, "native", digest, "libvideodec.so")


def build(force: bool = False) -> str:
    lib = lib_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = (
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp]
        + _pkg_config("--cflags")
        + _pkg_config("--libs")
    )
    subprocess.check_call(cmd)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
