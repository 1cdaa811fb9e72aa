"""Build, load and launch the port's hand-written CUDA kernels and host
routines.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface, loaded through ctypes (no PyTorch headers, so a build takes
seconds); each `csrc/<name>.cpp` (host code) the same way with the host C++
compiler. The library lands in `textslam_tpu_torch/_build/`, keyed by a hash
of the source and the compiler flags, with the compiler's report (for nvcc,
ptxas registers and spills) beside it as `<library>.log`. It is built at
first use — never at import, so the package imports on machines without
nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# Every C entry point of csrc/, bound once at load: (source, function) ->
# argument types. Pointers and the trailing cudaStream_t are void*; each
# function returns its cudaGetLastError() as an int.
SIGNATURES: Dict[Tuple[str, str], tuple] = {
    # d1, d1_alt (NULL for none), d2, out, n1, n2
    ("hamming", "hamming_matrix_launch"): (_P, _P, _P, _P, _I, _I, _P),
    # imgs, group_k, uv, out, mask, then the scalar arguments packed in one
    # buffer (patch_sample.LaunchArgs as bytes)
    ("patch_sample", "patch_sample_launch"): (_P,) * 5 + (ctypes.c_char_p, _P),
    # host: raw rows (filter byte + bytes), out, rows, stride, bytes per pixel
    ("png_unfilter", "png_unfilter"): (_P, _P, _I, _I, _I),
    # host: data, size, dims out ({H, W, components}), error message buffer, its size
    ("jpeg_decode", "jpeg_header"): (_P, ctypes.c_long, _P, ctypes.c_char_p, _I),
    # host: data, size, out ([H, W] or [H, W, 3] uint8), error message buffer, its size
    ("jpeg_decode", "jpeg_decode"): (_P, ctypes.c_long, _P, ctypes.c_char_p, _I),
    # host: a, alen, b, blen, Q, T, L, out
    ("native", "levenshtein_batch"): (_P,) * 4 + (ctypes.c_int64,) * 3 + (_P,),
    # host: inc (uint8), K, P, out
    ("native", "covis_product"): (_P, ctypes.c_int64, ctypes.c_int64, _P),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of textslam_tpu_torch cannot be built")


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, then c++, then g++ on PATH."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and shutil.which(c)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (set CXX or put g++ on PATH); the host "
                       "routines of textslam_tpu_torch cannot be built")


def _source(name: str) -> Tuple[str, list]:
    """(csrc path, flags) of a kernel (.cu) or host routine (.cpp)."""
    cu = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(cu):
        return cu, NVCC_FLAGS
    return os.path.join(CSRC, f"{name}.cpp"), CXX_FLAGS


def library_path(name: str) -> str:
    path, flags = _source(name)
    with open(path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (host C++) unless the
    keyed library exists; returns its path. Raises with the compiler's
    output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        path, flags = _source(name)
        cc = find_nvcc() if flags is NVCC_FLAGS else find_cxx()
        res = subprocess.run([cc, *flags, "-o", tmp, path], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cc)} failed building "
                               f"{os.path.basename(path)}:\n{res.stdout}{res.stderr}")
        with open(out + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu / .cpp once per process, with
    every entry point's signature from SIGNATURES bound."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for (src, fn), argtypes in SIGNATURES.items():
                if src == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call entry point `fn` of csrc/<name>.cu with `args` and the current
    stream of CUDA `device`, entering a device context only when `device`
    is not the current one. Raises when the build fails or the call returns
    a cudaError."""
    f = getattr(load(name), fn)
    # the raw cudaStream_t of the device's current stream, without building
    # a torch.cuda.Stream (a few microseconds a call on the sampler's path)
    if device.index == torch.cuda.current_device():
        err = f(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = f(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")
