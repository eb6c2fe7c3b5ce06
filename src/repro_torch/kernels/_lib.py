"""Build, load and call the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` (one process per
source, all started together) and linked into ONE shared library with a
plain C interface, which is loaded with `ctypes`. The library is built at
first use into `build/repro_torch/` at the root of the checkout (listed in
`.gitignore`), under a name keyed by the hash of the sources and flags, so
an edited kernel is never served from a stale build.

Nothing here runs at import time: importing the package needs no CUDA
toolkit, and `nvcc` is first called when a wrapper is handed a CUDA
tensor.

Dispatch rule shared by every wrapper: all tensors on the CPU -> the
family's plain PyTorch version; all on CUDA -> the kernel (or an
exception); anything else -> an exception. There is no fallback.
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
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# (name, argument kinds) of every C entry point: "p" pointer or stream,
# "i" int, "f" float. Each returns the cudaError_t of its launch.
_ENTRY_POINTS = {
    "rt_wkv_forward": "ppppppppiiiip",
    "rt_set_attention_forward": "ppppppiiiiifp",
    "rt_kmeans_assign": "ppiiippp",
    "rt_kmeans_update": "pppiiippppppip",
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every `csrc/*.cu` (in parallel) and link one `.so`.

    Returns its path; a build for the same sources is reused. The link
    lands under a temporary name and is renamed into place, so processes
    that build at once never load a half-written library."""
    sources = sorted(CSRC.glob("*.cu"))
    target = BUILD_DIR / f"librepro_torch_{_source_key()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        errors = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(tmp_so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_so, target)
    return target


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared (pointers as c_void_p, so ctypes
    never truncates them to 32 bits)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, kinds in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPE[c] for c in kinds]
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def device_kind(*tensors: Optional[torch.Tensor]) -> str:
    """"cpu" or "cuda" when every given tensor lies there; raises on a
    mix or on any other device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) == 1:
        kind = devices.pop().type
        if kind in ("cpu", "cuda"):
            return kind
    raise ValueError(f"kernel inputs must all be on the CPU or all on "
                     f"one CUDA device, got {sorted(map(str, devices))}")


def require(t: torch.Tensor, name: str, shape: Sequence[int],
            dtype: torch.dtype = torch.float32) -> None:
    """Checks a CUDA kernel input: dtype, exact shape, contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raises when a launch was refused (rc is its cudaGetLastError)."""
    if rc != 0:
        msg = load_library().rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
