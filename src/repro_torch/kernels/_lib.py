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
exception); all on meta -> empty outputs of the kernel's shapes and
dtypes, computed by nothing (the dry-run's shape propagation, as a fake
kernel is in `torch.library`); anything else -> an exception. There is
no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
    # ..., vec, bf16 (the element type of the bf16 instances' inputs), ...
    "rt_wkv_forward": "p" * 9 + "i" * 6 + "p",
    "rt_wkv_backward": "p" * 14 + "i" * 6 + "p",
    "rt_set_attention_forward": "p" * 6 + "i" * 7 + "fp",
    "rt_set_attention_backward": "p" * 11 + "i" * 7 + "fp",
    "rt_kmeans_assign": "ppiiiiippp",
    "rt_kmeans_update": "pppiiiiipppp",
    # q k v o lse, B S T H K D, the (b, seq, head) strides of q, k and v,
    # causal window prefix_len, scale, stream; bf16 also takes vec before
    # the scale
    "rt_flash_attention_forward_f32": "ppppp" + "i" * 18 + "fp",
    "rt_flash_attention_forward_bf16": "ppppp" + "i" * 19 + "fp",
    # q k v o dout lse delta dq dk dv, B S T H K D, the (b, seq, head)
    # strides of q, k, v, o and dout, causal window prefix_len, scale,
    # stream
    "rt_flash_attention_backward_f32": "p" * 10 + "i" * 24 + "fp",
    "rt_flash_attention_backward_bf16": "p" * 10 + "i" * 24 + "fp",
    # (bf16, D, prefix, lse, out[4]), (bf16, D, prefix, kernel, out[4]),
    # (bf16, N, M, dh, out[4]), (bf16, dh, out[4]) and (bf16, d, K,
    # out[4]): the attributes of the kernel a launch takes, see
    # kernel_attributes
    "rt_flash_attention_attributes": "iiiip",
    "rt_flash_attention_backward_attributes": "iiiip",
    "rt_set_attention_forward_attributes": "iiiip",
    "rt_set_attention_backward_attributes": "iiiip",
    "rt_wkv_attributes": "iip",
    "rt_wkv_backward_attributes": "iip",
    "rt_kmeans_assign_attributes": "iiip",
    "rt_kmeans_update_attributes": "iiip",
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
    """"cpu", "cuda" or "meta" when every given tensor lies there; raises
    on a mix or on any other device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) == 1:
        kind = devices.pop().type
        if kind in ("cpu", "cuda", "meta"):
            return kind
    raise ValueError(f"kernel inputs must all be on the CPU, all on one "
                     f"CUDA device or all on meta, got "
                     f"{sorted(map(str, devices))}")


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


def float_or_bf16(t: torch.Tensor, name: str) -> int:
    """1 for a bf16 tensor, 0 for an fp32 one (the `bf16` argument of the
    entry points with instances of both); raises for any other dtype."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, got "
                        f"{t.dtype}")
    return int(t.dtype == torch.bfloat16)


def rows_aligned(nbytes: int, *tensors: torch.Tensor) -> bool:
    """True when every row (last dim) of every tensor starts on an
    `nbytes` boundary: the data pointer, the row length and the strides of
    the leading dims (those of size > 1) are multiples of `nbytes`. The
    kernels then load and store rows by vectors of that many bytes."""
    for t in tensors:
        es = t.element_size()
        if t.data_ptr() % nbytes or (t.shape[-1] * es) % nbytes:
            return False
        if any((st * es) % nbytes
               for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1):
            return False
    return True


def rows_aligned_16(*tensors: torch.Tensor) -> bool:
    """`rows_aligned` at 16 bytes."""
    return rows_aligned(16, *tensors)


_COUNTS = threading.Lock()


def counted(wrapper, bf16: int = 0) -> None:
    """One launch more on a wrapper's count (`launches`, and `bf16` more
    of its bf16 instances, `launches_bf16`), under a lock: the ranks of a
    mesh run as threads of one process (`collectives.run_threads`) launch
    kernels at once."""
    with _COUNTS:
        wrapper.launches += 1
        if bf16:
            wrapper.launches_bf16 += bf16


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def kernel_attributes(entry: str, *args: int) -> dict:
    """Registers a thread, static and dynamic shared bytes a block, and
    local (spill) bytes a thread of the kernel that a launch with these
    arguments takes (`cudaFuncGetAttributes` through `entry`)."""
    out = (ctypes.c_int * 4)()
    check(getattr(load_library(), entry)(*args, ctypes.addressof(out)),
          entry)
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes"), out))


def check(rc: int, name: str) -> None:
    """Raises when a launch was refused (rc is its cudaGetLastError)."""
    if rc != 0:
        msg = load_library().rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
