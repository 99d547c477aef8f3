"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object file (one ``nvcc`` per source, all started together), and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, inside the checkout, and again when a
source or the flags change (the build directory is named by their hash).

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :class:`Kernel` raises on a non-zero code and
counts the launch. Nothing here runs when the module is imported.
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
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "neuralsim_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libneuralsim_torch_kernels.so"

# C entry points: name -> argument codes ('p' pointer or stream, 'i' int,
# 'f' float). Every entry returns an int (a cudaError_t).
SIGNATURES: Dict[str, str] = {
    "lotd_cp_stacked_fwd": "pppppiiiip",
    "lotd_cp_stacked_bwd": "ppppppiiiip",
    "lotd_cp_level_fwd": "pppppiiip",
    "lotd_cp_level_bwd": "ppppppiiip",
    "lotd_grid_fwd": "ppppppiiiiiiiiip",
    "lotd_grid_bwd": "pppppppiiiiiiip",
    "lotd_grid_bwd_x": "ppppppiiiiiip",
    "neus_upsample_weights_pdf": "pppppppppiiifp",
    "merge_sorted_samples": "pppppppppiiip",
    "volume_composite_fwd": "pppppppppppiip",
    "volume_composite_bwd": "ppppppppppppppiip",
    "neus_composite_fwd": "ppppppppppppppiifp",
    "neus_composite_bwd": "pppppppppppppppppiifp",
    "occ_ray_proposal": "ppppppppppppiiiiip",
    "occ_ema_update": "pppppppiiiffffffip",
    "occ_voxel_points": "ppppppiiffp",
    "cross_source_vw": "ppppppiip",
    "cross_source_vw_bwd": "ppppppiip",
    "pair_compact": "ppppiiiip",
    "permuto_fwd": "pppppppiiiiip",
    "permuto_bwd": "ppppppppppiiiiip",
    "latent_take_fwd": "pppiiiiip",
    "latent_take_bwd": "pppppiiiiiiip",
    "lotd_cp_lines_fwd": "ppppppiiip",
    "lotd_cp_lines_bwd": "pppppppiiiip",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if their build is missing) and return the .so."""
    global build_log
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out.parent))
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         str(tmp / LIB_NAME), *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    try:
        os.replace(tmp, out)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, codes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[c] for c in codes]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how many
    times the main path launched it (``launches``, a plain integer)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, entry: str, *args) -> None:
        rc = getattr(library(), entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {entry} failed with CUDA error {rc}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    return KERNELS.setdefault(name, Kernel(name, source, replaces))


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, read once a device: a wrapper that sizes a
    scratch by it runs in every training step, and every training path is
    host-bound."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# the tickets of the kernels whose last block finishes the work, one a
# (device, stream, words): zeroed once, left 0 by every launch
_tickets: Dict[tuple, torch.Tensor] = {}


def ticket(dev: torch.device, words: int) -> torch.Tensor:
    """A zeroed int32 [words] scratch on ``dev`` for the launches on the
    current stream (:func:`stream`), made once: each launch that takes it
    leaves it 0, so launches in stream order share it."""
    key = (dev.index, stream(), words)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(words, dtype=torch.int32, device=dev)
    return t


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}")
