"""Build the port's native libraries and load them with ctypes.

Each hand-written CUDA kernel is one source, ``csrc/<name>.cu``, with a
plain C interface, compiled by ``nvcc`` for Hopper (``sm_90a``). The C++
sampling service, ``csrc/occ_sampler.cpp``, and the multilevel graph
partitioner, ``csrc/partition.cpp``, are compiled by ``g++`` with the
flags of the JAX package's ``csrc/Makefile``, and the service's stress
driver, ``csrc/stress_test.cpp``, with a sanitizer. All are built into
``occ_gnn_tpu_torch/build/`` at first use. A library's file name carries
a hash of its source and flags, so an edited source is built anew, and
it is written through a temporary file and ``os.replace``, so processes
building at once never overwrite each other's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
KERNELS = ("segment_sum_sorted", "dense_gather_sum", "gat_attention",
           "device_sample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SAMPLER_SOURCE = CSRC_DIR / "occ_sampler.cpp"
PARTITIONER_SOURCE = CSRC_DIR / "partition.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread", "-shared")
STRESS_SOURCE = CSRC_DIR / "stress_test.cpp"
SANITIZERS = ("thread", "address")

# Every kernel library's error-text entry, cuda_error_string(int).
ERROR_STRING_ARGTYPES = [ctypes.c_int]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                           "CUDA_HOME to it")
    return path


def _cxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("g++ not found: the C++ sampling service needs a "
                           "C++17 compiler (set CXX to another one)")
    return path


def _digest(sources, flags) -> str:
    data = b"".join(src.read_bytes() for src in sources)
    return hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:12]


def _hashed_path(source: Path, flags) -> Path:
    return BUILD_DIR / f"lib{source.stem}-{_digest([source], flags)}.so"


def _build(source: Path, compiler: str, flags, out: Path | None = None,
           extra: tuple[Path, ...] = ()) -> str:
    """Compile ``source`` (and the ``extra`` sources) into ``out``, by
    default the hashed library path, unless it exists already."""
    out = out or _hashed_path(source, flags)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source),
                           *map(str, extra)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed for {source.name}:"
                           f"\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def _load(key: str, path: Path) -> ctypes.CDLL:
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        _loaded[key] = lib
    return lib


def library_path(name: str) -> Path:
    return _hashed_path(CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build_kernel(name: str) -> str:
    """Compile the named kernel unless it is built already. Returns the
    compiler's report (ptxas registers, shared memory, spills), empty when
    nothing was built."""
    return _build(CSRC_DIR / f"{name}.cu", _nvcc(), NVCC_FLAGS)


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed; loaded once a process."""
    if name not in _loaded:
        build_kernel(name)
        lib = _load(name, library_path(name))
        lib.cuda_error_string.argtypes = ERROR_STRING_ARGTYPES
        lib.cuda_error_string.restype = ctypes.c_char_p
    return _loaded[name]


def build_sampler() -> str:
    """Compile the C++ sampling service unless it is built already.
    Returns the compiler's output, empty when nothing was built."""
    return _build(SAMPLER_SOURCE, _cxx(), CXX_FLAGS)


def load_sampler() -> ctypes.CDLL:
    """The sampling service's library, built first if needed."""
    if "occ_sampler" not in _loaded:
        build_sampler()
        _load("occ_sampler", _hashed_path(SAMPLER_SOURCE, CXX_FLAGS))
    return _loaded["occ_sampler"]


def build_partitioner() -> str:
    """Compile the multilevel partitioner unless it is built already.
    Returns the compiler's output, empty when nothing was built."""
    return _build(PARTITIONER_SOURCE, _cxx(), CXX_FLAGS)


def load_partitioner() -> ctypes.CDLL:
    """The partitioner's library, built first if needed."""
    if "partition" not in _loaded:
        build_partitioner()
        _load("partition", _hashed_path(PARTITIONER_SOURCE, CXX_FLAGS))
    return _loaded["partition"]


def build_stress(sanitizer: str) -> Path:
    """The sampling service's stress driver: ``csrc/stress_test.cpp``
    linked with ``csrc/occ_sampler.cpp`` into an executable under
    ``-fsanitize=thread`` or ``address`` (``sanitizer``), with the flags
    of the JAX Makefile's ``tsan-stress`` / ``asan-stress`` rules; built
    unless it is built already. Returns its path."""
    if sanitizer not in SANITIZERS:
        raise ValueError(f"sanitizer {sanitizer!r} is not one of "
                         f"{SANITIZERS}")
    flags = ("-O1", "-g", f"-fsanitize={sanitizer}", "-std=c++17",
             "-pthread")
    sources = (STRESS_SOURCE, SAMPLER_SOURCE)
    out = BUILD_DIR / f"stress_{sanitizer}-{_digest(sources, flags)}"
    _build(STRESS_SOURCE, _cxx(), flags, out=out, extra=(SAMPLER_SOURCE,))
    return out


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
