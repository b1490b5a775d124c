"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled by ``nvcc`` for ``sm_90a`` (one process per source, all started
together), linked into one shared library under
``build/repro_torch_kernels/<hash of sources and flags>/`` in the checkout,
and loaded with ``ctypes``. A missing ``nvcc``, a failed build or a refused
launch raises; nothing falls back to the plain PyTorch versions.

Every launch goes through :func:`launch`, which adds one to that kernel's
count in :data:`LAUNCHES`. The plain versions note calls made on CUDA
tensors in :data:`PLAIN_ON_CUDA`; the main path on the card makes none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("act_quant.cu", "int8_matmul.cu", "int4_matmul.cu",
           "decode_attention.cu")
HEADERS = ("int_gemm.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# no --use_fast_math: it makes '/' and tanhf approximate and breaks parity
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry -> argtypes (pointers and the stream as c_void_p, sizes and flags
#: as c_int, the softmax scale as c_float)
SIGNATURES = {
    "act_quant": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "int8_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "int4_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "int4_matmul_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

#: kernel launches since the last :func:`reset_counts`
LAUNCHES: dict[str, int] = {name: 0 for name in SIGNATURES}
#: plain-version calls on CUDA tensors since the last :func:`reset_counts`
PLAIN_ON_CUDA: dict[str, int] = {name: 0 for name in SIGNATURES}

_LIB = None
_LOCK = threading.Lock()


def reset_counts() -> None:
    for table in (LAUNCHES, PLAIN_ON_CUDA):
        for name in table:
            table[name] = 0


def note_plain(t: torch.Tensor, name: str) -> None:
    """Called by each plain version: counts its use on a CUDA tensor."""
    if t.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """nvcc each source to an object in parallel, then link the library.
    Returns the compilers' combined diagnostics (ptxas register counts)."""
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    objs = [str(out_dir / (Path(s).stem + ".o")) for s in SOURCES]
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                           str(out_dir / LIB_NAME), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return "\n".join(log)


def library_path() -> Path:
    """Path of the built library, building it first if needed."""
    final = BUILD_ROOT / source_hash()
    if (final / LIB_NAME).is_file():
        return final / LIB_NAME
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp_"))
    try:
        (tmp / "build.log").write_text(_compile(tmp))
        try:
            os.rename(tmp, final)
        except OSError:
            if not (final / LIB_NAME).is_file():   # not a concurrent build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return final / LIB_NAME


def build_log() -> str:
    path = library_path().parent / "build.log"
    return path.read_text() if path.is_file() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name + "_launch")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` and count
    it. Raises when CUDA refuses the launch."""
    fn = getattr(library(), name + "_launch")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Validate what a kernel takes: device, dtype, shape, contiguity."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernels take CUDA tensors, got "
                         f"{device}; CPU tensors go to the plain versions")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
