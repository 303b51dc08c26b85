"""ctypes adapter over the native C++ annealer, ``native/sa_sampler.cpp``
(the ``"SA-NATIVE"`` solver).

The library is compiled from that source with g++ on first use (the
compiler ``QBMX_NATIVE_CC`` names, else ``g++``), with ``qbmx``'s flags,
into ``build/native/`` at the root of the checkout.  Its name carries a
hash of the source, the compiler, the flags and the CPU that
``-march=native`` resolves to, so an edit rebuilds it and a library built
for another host is never loaded.  The source is ``qbmx``'s own, so both
packages draw the same samples bit for bit from the same seeds and QUBOs.

The sampler runs on the host: a batch of QUBOs is pulled to the host,
annealed in C++ threads (one xoshiro256** stream a chain, keyed by its
problem's seed and its read index), and the samples are returned on the
QUBOs' device.  A build that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from qbmx_torch.core.rng import draw_seeds

ROOT = Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "native" / "sa_sampler.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_F32P, _U64P, _F64P = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_double))


def _compiler() -> str:
    return os.environ.get("QBMX_NATIVE_CC", "g++")


def library_path() -> Path:
    """Where the library for the current source, compiler and host lives."""
    cc = _compiler()
    # the target -march=native picks here: a library built on another CPU
    # may use instructions this one lacks
    target = subprocess.run([cc, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    digest = hashlib.sha256("\0".join([cc, *CXX_FLAGS, target]).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libqbmx_sa_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file


def load_library() -> ctypes.CDLL:
    """The native library, compiled from ``native/sa_sampler.cpp`` if no
    build of the current source exists yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        i = ctypes.c_int
        lib.qbmx_sa_sample_batch.argtypes = [_F32P, i, i, i, i, ctypes.c_uint64, _F32P]
        lib.qbmx_sa_sample_batch.restype = None
        lib.qbmx_sa_sample_batch_seeds.argtypes = [_F32P, i, i, i, i, _U64P, _F32P]
        lib.qbmx_sa_sample_batch_seeds.restype = None
        lib.qbmx_sa_default_beta_range.argtypes = [_F32P, i, _F64P, _F64P]
        lib.qbmx_sa_default_beta_range.restype = None
        _lib = lib
        return _lib


def _host_qubos(Q) -> np.ndarray:
    Q = np.ascontiguousarray(np.asarray(Q), dtype=np.float32)
    if Q.ndim != 3 or Q.shape[1] != Q.shape[2]:
        raise ValueError(f"expected (B, n, n) QUBOs, got {Q.shape}")
    return Q


def _empty_samples(B: int, n: int, num_reads: int, num_sweeps: int) -> np.ndarray:
    if num_reads < 0 or num_sweeps < 0:
        raise ValueError(f"num_reads and num_sweeps must be >= 0, got {num_reads}, {num_sweeps}")
    return np.empty((B, num_reads, n), dtype=np.float32)


def default_beta_range(Q) -> tuple[float, float]:
    """(hot, cold) of one (n, n) QUBO as the C++ annealer computes them."""
    Q = _host_qubos(np.asarray(Q)[None])[0]
    hot, cold = ctypes.c_double(), ctypes.c_double()
    load_library().qbmx_sa_default_beta_range(Q.ctypes.data_as(_F32P), Q.shape[0],
                                              ctypes.byref(hot), ctypes.byref(cold))
    return hot.value, cold.value


def sa_sample_batch_native(seed: int, Q, num_reads: int, num_sweeps: int) -> np.ndarray:
    """(B, n, n) float32 QUBOs → (B, num_reads, n) float32 samples, problem
    b's chains seeded from ``seed ^ (b << 32)``."""
    lib = load_library()
    Q = _host_qubos(Q)
    B, n = Q.shape[0], Q.shape[-1]
    out = _empty_samples(B, n, num_reads, num_sweeps)
    lib.qbmx_sa_sample_batch(Q.ctypes.data_as(_F32P), B, n, num_reads, num_sweeps,
                             ctypes.c_uint64(int(seed) & (2**64 - 1)), out.ctypes.data_as(_F32P))
    return out


def sa_sample_batch_native_seeds(seeds, Q, num_reads: int, num_sweeps: int) -> np.ndarray:
    """Per-problem seeds: ``seeds`` (B,) uint64, one a problem; problem b's
    samples depend on ``seeds[b]`` and its QUBO alone."""
    lib = load_library()
    Q = _host_qubos(Q)
    B, n = Q.shape[0], Q.shape[-1]
    seeds = np.ascontiguousarray(np.asarray(seeds), dtype=np.uint64)
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be ({B},) uint64, got {seeds.shape}")
    out = _empty_samples(B, n, num_reads, num_sweeps)
    lib.qbmx_sa_sample_batch_seeds(Q.ctypes.data_as(_F32P), B, n, num_reads, num_sweeps,
                                   seeds.ctypes.data_as(_U64P), out.ctypes.data_as(_F32P))
    return out


class NativeSASampler:
    """Sampler-protocol wrapper over :func:`sa_sample_batch_native_seeds`:
    one 63-bit seed a problem drawn from the call's generator (true
    per-problem streams), the QUBOs annealed on the host, the samples
    returned on ``Q``'s device."""

    def __init__(self, num_sweeps: int = 1000):
        self.num_sweeps = int(num_sweeps)

    def sample_batch(self, generator, Q: torch.Tensor, num_reads: int) -> torch.Tensor:
        seeds = draw_seeds(generator, Q.shape[0])
        out = sa_sample_batch_native_seeds(seeds, Q.detach().cpu().numpy(), num_reads,
                                           self.num_sweeps)
        return torch.from_numpy(out).to(Q.device)
