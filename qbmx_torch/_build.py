"""Build the port's CUDA sources into a shared library on first use.

Runs one ``nvcc`` per ``qbmx_torch/csrc/*.cu``, all at once, and links the
objects into one library in ``build/kernels/`` at the root of the checkout
(a plain C interface, no PyTorch headers, so the build takes seconds); the
library is loaded with ``ctypes``.  Its name carries a content hash of
every source and header in ``csrc/`` and of the flags, so editing either
rebuilds it and an unchanged tree reuses the last build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# no --use_fast_math: the kernels' thresholds need IEEE logf/expf and
# division to agree with their plain PyTorch versions
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


class BuildInfo:
    """What the last :func:`load_kernels` call did (for reports)."""

    seconds: float = 0.0
    built: bool = False
    path: str = ""


info = BuildInfo()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError(
            "qbmx_torch kernels need the CUDA toolkit: nvcc was not found "
            "(set CUDA_HOME to the toolkit root)")
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"qbmx_torch kernels need nvcc, not found at {nvcc} "
                           "(set CUDA_HOME to the toolkit root)")
    return str(nvcc)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    entries = {
        # J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
        # inv_span, seed, lanes, stream
        "qbmx_sa_metropolis": [p] * 9 + [i] * 5 + [f, u64, i, p],
        # J, h, hot, logr, init01, uniforms, out, fields_out, flips, G, B, R, n, S,
        # inv_span, seed, width, lanes, stream
        "qbmx_sa_heatbath": [p] * 9 + [i] * 5 + [f, u64, i, i, p],
        # J, row_nnz, h, hot, logr, init01, uniforms, out, fields_out, flips, fscr, sscr,
        # vals, cols, offsets, nnz_pad, G, B, R, n, S, inv_span, seed, rule, chains, stream
        "qbmx_anneal_wide": [p] * 15 + [i] * 6 + [f, u64, i, i, p],
        # vals, cols, offsets, units, h, hot, logr, init01, uniforms, out, fields_out, flips,
        # nnz_pad, G, B, R, n, S, inv_span, seed, rule, chains, stream
        "qbmx_anneal_wide_sparse": [p] * 12 + [i] * 6 + [f, u64, i, i, p],
        # J, h, betas, dbeta, init01, uniforms, swap_u, out, B, M, R, n, S, seed, lanes,
        # stream
        "qbmx_pt_heatbath": [p] * 8 + [i] * 5 + [u64, i, p],
        # J, row_nnz, h, betas, dbeta, init01, uniforms, swap_u, out, states_out,
        # fields_out, energy_out, flips, G, B, M, R, n, S, seed, ladders, cluster, stream
        "qbmx_pt_wide": [p] * 13 + [i] * 6 + [u64, i, i, p],
        # J, row_nnz, h, betas, dbeta, init01, uniforms, swap_u, out, states_out,
        # fields_out, energy_out, flips, fields, state, energies, rho, vals, cols, offsets,
        # nnz_pad, G, B, M, R, n, S, seed, warps, var_shift, stream
        "qbmx_pt_wide_global": [p] * 20 + [i] * 7 + [u64, i, i, p],
        # vals, cols, offsets, h, betas, dbeta, init01, uniforms, swap_u, out, states_out,
        # fields_out, energy_out, flips, G, B, M, R, n, S, seed, nnz_pad, ladders, cluster,
        # stream
        "qbmx_pt_wide_sparse": [p] * 14 + [i] * 6 + [u64, i, i, i, p],
    }
    for name, argtypes in entries.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    for name in ("qbmx_sa_metropolis_max_n", "qbmx_sa_heatbath_max_n",
                 "qbmx_sa_metropolis_thread_max_n", "qbmx_sa_heatbath_thread_max_n",
                 "qbmx_anneal_wide_max_n",
                 "qbmx_pt_heatbath_max_n", "qbmx_pt_heatbath_max_rungs", "qbmx_pt_wide_max_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.qbmx_anneal_wide_smem.argtypes = [i, i]  # n, chains
    lib.qbmx_anneal_wide_sparse_smem.argtypes = [i, i, i]  # n, chains, nnz_pad
    lib.qbmx_pt_heatbath_smem.argtypes = [i, i, i]  # lanes, n, M
    lib.qbmx_pt_wide_smem.argtypes = [i, i]  # n, warps
    lib.qbmx_pt_wide_sparse_smem.argtypes = [i, i, i]  # n, warps, nnz_pad
    for name, argtypes in (("qbmx_pt_wide_max_rungs", [i]),  # n
                           ("qbmx_pt_wide_block_rungs", [i]),  # n
                           ("qbmx_pt_wide_sparse_block_rungs", [i, i]),  # n, nnz_pad
                           ("qbmx_pt_wide_max_active_clusters", [i, i, i, i])):  # n, M, K, nnz_pad
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    lib.qbmx_anneal_wide_global_smem.argtypes = [i, i]  # chains, sparse
    lib.qbmx_pt_wide_global_smem.argtypes = [i, i]  # warps, sparse
    for fn in (lib.qbmx_anneal_wide_smem, lib.qbmx_anneal_wide_sparse_smem,
               lib.qbmx_pt_heatbath_smem, lib.qbmx_pt_wide_smem,
               lib.qbmx_pt_wide_sparse_smem, lib.qbmx_anneal_wide_global_smem,
               lib.qbmx_pt_wide_global_smem):
        fn.restype = ctypes.c_ulonglong
    return lib


def source_digest(csrc: Path = CSRC) -> str:
    """Hash of the flags and of every ``*.cu`` and ``*.cuh`` under ``csrc``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return digest.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def load_kernels() -> ctypes.CDLL:
    """The kernels' library, compiled from the current sources if no build
    of them exists yet."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"libqbmx_kernels_{source_digest()}.so"
    t0 = time.perf_counter()
    info.built = not so.exists()
    if info.built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tmp = _nvcc(), so.with_suffix(f".{os.getpid()}.tmp")
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [tmp.with_suffix(f".{src.stem}.o") for src in srcs]
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                      for src, o in zip(srcs, objs)])
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    _lib = _declare(ctypes.CDLL(str(so)))
    info.seconds = time.perf_counter() - t0
    info.path = str(so)
    return _lib
