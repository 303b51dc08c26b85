"""What the CUDA kernel wrappers (``sa_cuda``, ``gibbs_cuda``, ``wide_cuda``,
``pt_cuda``) share: the checks of the arguments they pass, the boundary
between the anneal kernels that hold a group's couplings in shared memory
and the one that streams them, the stream, and the launch's return code.
Each wrapper makes its own launch call and counts its own launches."""

from __future__ import annotations

import torch

# one block's shared memory on Hopper (227 KB)
SMEM_BYTES = 232_448
# streaming multiprocessors of an H100 SXM: the launch-geometry rules
# (sa_cuda.k1_layout, wide_cuda.wide_geometry) size their layouts by it
NUM_SMS = 132


def fits_shared(n: int) -> bool:
    """Whether a group's couplings J_g ((n, n) float32) fit one block's
    shared memory, i.e. n ≤ 241.  The anneal wrappers launch K1
    (``sa_metropolis.cu``) or K2 (``sa_heatbath.cu``) when they do and K4
    (``anneal_wide.cu``), which streams J_g in row tiles, when they do not."""
    return 4 * n * n <= SMEM_BYTES


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
            dtype: torch.dtype = torch.float32) -> None:
    """Refuse what a kernel cannot read: another device, dtype, shape or a
    non-contiguous layout."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {str(dtype).removeprefix('torch.')} tensor of shape "
            f"{shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def variate_ptrs(host_variates, specs: tuple, device: torch.device) -> tuple:
    """Device pointers of ``host_variates`` checked against ``specs``
    ((name, shape), ...); all null in generator mode."""
    if host_variates is None:
        return (None,) * len(specs)
    if len(host_variates) != len(specs):
        raise ValueError(f"host_variates: need ({', '.join(name for name, _ in specs)})")
    for t, (name, shape) in zip(host_variates, specs):
        require(t, name, shape, device)
    return tuple(t.data_ptr() for t in host_variates)


def structured_ptrs(kernel: str, max_n: int, J, h, hot, logr, num_reads: int,
                    num_sweeps: int, host_variates) -> tuple:
    """Check the structured form of an anneal kernel (``J`` (G, n, n),
    ``h`` (G, B, n), ``hot``/``logr`` (G, B), ``host_variates`` (init01
    (G, B, R, n), uniforms (S, G, B, n, R))) and return its six pointers."""
    G, B, n = h.shape
    dev = h.device
    for t, name, shape in ((J, "J", (G, n, n)), (h, "h", (G, B, n)),
                           (hot, "beta_hot", (G, B)), (logr, "logr", (G, B))):
        require(t, name, shape, dev)
    if n > max_n:
        raise ValueError(f"{kernel} kernel: n={n} exceeds its bound (n ≤ {max_n})")
    if G > 65535:
        raise ValueError(f"{kernel} kernel: {G} groups exceed the grid's 65535")
    R, S = num_reads, num_sweeps
    variates = variate_ptrs(host_variates, (("init01", (G, B, R, n)),
                                            ("uniforms", (S, G, B, n, R))), dev)
    return (J.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(), *variates)


def optional_ptr(t: torch.Tensor | None, name: str, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
    """Device pointer of an optional output of a kernel (null for None)."""
    if t is None:
        return None
    require(t, name, shape, device, dtype)
    return t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
