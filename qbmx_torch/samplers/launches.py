"""The launch counts of every kernel, read and zeroed together.  Each
kernel's wrapper adds one to its count (its module's ``launch_counts``)
where it launches the kernel, and nowhere else."""

from __future__ import annotations

from qbmx_torch.samplers import gibbs_cuda, pt_cuda, pt_wide_cuda, sa_cuda, wide_cuda

#: the wrapper modules, K1 to K5
MODULES = (sa_cuda, gibbs_cuda, pt_cuda, wide_cuda, pt_wide_cuda)


def counts() -> dict:
    """``{kernel: launches}`` of every kernel launched in this process
    since the counts were last zeroed."""
    return {k: v for m in MODULES for k, v in m.launch_counts.items() if v}


def reset() -> None:
    for m in MODULES:
        m.reset_launch_counts()
