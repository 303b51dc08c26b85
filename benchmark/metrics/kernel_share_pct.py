"""The share of the traced epochs' host-clock time that the port's own
kernels (K1-K5, csrc/*.cu) ran on the device.  A kernel counts by a stem
of its name; where the launch counters saw launches and no device time
matches a stem, the run fails: the names moved and this file must follow."""

#: name stems of the port's kernels: K1, K2, K3, K4 (shared, sparse and
#: global layouts), K5 (shared, sparse and global paths)
KERNELS = ("sa_metropolis", "sa_heatbath", "pt_heatbath", "anneal_wide", "anneal_global",
           "pt_wide", "pt_global")


def kernel_seconds(t):
    s = t.device_seconds(KERNELS)
    if sum(t.launches.values()) and s <= 0.0:
        raise RuntimeError(f"launches counted ({t.launches}) but no device time matched "
                           f"{KERNELS}")
    return s


def read(m):
    t = m.trace
    if t is None:
        return None
    s = kernel_seconds(t)
    return 100.0 * s / t.window_s if s > 0 else None
