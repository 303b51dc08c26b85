"""The least time the anneal calls of an epoch could take on one NVIDIA
H100 SXM, counted from a configuration's sizes alone.

This is the yardstick of the rooflines and of ``step_mfu_pct``, frozen
here so that no change to the program can move it.  It counts the work
the model's definition asks for: every sampler call anneals, per problem
and read (and rung of a tempering ladder), each free unit of its phase
once a sweep -- the hidden units with the labels clamped, the hidden and
output units with them free.  Padding rows and padding variables that a
program adds to fill a batch or a call are not counted.

Peaks (NVIDIA's data sheet, H100 SXM, at the full 700 W): 67 TFLOP/s
float32 outside the tensor cores, which counts an FMA as two flops, so the
card issues at most 33.5e12 instructions a second and half as many int32
multiplies; 3.35 TB/s of HBM3.  A decision draws one Philox4x32-10 uniform
(10 rounds of two ``mul.hi``, two ``mul.lo``, four xors and two key adds on
four draws: 25 operations, 10 of them multiplies) and turns it into a
verdict (a logarithm, a division, a product and a comparison: 4 more).  A
call moves at least its couplings, its linear terms, two schedule floats a
problem and rung, and its samples, each once, in float32.
"""

from __future__ import annotations

from benchmark import registry

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
ISSUE_PER_S = FP32_FLOPS_PER_S / 2
IMUL_PER_S = ISSUE_PER_S / 2
PHILOX_OPS, PHILOX_IMULS = 25, 10
OPS_PER_DECISION = PHILOX_OPS + 4


def decisions(problems: int, reads: int, free_units: int, sweeps: int, rungs: int = 1) -> int:
    """Decisions of one phase of a call: each free unit once a sweep, in
    every read (and rung) of every problem."""
    return problems * reads * free_units * sweeps * rungs


def phase_bytes(problems: int, reads: int, free_units: int, rungs: int = 1,
                coupling_groups: int = 1) -> int:
    """Bytes one phase of a call moves at the least, float32 throughout."""
    n = free_units
    return 4 * (coupling_groups * n * n + problems * n + 2 * problems * rungs
                + problems * reads * n)


def call_seconds(phases) -> float:
    """The least time of one call of ``phases``: ``(problems, reads,
    free_units, sweeps, rungs, coupling_groups)`` tuples, one a phase the
    call anneals.  The larger of its bytes over the memory rate and its
    operations over the issue rate (the int32 multiplies over theirs)."""
    d = sum(decisions(p, r, n, s, m) for p, r, n, s, m, _ in phases)
    nbytes = sum(phase_bytes(p, r, n, m, g) for p, r, n, s, m, g in phases)
    t_ops = max(d * OPS_PER_DECISION / ISSUE_PER_S, d * PHILOX_IMULS / IMUL_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def epoch_calls(cfg: dict, mix: dict) -> list:
    """The anneal calls of one epoch of the cell, each as ``call_seconds``'s
    phases: one call a training step over both phases of every seed, then
    the validation calls over the unclamped phase, with real rows only."""
    t = registry.settings(cfg, mix)
    seeds, rungs = mix["seeds"], mix.get("rungs", 1)
    free_c, free_u = cfg["free_units"]["clamped"], cfg["free_units"]["unclamped"]
    reads, sweeps = t["sample_count"], t["anneal"]
    batch, chunk = t["batch"], t.get("predict_chunk") or cfg["data"]["val"]
    calls = []
    rows = cfg["data"]["train"]
    for start in range(0, rows, batch):
        real = min(batch, rows - start) * seeds
        calls.append([(real, reads, free_c, sweeps, rungs, seeds),
                      (real, reads, free_u, sweeps, rungs, seeds)])
    rows = cfg["data"]["val"]
    for start in range(0, rows, chunk):
        real = min(chunk, rows - start) * seeds
        calls.append([(real, reads, free_u, sweeps, rungs, seeds)])
    return calls


def epoch_seconds(cfg: dict, mix: dict) -> float:
    """The least time of every anneal call of one epoch."""
    return sum(call_seconds(c) for c in epoch_calls(cfg, mix))
