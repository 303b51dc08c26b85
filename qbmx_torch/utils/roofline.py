"""The least time an anneal launch (or an RBM epoch) could take on one
NVIDIA H100 SXM: the larger of the bytes it must move over the memory rate
and the operations it must do over the rate the card can issue them
(NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the
tensor cores and 989 TFLOP/s dense bf16 on them, at the full 700 W).

Bytes: each input read once, the output written once (Philox mode: no
variates).  Operations, counted from the run's inputs:

* every decision draws a uniform -- Philox4x32-10 spends 10 rounds of two
  ``mul.hi``, two ``mul.lo``, four xors and two key adds on four draws, 25
  operations a draw, 10 of them int32 multiplies -- and turns it into a
  verdict (a logarithm, a division, a product and a comparison: 4 more),
  :data:`OPS_PER_DECISION`;
* every change of a variable i adds ±J_ij to the fields of row i's
  nonzeros, one FMA each: the work the changes need, whatever implements
  them (a kernel that adds a dense row does more, and a sparse row list no
  less).  K4 and K5 count it (``flip_work``, their second ``flips``
  counter: the nonzeros of the changed rows); K1 and K2 count only the
  changes (``flips``), taken at n FMAs each, as on a dense J; a kernel that
  counts neither is bounded by its decisions alone, a lower bound still.

Beside that bound, which any implementation must respect, a layout may
be held to the traffic its own design cannot avoid: K4's global-field
layout and K5's global path keep each chain's fields and state bytes in
global memory, so each sweep reads and writes them at least once
(:func:`global_field_bytes`, added by ``anneal_bound``'s ``layout_bytes``).

The 67 TFLOP/s count an FMA as two flops, so the card issues at most 33.5e12
float32 instructions a second (4 schedulers × 32 lanes × 132 SMs at 1.98
GHz), an FMA one of them; an add, xor or comparison takes an issue slot as
well, so every operation above is taken at that rate.  Int32 multiplies
issue at half of it, 16.75e12 a second, which bounds the Philox draws
apart.  The operations' time is the larger of the two.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
ISSUE_PER_S = FP32_FLOPS_PER_S / 2  # instructions a second; an FMA is two flops
IMUL_PER_S = ISSUE_PER_S / 2  # int32 multiplies a second
PHILOX_OPS, PHILOX_IMULS = 25, 10  # a draw's operations, and its int32 multiplies
OPS_PER_DECISION = PHILOX_OPS + 4


def heatbath_units(n: int, width: int) -> int:
    """Decisions (one draw each) of a heat-bath sweep of n variables at
    update width 1, 2 or 4: singles; pairs and a trailing single; quads,
    then a remainder pair and/or single (``samplers/gibbs.py``'s schedule)."""
    if width == 1:
        return n
    if width == 2:
        return n // 2 + n % 2
    if width == 4:
        r = n % 4
        return n // 4 + (r >= 2) + r % 2
    raise ValueError(f"no heat-bath update of width {width}")


def global_field_bytes(chains: int, n: int, S: int) -> int:
    """Bytes the global-field layout moves through its scratch at the least:
    each sweep reads and writes each chain's (or rung's) fields, float32,
    and state bytes once, rows of n rounded up to 8."""
    return chains * S * 2 * 5 * (-(-n // 8) * 8)


def anneal_bound(G: int, B: int, R: int, n: int, S: int, *, decisions: int | None = None,
                 flips: int | None = None, flip_work: int | None = None,
                 J_groups: int | None = None, rungs: int = 1, layout_bytes: int = 0) -> dict:
    """``{"bound_ms", "bound_by", "bytes", "ops"}`` of one launch over G
    groups of B problems (couplings of ``J_groups`` problems, default G;
    linear terms and two schedule floats per problem and rung), R reads
    (of ``rungs`` chains each: a tempering ladder), width n, S sweeps;
    ``decisions`` defaults to G·B·rungs·R·n·S.  The changes' FMAs are
    ``flip_work`` (the nonzeros of the changed rows) where counted, else
    ``flips``·n.  ``layout_bytes`` adds a layout's own traffic
    (:func:`global_field_bytes`) to the bytes."""
    J_groups = G if J_groups is None else J_groups
    nbytes = 4 * (J_groups * n * n + G * B * n + 2 * G * B * rungs + G * B * R * n) \
        + layout_bytes
    decisions = G * B * rungs * R * n * S if decisions is None else decisions
    fmas = flip_work if flip_work is not None else (flips or 0) * n
    ops = decisions * OPS_PER_DECISION + fmas
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / ISSUE_PER_S, decisions * PHILOX_IMULS / IMUL_PER_S)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def rbm_cd1_bound(steps: int, B: int, V: int, H: int, C: int = 2) -> dict:
    """``{"bound_ms", "bound_by", "bytes", "flops"}`` of ``steps`` CD-1 steps
    in bf16 compute mode (``models/rbm.py``) at batch B, V visible, H hidden
    and C class units.  A step's products: the three whose states are cast
    up to f32 (the data's hidden probabilities, the visible
    reconstruction, the reconstruction's hidden probabilities: 2·B·V·H
    flops each, and 2·B·C·H for each class term) at the f32 rate, and the
    two bf16 statistics products (2·V·B·H, 2·C·B·H) at the bf16 rate.
    Bytes: each step reads its bf16 batch and int64 labels and reads and
    writes the f32 parameters once."""
    f32_flops = steps * (3 * 2 * B * V * H + 3 * 2 * B * C * H)
    bf16_flops = steps * 2 * B * H * (V + C)
    nbytes = steps * (2 * B * V + 8 * B + 2 * 4 * (V * H + V + H + C + C * H))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_flops / FP32_FLOPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": f32_flops + bf16_flops}
