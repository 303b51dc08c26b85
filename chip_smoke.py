#!/usr/bin/env python3
"""GPU smoke test of the PyTorch / CUDA port (``qbmx_torch``).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

Five hand-written kernels, K4 and K5 each also in a global-field layout
past their shared ones (with a dense and a sparse field pass, each with
its own launch count), are checked: K1 ``sa_metropolis`` (annealed
Metropolis), K2 ``sa_heatbath`` (annealed heat-bath, single/pair/quad
updates), K3 ``pt_heatbath`` (parallel tempering), K4 (both anneal rules
for QUBOs whose couplings exceed shared memory, n > 241, which the K1/K2
wrappers route to it), whose shared layout has two paths, each with its own
launch count and record: ``anneal_wide`` (J_g streamed in tiles: dense
QUBOs) and ``anneal_wide_sparse`` (J_g's row lists whole in shared memory,
where ``wide_cuda.shared_path`` finds J_g sparse: the CDQBM (a) SA and BMS
calls, the restricted flat model), and K5 (parallel tempering where K3
cannot hold the call: n > 241, M ≥ 16 at n = 241, or M > 64, which
``pt_wide_cuda.pt_route`` sends to it), in its two paths, each with its
own launch count and record: ``pt_wide_sparse`` (J_g's nonzero rows whole
in shared memory, where they fit a block beside its rungs: the CDQBM (a)
PT call) and ``pt_wide`` (J_g streamed in tiles: dense QUBOs); a ladder of
more rungs than a block holds spreads over a thread block cluster.  K1 and K2 each run a thread a
chain (THREAD, n ≤ ``kernel_call.THREAD_MAX_N``), 4, 8 or 16 lanes a chain
(GROUP) or a warp a chain (LANES), by one rule (``kernel_call.chain_layout``);
K3 a rung a thread (n ≤ 32), a rung on 4, 8 or 16 lanes (GROUP) or a rung a
warp (``pt_cuda.pt_layout``).  Phases (any failure exits nonzero; nothing
carries on after one):

1. device: the GPU's name, ``nvidia-smi`` name and power limit, torch and nvcc versions;
2. build: the kernels from ``qbmx_torch/csrc``, one ``nvcc`` per source at once (seconds);
3. kernel vs plain PyTorch under the same numpy-seeded host variates: K1
   and K2 pair (a thread a chain) at the flagship structured shape (G=2,
   B=60, n=6, R=1000, S=1000), K1 (8 lanes a chain), K2 single and quad
   (16) at the dense CDQBM bench shape (B=60, n=41, R=100, S=1000), K1 and K2
   pair (a warp a chain) at the CDQBM default call (G=2, B=3, n=41, R=100,
   S=1000), with the layouts the rule picks there; K1 and K2 pair past
   n = 8 (``chain_layouts_check``, S cut to 100) at the search's h8 call
   (G=20, B=20, R=1000, n=9), at n = THREAD_MAX_N and THREAD_MAX_N + 1
   (G=2, B=60, R=1000) and at the 10-seed CDQBM (b) sweep's call (G=20,
   B=3, R=100, n=41): every layout that holds the call forced and the one
   the rule picks (through the sampler's entry), and GROUP against LANES
   forced on the same draws, samples and final fields equal bit for bit;
   K3 (a rung a thread) at the flagship shape densified (120 problems,
   n=6, M=8 rungs) at R=1000, S=100 and at the main path's S=1000 with
   R=100, and (a rung a warp)
   beyond the first design's M·n ≤ 2048 at B=4, n=241, M=12, R=32, S=20;
   K3 past n = 8 (``pt_layouts_check``) at the flat PT h8 call (120
   problems, n=9, M=8; R=100 S=100 and R=1000 S=20), the CDQBM (b) PT call
   (B=6, n=41) and its 10-seed sweep's (B=60), both R=100 S=100, at n = 32
   and 33 and at M = 4, 8, 16, 32 (n=12): every layout that takes the call
   forced and the one the rule picks (through the sampler's entry), and
   GROUP against a rung a warp forced on the same draws, samples equal bit
   for bit;
   K4 Metropolis and pair at the CDQBM probabilistic-pooling shape (G=2,
   B=20, n=717, R=100, S=10), on its dense entry (B=32, n=717) and at the
   widest n the rule gives its shared layout (n=1056, R=200, S=2); K4's
   dense shared path at the call that launches it on the main path, on
   ``qbm_main -hn 300 -r False``'s step QUBOs (G=2, B=60, n=301, R=100,
   S=10; a dense ``w_hh``), and with the model's ``dense_couplings`` hint
   to the same samples bit for bit; K5's dense path through the sampler's
   structured entry against the plain version on the densified batch at
   (G=2, B=4, n=300, M=8, R=16, S=20), (G=2, B=2, n=717, M=8, R=8, S=10),
   (n, M) = (241, 16) and the CDQBM (a) PT call's shape on random QUBOs
   (G=2, B=20, n=717, M=8, R=100, S=10: four ladders a block), and launched
   directly with three ladders a block at the n=300 shape, where the last
   block holds spare ladders; K5's dense path at the flat PT step of phase
   5 (``qbm_main --solver PT -hn 300``: G=2, B=60, n=301, M=8, R=16, S cut
   to 20) on that step's own QUBOs (``DiscQBM.step_qubos``), with the
   geometry the step gets (four ladders a block on a grid of (240, 2)),
   then timed there at the step's S=100 beside its bound; K5's sparse
   path at the CDQBM (a) PT call on the step's own QUBOs
   (``CDQBM.step_qubos``: J_g 98% zeros); ladders over a thread block
   cluster, M=65 at n=4 (sparse), M=40 at n=717 on the
   step's QUBOs (sparse) and on random ones (dense): at most 1% of chains
   may end in another state (a near-tie decision from a differently
   rounded field or energy diverges that one chain); both K5 paths forced
   on the CDQBM (a) PT call at S=70 (past a refresh) must give the same
   samples, states, fields, energies and counters bit for bit; and the
   clusters of 8 blocks the card holds at once;
4. the kernels' own Philox streams: vs the exact Boltzmann oracle (K1
   marginals within 0.12 at the cold beta, each layout of K1 forced, and
   at n = 12 with the anneal ending at beta 1; K2 at each layout, also at
   n = 12, and K3 at each layout, at n = 5 and 12, within 0.08 single /
   0.05 pair and quad,
   pair moments within 0.07, at beta 1), decorrelated chains, per-problem
   streams, and
   the plain versions driven by those same draws written out on the host
   (``sa_torch.philox_variates``, ``sa_torch.pt_philox_variates``; the 1%
   bound of phase 3; K1 and K2 at every layout, at n = 6 and at
   THREAD_MAX_N; K3 at each layout at n = 6 and 9); K4 launched directly (past
   the routing) against the oracle at n in (2, 5, 8), and on its own Philox
   draws at the CDQBM shape (S=3); the incremental fields of K4 after the
   main path's S=1000 at the CDQBM (a) shape and of K2's GROUP and LANES
   layouts at the CDQBM (b) call, for every rule, against h + J·s in
   float64, within the statistical rounding limit of the adds since their
   last recomputation (``wide_cuda.field_drift_bound``), and the same check
   failing on one chain's fields each one add of their row's median |J_jk|
   short (a planted fault: the limit has teeth); K5 launched directly at n in
   (2, 5, 8) on each path against the oracle (K3's bar), on its own Philox
   draws at the n=300 shape (``pt_philox_variates(..., var_shift=10)``,
   dense) and at the step's QUBOs (sparse), and every rung's fields and
   energy after S=1000 at the CDQBM (a) PT call's shape, on each path,
   within ``field_drift_bound`` and ``energy_drift_bound``, with one add
   (fields) or one flip (energies) short planted to fail them;
5. the slices: ``qbmx_torch.cli.qbm_main.main`` on ``cuda`` (synthetic data,
   dim_input 784, H=5, 1000 reads, 1000 sweeps, bs60, one epoch = 10 steps
   plus validation and test prediction) with ``--solver`` SA, BMS and PT in
   turn; each must launch its kernel on every sampler call (the launch
   counts are zeroed just before each run and read just after), give
   finite nll and move the parameters; per-step time by CUDA events after a
   warm-up step; then ``qbmx_torch.cli.cdqbm_main.main`` on ``cuda``, one
   epoch (30 or 200 steps and 4 prediction chunks of 32) at both full-width
   configurations on synthetic 28×28 images: (a) probabilistic pooling 4,
   ``--seq_sizes 4``, sc100, anneal 1000, beta_eff 5, bs20, lr 0.02 -- a
   717-variable QUBO that must launch K4's sparse shared path
   (``anneal_wide_sparse``) on every step and prediction --
   and (b) the CLI defaults (deterministic pooling 4, 41 variables, bs3) on
   K1, and again with ``--solver BMS`` on K2, and (a) with ``--solver PT``
   at anneal 100 on K5's sparse path (never K3, never the dense path),
   then 3 of its steps at anneal 1000; the same checks and step times;
   before them ``qbm_main --solver PT`` at 300 hidden nodes (n=301, a dense
   J: K5's dense path on every step); then ``qbm_main --seed_sweep 0..9`` (the
   10-seed flagship: the flat widths above, one epoch) for SA, BMS and PT:
   exactly one sampler launch a step at G=20 groups of 60 and one
   validation launch, every seed's parameters moved and its nll finite, 10
   best-model pickles that load back into ``DiscQBM``, the sweep's step
   time and its epoch a seed beside a single model's epoch; then
   ``cdqbm_main --seed_sweep 0..9`` (the 10-seed CDQBM sweep, one epoch):
   at CDQBM (a)'s full widths (n=717, sc100, bs20) for SA and BMS on K4's
   sparse shared path and PT on K5's sparse path, the anneal cut for the epoch (20 sweeps,
   PT 10), and at CDQBM (b) (n=41, bs3, anneal 1000) for SA on K1 and BMS
   on K2: exactly one sampler launch a step at G=20 groups and 4
   validation launches at G=10 groups of 32, every seed moved, finite nll,
   10 best-model pickles that load back into ``CDQBM``, the sweep's step
   (CUDA events) and its share a seed beside a single model's step at the
   same anneal; against the plain version under host variates, on each
   sweep's own step QUBOs at its G=20 call (the 1% bound of phase 3): K4's
   sparse path (Metropolis and pair) at CDQBM (a) (S cut to 5), K5's sparse path at
   the PT sweep's (S cut to 10; its variates drawn on the card), K1 and K2
   pair at CDQBM (b) (B=3, S cut to 100); both K5 paths forced on the PT
   sweep's step QUBOs at G=20 (S=10), bit for bit; the CDQBM (a) sweep
   with SA at anneal 1000 for 3 steps and a validation chunk; and resume:
   the flagship DQBM with SA (K1), BMS (K2 pair) and PT (K3), CDQBM (b)
   (K1) and CDQBM (a) at anneal 10 with SA (K4's sparse path), BMS (its
   pair) and PT
   (K5's sparse path) trained 2 epochs straight against 1
   epoch with ``--checkpoint_every 1`` and ``--resume`` for the second,
   whose parameters, history and generator state must be equal bit for
   bit, the resumed epoch launching its kernel;
6. kernel and plain times (CUDA events; kernels median of 5 after a
   warm-up, the plain versions one run after a warm-up) at the phase-3
   shapes in generator mode (K3 at S=1000 and at the flat CLI defaults' PT
   call, 146 problems, n=3, M=8, R=100;
   K4 and both K5 paths at S=10, and K4 and both K5 paths alone at S=1000;
   K4's dense path also at S=10 on ``qbm_main -hn 300 -r False``'s step
   QUBOs (the ``anneal_wide`` record's shape); K4's sparse path, Metropolis and pair, on the CDQBM (a) step's QUBOs at
   S=10 and, in turns with the dense path forced, at S=1000, there and on
   ``qbm_main -hn 300 -r True``'s), and each kernel's bound
   (``qbmx_torch/utils/roofline.py``: K1's and K2's from the flips their
   inputs make, K4's and K5's from the nonzeros of the changed rows, each
   counted by one more launch, K2's at the flagship and the CDQBM (b)
   call; K3's from its decisions alone; and K4, K5's sparse path, K1 and
   K2 at the 10-seed sweeps' calls on their own step QUBOs); and first
   (``chain_layout_times``) K1 and K2 pair at the calls whose layout the
   rule moved (the search's SA and BMS h8 calls, the warm start's, the
   CDQBM (b) sweep's; S=1000, random QUBOs): the rule's layout against
   the earlier rule's (``parent_lanes``) forced, in turns, beside the
   bound; and (``pt_layout_times``) K3 at the users' calls past n = 8
   (``PT_TIMING_CALLS``: the flat PT h8 call and its 10-seed sweep's,
   ``qm.main``'s PT call, the CDQBM (b) PT call and its sweep's; S=1000,
   the h8 sweep's turns at 100): every layout that takes the call forced,
   in turns, the rule's against the fastest and a rung a warp, beside the
   plain version (S=100) and the bound;
7. the RBM family (``rbm_phase``; no kernel of its own, its products are
   cuBLAS matmuls): ``qbmx_torch.cli.rbm_main.main`` on ``cuda`` at its
   defaults (discriminative, H=9, bs7, lr 0.0871) on synthetic data, cut
   to 2 epochs, for 3 of its seeds in turn and ``--seed_parallel`` over
   all 10, each seed's best accuracy and AUC printed and every pickle
   loaded back; the card against the CPU from the same parameters (2 f32
   discriminative epochs unshuffled, a ``ClassificationRBM`` and a
   3-seed ``SeedParallelRBM``: parameters within 1e-4); CD-1 (bf16), PCD
   and hybrid steps at the headline shape (batch 4096, 784 × 128):
   parameters f32 and finite, the PCD chain binary; resume bit for bit
   (``rbm_main --resume`` for the f32 discriminative RBM, ``train_rbm``
   from ``load_checkpoint`` for the bf16 CD-1 RBM); the warm start: the
   card's RBM mapped onto a ``DiscQBM`` (``models/warmstart.py``) whose
   p(y=1|x) under the exact sampler is the RBM's within 0.06, then one
   epoch with the SA sampler, K1 launched once a step and nothing else,
   and K1 at that step's own call (G=2, B=60, n=10, R=100, S=1000)
   against its plain version under variates drawn on the card (the 1%
   bound of phase 3), timed beside its plain version and its bound;
   and the CD-1 bf16 epoch (16 steps of 4096 binarized synthetic images)
   at H=128 and H=9 by CUDA events, in ms and images/s, beside its bound
   (``roofline.rbm_cd1_bound``);
8. the host seams (``host_seams_phase``; no kernel of their own, and no
   TPU kernel behind them): (a) the native annealer built from
   ``native/sa_sampler.cpp`` into ``build/native/`` (seconds); (b)
   ``qbm_main --solver SA-NATIVE`` on ``cuda`` at the flagship widths (H=5,
   sc1000, bs60; anneal cut to 100 for its epoch of 10 steps and 2
   predictions): no kernel launched, the parameters on the card, finite nll,
   moved parameters; the flagship step at anneal 1000 by CUDA events and by
   the host clock beside phase 5's K1 step, with ``os.cpu_count()``; that
   step's samples equal ``sa_sample_batch_native_seeds`` on host copies of
   its QUBOs and seeds bit for bit, and each problem's marginals lie within
   0.35 of the exact ones at its cold beta (``tests/test_native.py``'s
   bound); (c) the QPU seam: a ``DiscQBM`` (H=5, bs60, sc100) on ``cuda``
   through ``StructuredQPUSampler`` with 10 copies and an embedding cache
   in a temporary directory, over ``CardAnnealer`` (a structured stub
   defined here: Chimera C16, the embedded physical QUBO annealed by the
   port's SA on the card, K1 at its 240 qubits), 3 steps: one embedding
   search in all, none for a second model on the same cache, one K1
   launch a stub call, ``chain_break_fraction`` printed; on the first
   step's QUBOs, the most frequent of 200 reads is the exact ground state
   wherever the lowest two energies stand 0.25 apart (at least 40 problems);
9. the mesh (``mesh_phase``; ``qbmx_torch/parallel/mesh.py`` over
   ``torch.distributed``, no kernel of its own): a world of one under NCCL
   in this process: the flagship DQBM through ``shard_model`` and
   ``train_model`` (2 steps and a validation call: K1 launched 3 times and
   nothing else, the counts zeroed just before and read just after); the
   sharded flagship step (SA on K1, BMS on K2) and the sharded CDQBM (a)
   step at anneal 10 (SA on K4's sparse path, PT on K5's) each launching its
   kernel once and equal bit for bit to the single model's step fed the
   same stream (``fold_in(generator, 0, 0)``), each timed beside it; the
   10-seed flagship sweep with ``mesh=`` at dp=1 equal to the unsharded
   sweep bit for bit (2 steps at G=20 and a validation call: 3 K1
   launches); then two ranks spawned on ``cuda:0`` over gloo
   (``parallel/dryrun.flagship_pair``): the flagship step over dp=2 within
   ``dryrun.PAIR_ATOL`` (nll ``PAIR_NLL_ATOL``) of the unsharded step, and
   the rank's step without the all-reduce (the control) farther than that,
   K1 launched once on each rank, both timed; the 10-seed sweep over dp=2
   (G=10 a rank) launching K1 once a step and once for validation on each
   rank, rank 0 alone writing the 10 best-model pickles; the two ranks' K1
   launches of the same local groups from the sweep's stream differ (their
   launch seeds are folded with the rank's rows) and leave the sweep's
   generator in one state;
10. past the shared layouts (``wide_phase``): K4's global-field layout
   (each chain's fields and state in global scratch, J_g walked in windows
   of 128 rows: the window's fields read once into shared memory beside its
   diagonal block, then one pass of its changes onto the other fields --
   the dense pass streaming the window's rows, or, where
   ``wide_cuda.sparse_pass`` finds J_g sparse, the sparse pass over the
   changed rows' nonzeros) forced at n=717 with each pass, on dense and
   sparse QUBOs, equal to the shared layout bit for bit (samples, fields,
   counters; every rule, S=70), and through the SA and BMS wrappers at n =
   3369, 4096 and 8192 (Metropolis, pair, quad; 256 chains, S=2; dense
   QUBOs on the dense pass, sparse ones on the sparse pass) against plain
   within the 1% bound, launching ``anneal_wide_global`` or
   ``anneal_wide_global_sparse`` once and nothing else; K5's global path
   (S + 1 launches a call: each launch takes the last round's exchanges,
   then a sweep) forced at n=300, M=8 with each pass equal to the dense
   path bit for bit (samples, states, fields, energies, counters, S=70),
   and through the sampler's entry at ``qbm_main -hn 3400``'s PT call
   (n=3401, M=8, dense and sparse), past a cluster (n=3000, M=24; n=300,
   M=300), past the 10-bit Philox block (n=4100) and at n=4096 and 8192,
   256 target-rung chains each, against plain within the 1% bound
   (``pt_wide_global`` or ``pt_wide_global_sparse``); then ``qbm_main.main``
   on ``cuda`` at H=3400 (n=3401, sc100, bs20, anneal 5, one epoch of 30
   steps plus validation and test prediction) both ways: restricted
   (``qm.main``'s default ``restricted=True``: J_g all zeros but the
   output's row and column, on the sparse pass) and ``restricted=False``
   (the CLI's ``-r False`` default: a dense ``w_hh``, on the dense pass),
   with SA and BMS on K4's global-field layout and PT (8 rungs) on K5's
   global path: exactly one launch a sampler call and nothing else,
   finite nll, metrics in range; each step's time by CUDA events (median
   of 3, one launch a step); and at each call's own step QUBOs (G=2, B=20,
   R=100, S=5) the kernels' times (median of 3) and plain versions' (one
   run after a warm-up) and their bounds (the modelled bytes of the global
   fields printed apart, ``global_field_bytes_model``); K4 Metropolis, K4
   pair and K5 (M=8) at that call on each solver's own step QUBOs under
   variates drawn on the card, each launched once through its wrapper and
   held against its plain version within the 1% bound; then the layouts
   in turns (``layout_turns``): K4's two layouts and K5's dense and global
   paths, each forced on one call, timed a, b, b, a across n and on both
   sides of the rules' switches (K4: n = 1056, where a block holds 31
   chains; K5: n = 1416, 20 rungs); and K4's shared layout on sparse
   couplings (``sparse_shared_phase``): on the step QUBOs of CDQBM (a) (G=2
   B=20 n=717) and of ``qbm_main -hn 300 -r True`` (G=2 B=73 n=301), R=100,
   S=65 (past the refresh at sweep 64), host variates, both shared paths
   forced, every rule: samples, final fields and counters equal bit for bit;
   through the SA and BMS entries (R=100, S=10), the rule's sparse path
   launched once and within the 1% bound of plain; then 3 training steps (SA and BMS, anneal 1000) of each
   model on the rule's sparse path and on the dense path forced, launching
   only that path's kernel, ending in the same parameters and nll bit for
   bit;
11. the user scripts (``scripts_phase``; no kernel of its own for the
   exact studies, whose enumeration is PyTorch ops), in a temporary working
   directory: ``cli/cdqbm_exact_study.main`` on ``cuda`` at full size (14
   variants × 400 Adam steps through the enumeration, 80/80 bars images),
   each row within ``BARS_BAND`` of ``qbmx``'s recorded
   ``out/parity/cdqbm_exact_study.md`` (QUBO variables equal, NLL within
   0.02, accuracies within 3 images, bias sensitivity within 2%), and each
   variant's p(y=1|x) after 20 steps on the card within 1e-4 of the CPU's
   from the same inputs; ``cdqbm_breast_exact_study`` and
   ``cdqbm_multikernel_study`` at full size on seeded MedMNIST files of the
   real shapes (breastmnist 546/78/156, pneumoniamnist 4708/524/624, made
   here under ``$QBMX_DATA_DIR``): every row's QUBO-variable count the
   recorded tables', NLL finite, times printed; ``bms_hyper_search
   --configs`` at the script's widths (sc 1000, anneal 1000, bs 20, 10
   seeds, one epoch) for SA h5, BMS h8 and PT h5 (128 sweeps): exactly one
   launch of K1, K2 or K3 a step and one for validation, nothing else, a
   JSONL record with ``qbmx``'s keys, the time a seed-step; K1, K2 pair
   and K3 at the search's own step calls (G=20 groups of B=20, R=1000, n =
   6, 9 and 6 with M=8; each solver's step QUBOs), each launched once
   through its wrapper against its plain version under host variates
   (the 1% bound of phase 3; depth cut to 100 sweeps, K3's to 16), timed at
   the full depth beside its bound and the plain version's time; and
   ``bms_winner_curves --e 1 --seeds 10 --predict_reads 100``: the JSON
   written, both fronts printed, K2 once a step and once for validation;
   and K1 at the search's SA h8 call (n = 9), held and timed as the three
   above; K1 and K2 pair at the h8 calls on the route the rule names
   (``H8_ROUTE``);
12. the seed bands (``band_phase``; North-star check 3 for every route by
   which a kernel trains): each setting of ``qbmx_torch/cli/bands.py``
   (the flat model at H = 2 with SA, BMS and PT; at H = 8, n = 9, with SA,
   BMS and PT; the CDQBM (b), n = 41, with SA, BMS and PT; at H = 300,
   n = 301, with SA, BMS and PT) trains the port's 10-seed sweep through its CLI on
   ``cuda`` and its control at a tenth of the learning rate; each run launches its kernel once a sampler call
   and nothing else (K1, K2 pair, K3 a rung a thread and on lanes, K4,
   K5's dense path), one call a
   step plus the validation calls, every call on the route the layout
   rules name (``BAND_ROUTES``); the sweep must lie within ``qbmx``'s
   committed band (``out/bands/<setting>/qbmx/``) by
   ``seed_bands.compare`` at the Bonferroni width z_k of all k comparisons
   of the phase (``bands.z_all``), at every epoch for accuracy and AUC,
   and the control must fail that rule.

The last three lines are the ``nvidia-smi`` line, one JSON object with the
kernel records (time, plain time, bound, launches on the main path), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAX_DIFF_FRAC = 0.01  # phases 3-4: chains allowed to end in another state
ORACLE_ATOL = 0.12  # phase 4: |SA marginal − exact marginal| at the cold beta
# phase 4, heat-bath and PT at beta 1 (tests/test_gibbs_pt_pallas_debug.py's
# bars): marginals, joint-update marginals, joint-update pair moments
HB_ATOL, JOINT_ATOL, MOMENT_ATOL = 0.08, 0.05, 0.07
WIDTHS = {"single": dict(), "pair": dict(pair=True), "quad": dict(quad=True)}
WIDTH_OF = {"single": 1, "pair": 2, "quad": 4}  # K2's update width (gibbs_cuda.launch)
GAP = 0.25  # phase 8: the energy gap past which the QPU seam's mode is the ground state


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs (after one warm-up),
    each timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def uniforms(rng, shape, dev):
    u = rng.random(shape, dtype=np.float32)
    np.clip(u, 1e-6, 1.0 - 1e-6, out=u)
    return torch.as_tensor(u, device=dev)


def bits(rng, shape, dev):
    return torch.as_tensor((rng.random(shape, dtype=np.float32) < 0.5).astype(np.float32),
                           device=dev)


def structured_problem(rng, G, B, n, R, S, dev):
    from qbmx_torch.core.qubo import random_qubo_batch

    Qg = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    return Qg, h_extra, bits(rng, (G, B, R, n), dev), uniforms(rng, (S, G, B, n, R), dev)


def dense_problem(rng, B, n, R, S, dev):
    from qbmx_torch.core.qubo import random_qubo_batch

    Q = random_qubo_batch(rng, B, n).to(dev)
    return Q, bits(rng, (B, R, n), dev), uniforms(rng, (S, B, n, R), dev)


def structured_form(Q, h_extra, S, rule=0):
    """(J, h, hot, logr) as the SA (rule 0) or BMS wrappers hand them to a kernel."""
    from qbmx_torch.core.qubo import split_qubo
    from qbmx_torch.samplers import gibbs, sa_torch

    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra).contiguous()
    hot, logr = (sa_torch.schedule_params(h, J[:, None], S) if rule == 0
                 else gibbs.heat_bath_schedule(h, J[:, None], S, 1.0))
    return J.contiguous(), h, hot, logr


def gen_of(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def pt_hv(rng, GBM, R, n, S, dev):
    """Host variates of a tempering call: init01, uniforms, swap_u."""
    return (bits(rng, (GBM, R, n), dev), uniforms(rng, (S, GBM, n, R), dev),
            uniforms(rng, (S, GBM, R), dev))


def card_pt_hv(seed, GBM, R, n, S, dev):
    """``pt_hv``'s variates drawn on the card by a seeded CUDA generator:
    the 10-seed CDQBM (a) PT call's uniforms are 9 GB at S=10."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda shape: torch.rand(shape, generator=g, device=dev).clamp_(1e-6, 1.0 - 1e-6)
    return ((torch.rand((GBM, R, n), generator=g, device=dev) < 0.5).to(torch.float32),
            u((S, GBM, n, R)), u((S, GBM, R)))


def differing(kernel_out, plain_out) -> float:
    """Fraction of chains that end in another state."""
    n = kernel_out.shape[-1]
    return (kernel_out != plain_out).reshape(-1, n).any(dim=1).double().mean().item()


def compare(kernel_out, plain_out, label, phase=3):
    frac = differing(kernel_out, plain_out)
    chains = kernel_out.numel() // kernel_out.shape[-1]
    err = (kernel_out - plain_out).abs().max().item()
    binary = bool(((kernel_out == 0) | (kernel_out == 1)).all())
    print(f"phase {phase} {label}: chains {chains}, differing {round(frac * chains)} "
          f"({frac:.6f}; limit {MAX_DIFF_FRAC}), max_abs_err {err}, binary {binary}")
    check(binary, f"{label}: kernel output is not in {{0, 1}}")
    check(frac <= MAX_DIFF_FRAC, f"{label}: {frac:.4%} of chains differ from the plain version")
    return frac, err


def oracle_error(s, Q, *, joint: bool) -> tuple[float, float]:
    """(marginal error, pair-moment error) of samples ``s`` (R, n) against
    the exact Boltzmann distribution of ``Q`` at beta 1."""
    from qbmx_torch.samplers.exact import exact_boltzmann

    _, _, marg, pair_m = exact_boltzmann(Q, beta=1.0)
    err = (s.mean(0) - marg).abs().max().item()
    moment = ((s.T @ s) / s.shape[0] - pair_m).abs().max().item() if joint else 0.0
    return err, moment


def rbm_phase(dev, smi: str, counters) -> dict:
    """Phase 7 (module docstring): the RBM family on the card; returns its
    record."""
    import qbmx_torch.cli.rbm_main as rm
    from qbmx_torch.cli._common import load_dataset
    from qbmx_torch.data import loaders
    from qbmx_torch.models import rbm
    from qbmx_torch.models.warmstart import warm_start_dqbm
    from qbmx_torch.samplers.api import get_sampler
    from qbmx_torch.train.sweep import SeedParallelRBM
    from qbmx_torch.utils.checkpoint import load_checkpoint
    from qbmx_torch.samplers import sa_cuda, sa_torch
    from qbmx_torch.utils.roofline import anneal_bound, rbm_cd1_bound

    rec = {}
    t_phase = time.perf_counter()
    made = []

    class RecordedRBM(rm.ClassificationRBM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.initial_params = rbm.params_to_numpy(self.params)
            made.append(self)

    rm.ClassificationRBM = RecordedRBM
    (train_X, train_y), (val_X, _), (test_X, test_y) = load_dataset("synthetic", seed=0)
    train_X, val_X, test_X = loaders.preprocess_images(train_X, val_X, test_X)
    flags = rm.build_parser().parse_args([])
    lr, hidden, bs = flags.lr, flags.hidden_units, flags.batch_size  # rbm_main's defaults

    def finite(params) -> bool:
        return all(bool(torch.isfinite(getattr(params, f)).all()) and
                   getattr(params, f).dtype == torch.float32 for f in rbm.FIELDS)

    # rbm_main in-process at its defaults, 2 epochs: 3 seeds in turn, then
    # --seed_parallel over all 10; each seed's best accuracy and AUC
    parse = rm.build_parser().parse_args
    seeds3 = [str(s) for s in rm.DEFAULT_SEEDS[:3]]
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, seeds in (("sequential", ["--seeds", *seeds3], rm.DEFAULT_SEEDS[:3]),
                                    ("seed_parallel", ["--seed_parallel"], rm.DEFAULT_SEEDS)):
            out = Path(tmp, label)
            t0 = time.perf_counter()
            rm.main(parse(["--data_set", "synthetic", "--epochs", "2", "--device", "cuda",
                           "--out", str(out), *extra]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            best = {}
            for s in seeds:
                accs = pickle.loads((out / f"acc_per_epoch{s}.pkl").read_bytes())
                aucs = pickle.loads((out / f"auc_per_epoch{s}.pkl").read_bytes())
                check(len(accs) == len(aucs) == 2, f"rbm_main {label} seed {s}: {accs} {aucs}")
                e = int(np.argmax(0.5 * np.asarray(accs) + 0.5 * np.asarray(aucs)))
                best[s] = (accs[e], aucs[e])
            if label == "sequential":
                for m in made[-3:]:
                    check(m.device.type == "cuda" and finite(m.params), "rbm_main: params")
                    check(max(float(np.abs(v - m.initial_params[k]).max())
                              for k, v in rbm.params_to_numpy(m.params).items()) > 0.0,
                          "rbm_main: training did not move the parameters")
            else:
                pkls = sorted((out / "best_model").glob("*.pkl"))
                check(len(pkls) == 10, f"rbm_main --seed_parallel: {len(pkls)} best-model pickles")
                for path in pkls:
                    m = rbm.ClassificationRBM(train_X.shape[1], hidden, device=dev)
                    m.load_params(path)
                    acc, _ = m.run_test_set(test_X, test_y)
                    check(finite(m.params) and 0.0 <= acc <= 1.0, f"{path.name} does not load")
            rec[f"rbm_main {label}"] = {"seeds": len(seeds), "epochs": 2, "wall_s": wall,
                                        "best_acc_auc": {str(s): v for s, v in best.items()}}
            print(f"phase 7 rbm_main {label} cuda synthetic H=9 bs7 lr 0.0871 e2, {len(seeds)} "
                  f"seeds: best (acc, auc) "
                  + ", ".join(f"{s}: ({a:.4f}, {u:.4f})" for s, (a, u) in best.items())
                  + f"; pickles load; wall {wall:.2f} s")

    # the card against the CPU from the same parameters: 2 f32
    # discriminative epochs unshuffled
    diffs = {}
    runs = {}
    for d in ("cpu", "cuda"):
        m = rbm.ClassificationRBM(train_X.shape[1], hidden, learning_rate=lr, seed=5, device=d)
        m.params = rbm.params_from_numpy(made[0].initial_params, d)
        m.train_rbm(train_X, train_y, 2, bs, test_x=test_X, test_y=test_y, shuffle=False)
        sw = SeedParallelRBM(rm.DEFAULT_SEEDS[:3], train_X.shape[1], hidden, learning_rate=lr,
                             device=d)
        sw.sweep(train_X, train_y, test_X, test_y, epochs=2, batch_size=bs, shuffle=False)
        runs[d] = (m, sw)
    for i, label in enumerate(("ClassificationRBM", "SeedParallelRBM 3 seeds")):
        a, b = (rbm.params_to_numpy(runs[d][i].params) for d in ("cpu", "cuda"))
        diffs[label] = max(float(np.abs(a[k] - b[k]).max()) for k in rbm.FIELDS)
        check(diffs[label] <= 1e-4, f"{label}: card and CPU parameters differ by {diffs[label]}")
    rec["card_vs_cpu_max_abs_diff"] = diffs
    print(f"phase 7 card against CPU, 2 f32 discriminative epochs unshuffled (H=9 bs7, 172 steps "
          f"a model): largest parameter difference {diffs} (limit 1e-4)")

    # CD-1 (bf16), PCD and hybrid at the headline shape, a few steps each
    x, y = loaders.synthetic_images(4096, shape=(28, 28), num_classes=2, seed=0)
    x = torch.as_tensor(loaders.binarize(x.reshape(len(x), -1)), device=dev)
    y = torch.as_tensor(y, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for method, kw in (("generative", dict(compute_dtype=torch.bfloat16)), ("pcd", {}),
                       ("hybrid", dict(generative_factor=0.01))):
        step = rbm.make_train_step(2, method=method, **kw)
        params = rbm.init_params(torch.Generator().manual_seed(0), 784, 128, 2, dev)
        chain, losses = None, []
        for _ in range(3):
            out = step(params, x, y, 0.05, *((chain,) if method == "pcd" else ()), generator=gen)
            params, loss = out[:2]
            chain = out[2] if method == "pcd" else None
            losses.append(float(loss))
        check(finite(params) and all(map(math.isfinite, losses)), f"RBM {method}: {losses}")
        if method == "pcd":
            check(all(set(t.unique().tolist()) <= {0.0, 1.0} for t in chain),
                  "RBM pcd: the chain is not binary")
        print(f"phase 7 RBM {method} {kw or ''} 3 steps at batch 4096 784x128 on cuda: params f32 "
              f"and finite, losses {losses}" + ("; chain binary" if method == "pcd" else ""))

    # resume bit for bit: rbm_main --resume (f32 discriminative), and a bf16
    # CD-1 ClassificationRBM through load_checkpoint
    def same(a, b) -> list:
        pa, pb = rbm.params_to_numpy(a.params), rbm.params_to_numpy(b.params)
        bad = [k for k in rbm.FIELDS if not np.array_equal(pa[k], pb[k])]
        if not torch.equal(a.generator.get_state(), b.generator.get_state()):
            bad.append("generator state")
        return bad + [n for n in ("acc_per_epoch_list", "auc_per_epoch_list",
                                  "nll_per_epoch_list") if getattr(a, n) != getattr(b, n)]

    with tempfile.TemporaryDirectory() as tmp:
        base = ["--data_set", "synthetic", "--device", "cuda", "--seeds", seeds3[0],
                "--checkpoint_every", "1"]
        rm.main(parse(base + ["--epochs", "2", "--out", f"{tmp}/a"]))
        whole = made[-1]
        rm.main(parse(base + ["--epochs", "1", "--out", f"{tmp}/b"]))
        rm.main(parse(base + ["--epochs", "2", "--out", f"{tmp}/c",
                              "--resume", f"{tmp}/b/state_se{seeds3[0]}.npz"]))
        differ = same(whole, made[-1])
        check(not differ, f"resume rbm_main f32: the resumed run differs in {differ}")
        bf = dict(method="generative", compute_dtype=torch.bfloat16, learning_rate=0.05,
                  seed=4, device=dev)
        xb = loaders.binarize(train_X)
        whole = rbm.ClassificationRBM(784, 128, **bf)
        whole.train_rbm(xb, train_y, 2, 64, test_x=test_X, test_y=test_y)
        first = rbm.ClassificationRBM(784, 128, **bf)
        first.train_rbm(xb, train_y, 1, 64, test_x=test_X, test_y=test_y, checkpoint_every=1,
                        checkpoint_path=f"{tmp}/bf16")
        resumed = rbm.ClassificationRBM(784, 128, **bf)
        hist, ep = load_checkpoint(f"{tmp}/bf16", resumed)
        resumed.acc_per_epoch_list = list(hist.acc_per_epoch)
        resumed.auc_per_epoch_list = list(hist.auc_per_epoch)
        resumed.nll_per_epoch_list = list(hist.nll_per_epoch)
        resumed.train_rbm(xb, train_y, 2, 64, test_x=test_X, test_y=test_y, start_epoch=ep)
        differ = same(whole, resumed)
        check(not differ, f"resume bf16 CD-1: the resumed run differs in {differ}")
    rec["resume"] = {"rbm_main f32 discriminative": "bit for bit", "bf16 CD-1": "bit for bit"}
    print("phase 7 resume on cuda, 2 epochs straight against 1 epoch + resume: rbm_main f32 "
          "discriminative (H=9 bs7) and a bf16 CD-1 ClassificationRBM (H=128 bs64): parameters, "
          "generator state and acc/auc/nll lists equal bit for bit")

    # the warm start: the card's RBM onto a DiscQBM (n = 10), exact sampler,
    # then one SA epoch on K1
    trained = runs["cuda"][0]
    xt = test_X[:32]
    want = rbm.predict_proba(trained.params, torch.as_tensor(xt, device=dev))[:, 1].cpu().numpy()
    exact = warm_start_dqbm(trained, seed=0, sample_count=4096, sampler=get_sampler("EXACT"))
    _, probs = exact.predict_batch(xt)
    p_err = float(np.abs(probs[:, 1] - want).max())
    check(p_err <= 0.06, f"warm start: p(y=1|x) of the DQBM differs from the RBM's by {p_err}")
    qbm = warm_start_dqbm(trained, seed=0, sample_count=100, sampler=get_sampler("SA"))
    before = {k: v.clone() for k, v in vars(qbm.params).items()}
    for c in counters:
        c.reset_launch_counts()
    nlls, _ = qbm.train_epoch(train_X, train_y, 60, 0.05)
    torch.cuda.synchronize()
    counts = {k: v for c in counters for k, v in c.launch_counts.items()}
    steps = math.ceil(len(train_X) / 60)
    check(counts["sa_metropolis"] == steps and sum(counts.values()) == steps,
          f"warm-started DQBM, one SA epoch of {steps} steps: launch counts {counts}")
    check(all(map(math.isfinite, nlls)) and any(
        not torch.equal(v, getattr(qbm.params, k)) for k, v in before.items()),
        f"warm-started DQBM: nll {nlls}, or the parameters did not move")
    # K1 at that step's own call (G=2, B=60, n=10, R=100, S=1000): against
    # its plain version under variates drawn on the card (phase 3's 1%
    # bound), timed, and bounded from the flips it makes
    n = qbm.n_hidden_nodes + qbm.n_output_nodes
    x60 = torch.as_tensor(train_X[:60], device=dev)
    y60 = torch.as_tensor(np.asarray(train_y[:60], np.float32), device=dev)[:, None]
    Q2, h2 = qbm.step_qubos(qbm.params, x60, y60)
    g = torch.Generator(device=dev).manual_seed(7)
    hv = ((torch.rand((2, 60, 100, n), generator=g, device=dev) < 0.5).to(torch.float32),
          torch.rand((1000, 2, 60, n, 100), generator=g, device=dev).clamp_(1e-6, 1 - 1e-6))
    frac, err = compare(sa_cuda.sa_sample_groups_cuda(Q2, h2, 100, 1000, host_variates=hv),
                        sa_torch.sa_sample_groups_plain(Q2, h2, 100, 1000, host_variates=hv),
                        "K1 at the warm-started DQBM's step, its own QUBOs, G=2 B=60 n=10 "
                        "R=100 S=1000", phase=7)
    del hv
    g1 = torch.Generator().manual_seed(1)
    k1_ms = cuda_ms(lambda: sa_cuda.sa_sample_groups_cuda(Q2, h2, 100, 1000, generator=g1),
                    runs=5)
    plain_ms = cuda_ms(lambda: sa_torch.sa_sample_groups_plain(Q2, h2, 100, 1000), runs=1)
    flips = torch.zeros(1, dtype=torch.int64, device=dev)
    sa_cuda.launch(*structured_form(Q2, h2, 1000), 100, 1000, generator=g1, flips=flips)
    bound = anneal_bound(2, 60, 100, n, 1000, flips=int(flips.item()))
    rec["warm_start"] = {"p_y1_max_abs_err": p_err, "limit": 0.06, "examples": len(xt),
                         "reads": 4096, "n": n, "steps": steps,
                         "sa_metropolis_launches": counts["sa_metropolis"],
                         "k1_differing_chains": frac, "k1_max_abs_err": err, "k1_ms": k1_ms,
                         "k1_plain_ms": plain_ms, "k1_bound_ms": bound["bound_ms"],
                         "k1_bound_by": bound["bound_by"]}
    print(f"phase 7 warm start: RBM (H=9, trained on cuda) -> DiscQBM n={n}: exact-sampler "
          f"p(y=1|x) within {p_err:.4f} of the RBM's on {len(xt)} test images (limit 0.06); one "
          f"SA epoch (bs60, sc100, anneal 1000): {steps} steps, launch counts {counts}, nll "
          f"{nlls[0]:.4f} -> {nlls[-1]:.4f}; K1 at the step's call {k1_ms:.3f} ms (CUDA events, "
          f"median of 5), plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({smi})")

    # the CD-1 bf16 epoch at the benchmark's shapes, by CUDA events
    images, batch = 65536, 4096
    x16 = x.to(torch.bfloat16).repeat(images // len(x), 1).reshape(images // batch, batch, -1)
    y16 = y.repeat(images // len(y)).reshape(images // batch, batch)
    epoch = rbm.make_epoch_scan(rbm.make_train_step(2, method="generative",
                                                    compute_dtype=torch.bfloat16))
    timing = {}
    for h in (128, 9):
        state = [rbm.init_params(torch.Generator().manual_seed(0), 784, h, 2, dev)]

        def run():
            state[0], _ = epoch(state[0], gen, x16, y16, 0.05)

        ms = cuda_ms(run, runs=5)
        check(finite(state[0]), f"CD-1 bf16 H={h}: parameters")
        bound = rbm_cd1_bound(images // batch, batch, 784, h)
        timing[f"H={h}"] = {"epoch_ms": ms, "images_per_s": images / (ms / 1e3),
                            "steps": images // batch, "bound_ms": bound["bound_ms"],
                            "bound_by": bound["bound_by"]}
        print(f"phase 7 time RBM CD-1 bf16 H={h} batch {batch}, {images} images "
              f"({images // batch} steps): {ms:.3f} ms an epoch, {images / (ms / 1e3):.1f} "
              f"images/s (CUDA events, median of 5 after a warm-up; {smi}); bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (H100 SXM peaks)")
    rec["cd1_bf16_epoch"] = timing
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


class CardAnnealer:
    """A structured dimod-style sampler for phase 8, defined here and not in
    the package: Chimera C16 (2048 qubits), whose ``sample_qubo`` refuses a
    qubit or coupler off the graph, then anneals the embedded physical QUBO
    with the port's ``SASampler`` on a CUDA tensor (K1 while the used qubits
    are at most 241, K4 above) and answers with a dimod-shaped sampleset
    (``record.sample``, ``variables``, ``info["timing"]``)."""

    def __init__(self, dev, sweeps: int, seed: int):
        from qbmx_torch.embedding import chimera_graph
        from qbmx_torch.samplers.api import SASampler

        self.adjacency = chimera_graph(16)
        self.properties = {"topology": {"type": "chimera", "shape": [16, 16, 4]}}
        self.sampler = SASampler(num_sweeps=sweeps)
        self.generator = torch.Generator().manual_seed(seed)
        self.dev = dev
        self.widths = []  # qubits used, a call each

    def sample_qubo(self, qdict, num_reads=1, **_):
        variables = sorted({q for ij in qdict for q in ij})
        col = {q: c for c, q in enumerate(variables)}
        Q = np.zeros((len(variables), len(variables)), np.float32)
        for (i, j), v in qdict.items():
            if i not in self.adjacency or (i != j and j not in self.adjacency[i]):
                raise ValueError(f"({i}, {j}) is not on the Chimera C16 graph")
            Q[col[min(i, j)], col[max(i, j)]] += v
        self.widths.append(len(variables))
        t0 = time.perf_counter()
        s = self.sampler.sample_batch(self.generator, torch.as_tensor(Q, device=self.dev)[None],
                                      num_reads)[0].cpu().numpy()
        us = (time.perf_counter() - t0) * 1e6
        return types.SimpleNamespace(record=types.SimpleNamespace(sample=s.astype(np.int8)),
                                     variables=variables, info={"timing": {"qpu_access_time": us}})


def host_seams_phase(dev, smi: str, counters, made, batch, k1_step_ms: float) -> dict:
    """Phase 8 (module docstring): the native annealer and the QPU seam with
    the model on the card; returns its record."""
    import os

    import qbmx_torch.cli.qbm_main as qm
    from qbmx_torch.core.qubo import default_beta_range, densify_groups, qubo_energies
    from qbmx_torch.core.rng import draw_seeds
    from qbmx_torch.models.dqbm import DiscQBM, params_to_numpy
    from qbmx_torch.samplers import api, native
    from qbmx_torch.samplers.exact import enumerate_states, exact_boltzmann
    from qbmx_torch.samplers.qpu import StructuredQPUSampler

    rec = {"cpu_count": os.cpu_count()}
    t_phase = time.perf_counter()
    x, y, mask = batch

    def launches() -> dict:
        return {k: v for c in counters for k, v in c.launch_counts.items() if v}

    # (a) the native build, from native/sa_sampler.cpp into build/native/
    so = native.library_path()
    compiled = not so.exists()
    t0 = time.perf_counter()
    native.load_library()
    rec["build_s"] = time.perf_counter() - t0
    check(so.parent == ROOT / "build" / "native", f"native library built into {so.parent}")
    print(f"phase 8 native build: {rec['build_s']:.2f} s ({'compiled' if compiled else 'cached'})"
          f" -> {so}")

    # (b) qbm_main --solver SA-NATIVE on cuda at the flagship widths: every
    # call recorded (its seeds, its QUBOs on the host, the samples the model got)
    calls = []

    class RecordedNative(native.NativeSASampler):
        def sample_batch(self, generator, Q, num_reads):
            state = generator.get_state()
            out = super().sample_batch(generator, Q, num_reads)
            seeds = draw_seeds(torch.Generator().set_state(state), Q.shape[0])
            calls.append((seeds, Q.cpu().numpy(), num_reads, self.num_sweeps, out))
            return out

    api.NativeSASampler = RecordedNative
    steps, anneal = 10, 100
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    acc, f1, precision, recall, auc = qm.main(
        device="cuda", data_set="synthetic", n_hidden_nodes=5, sample_count=1000, anneal=anneal,
        batch_size=60, learning_rate=0.307, epochs=1, restricted=False, save="",
        solver="SA-NATIVE")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    api.NativeSASampler = native.NativeSASampler
    model = made[-1]
    nlls = model.training_history.nll_per_batch
    on_card = {k: v.device.type for k, v in vars(model.params).items()}
    moved = max(float(np.abs(v - model.initial_params[k]).max())
                for k, v in params_to_numpy(model.params).items())
    check(isinstance(model.sampler, RecordedNative), "qbm_main did not build the native sampler")
    check(launches() == {}, f"SA-NATIVE launched kernels: {launches()}")
    check(set(on_card.values()) == {"cuda"}, f"SA-NATIVE: parameters left the card: {on_card}")
    check(len(calls) == steps + 2 and all(o.device.type == "cuda" for *_, o in calls),
          f"SA-NATIVE: {len(calls)} sampler calls, devices {[o.device for *_, o in calls]}")
    check(len(nlls) == steps and all(math.isfinite(v) for v in nlls), f"SA-NATIVE: nll {nlls}")
    check(moved > 0.0, "SA-NATIVE: training did not move the parameters")
    check(all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc)),
          "SA-NATIVE: metrics out of range")
    print(f"phase 8 SA-NATIVE: qbm_main cuda synthetic dim_input 784 H=5 sc1000 anneal{anneal} "
          f"bs60 e1: {steps} steps + 2 predictions, {len(calls)} host calls, kernel launches "
          f"{launches()}, parameters on {set(on_card.values())}, nll {nlls[0]:.4f} -> "
          f"{nlls[-1]:.4f}, max param change {moved:.4f}, test acc {acc:.4f} auc {auc:.4f}, "
          f"wall {wall:.2f} s")

    # the flagship step at anneal 1000, by CUDA events and by the host clock
    model.sampler = RecordedNative(num_sweeps=1000)
    calls.clear()
    for c in counters:
        c.reset_launch_counts()
    model._step(x, y, mask, 0.307)  # warm-up
    ev_ms, host_ms = [], []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        model._step(x, y, mask, 0.307)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(end))
    check(launches() == {}, f"SA-NATIVE step launched kernels: {launches()}")
    rec.update(step_ms=statistics.median(ev_ms), step_host_ms=statistics.median(host_ms),
               k1_step_ms=k1_step_ms)

    # one step's samples: bit for bit the host call on host copies of its
    # QUBOs and seeds; marginals within tests/test_native.py's 0.35 of the
    # exact ones at each problem's cold beta
    seeds, Qh, R, S, out = calls[-1]
    again = native.sa_sample_batch_native_seeds(seeds, Qh, R, S)
    rec["bit_for_bit"] = bool(np.array_equal(again, out.cpu().numpy()))
    check(rec["bit_for_bit"], "SA-NATIVE: the step's samples differ from the host call's")
    worst = 0.0
    for b in range(Qh.shape[0]):
        q = torch.as_tensor(Qh[b])
        _, cold = default_beta_range(q)
        _, _, marg, _ = exact_boltzmann(q, beta=float(cold))
        worst = max(worst, float((out[b].mean(0).cpu() - marg).abs().max()))
    rec["oracle_worst_marginal_err"] = worst
    check(worst < 0.35, f"SA-NATIVE: marginal {worst:.4f} from the exact one (limit 0.35)")
    print(f"phase 8 SA-NATIVE step (flagship: G=2 B=60 n=6 R=1000 S=1000, {Qh.shape[0]} problems "
          f"on the host's {rec['cpu_count']} CPUs): {rec['step_ms']:.3f} ms by CUDA events, "
          f"{rec['step_host_ms']:.3f} ms by the host clock (median of 2 after a warm-up), "
          f"against phase 5's K1 step {k1_step_ms:.3f} ms; samples equal the host call on "
          f"the step's QUBOs and seeds bit for bit: {rec['bit_for_bit']}; worst marginal error "
          f"at the cold beta {worst:.4f} (limit 0.35); kernel launches {launches()}; {smi}")

    # (c) the QPU seam: the flat DQBM (H=5) on cuda through StructuredQPUSampler
    # with --qpu_copies 10 and an embedding cache, over CardAnnealer
    stub_sweeps, reads, copies = 200, 100, 10
    with tempfile.TemporaryDirectory() as cache:
        def qpu_model(seed):
            stub = CardAnnealer(dev, stub_sweeps, seed)
            adapter = StructuredQPUSampler(stub, copies=copies, cache_dir=cache)
            return stub, DiscQBM(dim_input=784, n_hidden_nodes=5, sample_count=reads,
                                 restricted=False, seed=seed, sampler=adapter, device="cuda")

        stub, m = qpu_model(1)
        xb, yb = x.cpu().numpy(), y.cpu().numpy()
        Q2, h2 = m.step_qubos(m.params, x, y.to(torch.float32)[:, None])  # the first step's
        searches, nll, step_s = [], [], []
        for c in counters:
            c.reset_launch_counts()
        for _ in range(3):
            t0 = time.perf_counter()
            _, l = m.train_for_one_iteration(xb, yb, 0.307)
            nll.append(float(l))
            step_s.append(time.perf_counter() - t0)
            searches.append(m.sampler.embedding_searches)
        counts, n_calls = launches(), len(stub.widths)
        on_card = {v.device.type for v in vars(m.params).values()}
        check(searches == [1, 1, 1], f"QPU seam: embedding searches after each step {searches}")
        check(on_card == {"cuda"} and all(math.isfinite(v) for v in nll),
              f"QPU seam: parameters on {on_card}, nll {nll}")
        kernel = "sa_metropolis" if max(stub.widths) <= 241 else "anneal_wide"
        check(counts.get(kernel, 0) == n_calls == 3 * 2 * 60,
              f"QPU seam: {n_calls} stub calls, launch counts {counts}")
        files = sorted(p.name for p in Path(cache).iterdir())
        stub2, m2 = qpu_model(2)
        m2.train_for_one_iteration(xb, yb, 0.307)
        check(m2.sampler.embedding_searches == 0 and len(stub2.widths) == 120,
              f"QPU seam: a second model on the cache searched "
              f"{m2.sampler.embedding_searches} times")

    # the seam's logical samples against the exact oracle on the first
    # step's 120 QUBOs: where a problem's lowest two energies stand at least
    # 0.25 apart, its most frequent of 200 reads must be the exact ground
    # state.  Closer than that the embedded anneal may freeze in the second
    # state: flipping a logical variable flips a chain of 4 qubits one at a
    # time against the chain penalty (the plain SA on the CPU did so on 6 of
    # these 60 problems, all with gaps under 0.12).  The clamped group's
    # padding variable couples to nothing, so its ground states are
    # degenerate and drop out; at least 40 of the 60 unclamped problems
    # must be held (49 are, with the seed here)
    Qd = densify_groups(Q2, h2).reshape(-1, 6, 6)
    s = m.sampler.sample_batch(torch.Generator().manual_seed(3), Qd, 200)
    states = enumerate_states(6, dev)
    ground = []
    for b in range(Qd.shape[0]):
        E = qubo_energies(Qd[b], states)
        order = torch.argsort(E)
        if float(E[order[1]] - E[order[0]]) < GAP:
            continue
        uniq, cnt = torch.unique(s[b], dim=0, return_counts=True)
        check(torch.equal(uniq[cnt.argmax()], states[order[0]]),
              f"QPU seam: problem {b}'s most frequent read is not its ground state")
        ground.append(float((s[b] == states[order[0]]).all(1).float().mean()))
    held = len(ground)
    check(held >= 40, f"QPU seam: only {held} problems with a gap of {GAP} (limit 40)")
    rec["qpu"] = {"copies": copies, "reads": reads, "stub_sweeps": stub_sweeps,
                  "qubits_used": max(stub.widths), "kernel": kernel, "launches": counts,
                  "stub_calls": n_calls,
                  "embedding_searches": searches, "second_model_searches":
                      m2.sampler.embedding_searches, "cache_files": files,
                  "chain_break_fraction": m.sampler.chain_break_fraction,
                  "step_s": step_s, "oracle_problems": held,
                  "oracle_ground_state_share": [min(ground), statistics.mean(ground)],
                  "qpu_time_used_us": m.sampler.qpu_time_used}
    print(f"phase 8 QPU seam: DiscQBM cuda dim_input 784 H=5 bs60 sc{reads}, "
          f"StructuredQPUSampler copies {copies} over CardAnnealer (Chimera C16, SA "
          f"{stub_sweeps} sweeps on the card): {max(stub.widths)} qubits a call -> {kernel}, "
          f"launch counts {counts} for {n_calls} stub calls, embedding searches after "
          f"each step {searches}, a second model on the cache {m2.sampler.embedding_searches}, "
          f"cache {files}, chain_break_fraction {m.sampler.chain_break_fraction:.6f}, nll "
          f"{nll}, step {[round(v, 3) for v in step_s]} s (host clock); oracle: the most "
          f"frequent of 200 reads is the ground state for all {held} of {Qd.shape[0]} step "
          f"QUBOs whose lowest two energies stand >= {GAP} apart (limit 40), its share of the "
          f"reads {min(ground):.3f} at least, {statistics.mean(ground):.3f} on average")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8 host seams: {rec['phase_s']:.1f} s")
    return rec


def mesh_phase(dev, smi: str) -> dict:
    """Phase 9 (module docstring): the mesh on the card; returns its
    record."""
    import datetime

    import torch.distributed as dist

    from qbmx_torch.core.rng import fold_in
    from qbmx_torch.models.base import tree_leaves
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.parallel import dryrun
    from qbmx_torch.parallel.mesh import make_mesh, shard_model
    from qbmx_torch.samplers import launches
    from qbmx_torch.train.loop import train_model
    from qbmx_torch.train.sweep import SeedParallelDQBM

    rec = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    x = torch.as_tensor(rng.random((60, 784), dtype=np.float32), device=dev)
    y = torch.as_tensor(np.arange(60) % 2, device=dev)
    mask = torch.ones(60, device=dev)
    ximg = torch.as_tensor(rng.random((20, 28, 28), dtype=np.float32), device=dev)
    yimg, mimg = y[:20], mask[:20]
    flagship = lambda solver: DiscQBM(dim_input=784, n_hidden_nodes=5, sample_count=1000,
                                      anneal_steps=1000, solver=solver, device=dev)
    cdqbm_a = lambda solver: CDQBM(pooling_size=4, pooling_type="probabilistic",
                                   sequential_layer_sizes=[4], hidden_bias_type="shared",
                                   sample_count=100, anneal=10, beta_eff=5.0, solver=solver,
                                   device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh(dp=1, chains=1, device=dev)
            # the flagship DQBM through shard_model and train_model: 2 steps and
            # one validation call, K1 on each (counts zeroed just before)
            X = rng.random((120, 784), dtype=np.float32)
            Y = np.arange(120) % 2
            model = shard_model(flagship("SA"), mesh)
            launches.reset()
            h = train_model(model, X, Y, X[:60], Y[:60], batch_size=60, learning_rate=0.307,
                            epochs=1, verbose=False)
            torch.cuda.synchronize()
            counts = launches.counts()
            check(counts == {"sa_metropolis": 3}, f"phase 9 shard_model + train_model: launch "
                  f"counts {counts} for 2 steps + 1 validation call")
            check(all(math.isfinite(v) for v in h.nll_per_batch), f"phase 9 nll {h.nll_per_batch}")
            rec["train_model_launches"] = counts
            print(f"phase 9 world of one (NCCL): flagship DQBM shard_model + train_model, 2 "
                  f"steps + 1 validation call: launch counts {counts}, nll "
                  f"{h.nll_per_batch}")
            # each sharded step against the single step fed the same stream
            for label, make, inputs, kernel in (
                    ("flagship SA", lambda: flagship("SA"), (x, y, mask), "sa_metropolis"),
                    ("flagship BMS", lambda: flagship("BMS"), (x, y, mask), "sa_heatbath"),
                    ("CDQBM (a) SA anneal 10", lambda: cdqbm_a("SA"), (ximg, yimg, mimg),
                     "anneal_wide_sparse"),
                    ("CDQBM (a) PT anneal 10", lambda: cdqbm_a("PT"), (ximg, yimg, mimg),
                     "pt_wide_sparse")):
                base = make()
                sharded = shard_model(copy.deepcopy(base), mesh)
                single = copy.deepcopy(base)
                single.generator = fold_in(single.generator, 0, 0)
                launches.reset()
                n1, e1 = sharded._step(*inputs, 0.01)
                torch.cuda.synchronize()
                counts = launches.counts()
                n2, e2 = single._step(*inputs, 0.01)
                same = (torch.equal(n1, n2) and torch.equal(e1, e2) and all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(sharded.params),
                                                      tree_leaves(single.params))))
                check(counts == {kernel: 1}, f"phase 9 {label}: launch counts {counts}")
                check(same, f"phase 9 {label}: the sharded step is not the single step")
                ms_sh = cuda_ms(lambda: sharded._step(*inputs, 0.01), runs=5)
                ms_si = cuda_ms(lambda: single._step(*inputs, 0.01), runs=5)
                rec[label] = {"launches": counts, "bit_for_bit": same, "sharded_ms": ms_sh,
                              "single_ms": ms_si}
                print(f"phase 9 world of one (NCCL) {label}: sharded step = single step fed "
                      f"fold_in(generator, 0, 0) bit for bit: {same}; launch counts {counts}; "
                      f"step {ms_sh:.3f} ms sharded, {ms_si:.3f} ms single (CUDA events, "
                      f"median of 5; {smi})")
            # the 10-seed flagship sweep at dp=1 against the unsharded sweep
            out = []
            for m in (mesh, None):
                sw = SeedParallelDQBM(list(range(10)), dim_input=784, n_hidden_nodes=5,
                                      sample_count=1000, anneal_steps=1000, device=dev, mesh=m)
                launches.reset()
                hs = sw.train(X, Y, X[:60], Y[:60], epochs=1, batch_size=60,
                              learning_rate=0.307, verbose=False)
                torch.cuda.synchronize()
                out.append((launches.counts(), [h.nll_per_batch + h.acc_per_epoch for h in hs],
                            tree_leaves(sw.params)))
            same = out[0][1] == out[1][1] and all(
                torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))
            check(out[0][0] == {"sa_metropolis": 3}, f"phase 9 sweep dp=1: {out[0][0]}")
            check(same, "phase 9 sweep dp=1: not the unsharded sweep bit for bit")
            rec["sweep_dp1"] = {"launches": out[0][0], "bit_for_bit": same}
            print(f"phase 9 world of one (NCCL): SeedParallelDQBM(0..9, mesh=dp 1) = the "
                  f"unsharded sweep bit for bit: {same} (launch counts {out[0][0]}: 2 steps "
                  "at G=20 + 1 validation call)")
        finally:
            dist.destroy_process_group()
        # two ranks on this card over gloo, spawned
        t0 = time.perf_counter()
        ranks = dryrun.spawn(dryrun.flagship_pair, 2, "gloo", ("cuda:0", tmp), timeout=600.0)
        rec["gloo2_spawn_s"] = time.perf_counter() - t0
    for r in ranks:
        check(r["step_launches"] == {"sa_metropolis": 1},
              f"phase 9 gloo rank {r['rank']}: step launch counts {r['step_launches']}")
        check(r["max_diff"] <= dryrun.PAIR_ATOL and r["nll_diff"] <= dryrun.PAIR_NLL_ATOL,
              f"phase 9 gloo rank {r['rank']}: sharded step {r['max_diff']} (nll "
              f"{r['nll_diff']}) from the unsharded step")
        # the control: the rank's step without the all-reduce must fail the check
        check(r["control_diff"] > dryrun.PAIR_ATOL,
              f"phase 9 gloo rank {r['rank']}: the step without the all-reduce is only "
              f"{r['control_diff']} from the unsharded step: the check cannot fail")
        check(r["sweep_launches"] == {"sa_metropolis": 3},
              f"phase 9 gloo rank {r['rank']}: sweep launch counts {r['sweep_launches']}")
        check(r["sweep_nll_finite"], f"phase 9 gloo rank {r['rank']}: sweep nll not finite")
        check(len(r["files"]) == (10 if r["rank"] == 0 else 0),
              f"phase 9 gloo rank {r['rank']} wrote {r['files']}")
        med = lambda v: statistics.median(v)
        print(f"phase 9 two ranks on cuda:0 over gloo, rank {r['rank']}: flagship step (30 rows "
              f"a rank, K1 launches {r['step_launches']['sa_metropolis']}) {r['max_diff']!r} "
              f"from the unsharded step (nll {r['nll_diff']!r}; limits {dryrun.PAIR_ATOL}, "
              f"{dryrun.PAIR_NLL_ATOL}); control without the all-reduce {r['control_diff']!r} "
              f"(nll {r['control_nll_diff']!r}); step {med(r['sharded_ms']):.3f} ms "
              f"sharded, {med(r['single_ms']):.3f} ms unsharded (CUDA events, median of 5, both "
              f"ranks on the card at once; {smi}); 10-seed sweep dp=2: launch counts "
              f"{r['sweep_launches']} (2 steps at G=10 + 1 "
              f"validation call), {len(r['files'])} best-model pickles written")
    same_probe = np.array_equal(ranks[0]["probe"], ranks[1]["probe"])
    check(not same_probe, "phase 9 sweep dp=2: the two ranks' launches of the same local "
          "groups drew the same numbers")
    check(ranks[0]["generator_state"] == ranks[1]["generator_state"],
          "phase 9 sweep dp=2: the ranks left the sweep's generator in different states")
    print(f"phase 9 sweep dp=2: the ranks' K1 launches of the same 5 local groups (hot, beta "
          f"0.01) differ in {float((ranks[0]['probe'] != ranks[1]['probe']).mean()):.3f} of "
          "their bits; the sweep's generator is left in one state on both")
    rec["gloo2"] = [{k: v for k, v in r.items() if k not in ("probe", "generator_state")}
                    for r in ranks]
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9 mesh: {rec['phase_s']:.1f} s")
    return rec


def in_turns(a, b, reps: int) -> tuple[float, float]:
    """Medians in ms of ``a()`` and ``b()``, each run once as a warm-up, then
    ``reps`` rounds of a, b, b, a, each call timed by CUDA events."""
    a(), b()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(reps):
        for i in (0, 1, 1, 0):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            (a, b)[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


# K1 (width 0) and K2 pair (width 2): the kernels whose layouts past n = 8
# phases 3, 4 and 6 check and time
K1_K2 = (("K1", 0), ("K2 pair", 2))


def k1k2_launch(width: int, form, R: int, S: int, **kw):
    """K1 (``width`` 0) or K2 at ``width`` launched on a structured form."""
    from qbmx_torch.samplers import gibbs_cuda, sa_cuda

    if width == 0:
        return sa_cuda.launch(*form, R, S, **kw)
    return gibbs_cuda.launch(*form, R, S, width, **kw)


def k1k2_layouts(n: int, width: int) -> list:
    """The layouts (lanes a chain) of K1 (``width`` 0) or K2 that hold n."""
    from qbmx_torch.samplers import kernel_call

    return [L for L in (1, *kernel_call.LANES) if n <= kernel_call.max_n(L, width)]


def chain_layout_calls() -> dict:
    """Phase 3's calls of K1 and K2 past n = 8: label -> (G, B, R, n)."""
    from qbmx_torch.samplers import kernel_call

    top = kernel_call.THREAD_MAX_N
    return {"the search's h8 call": (20, 20, 1000, 9),
            f"THREAD_MAX_N = {top}": (2, 60, 1000, top),
            f"THREAD_MAX_N + 1 = {top + 1}": (2, 60, 1000, top + 1),
            "the (b) sweep call": (20, 3, 100, 41)}


def chain_layouts_check(dev, rng) -> tuple[dict, list]:
    """Phase 3: K1 and K2 pair at ``chain_layout_calls`` (S cut to 100),
    each layout that holds the call forced and the layout the rule picks
    (through the sampler's entry), against the plain version under the same
    host variates (the 1% bound); GROUP (4, 8, 16 lanes a chain) against
    LANES (a warp a chain) forced on the same draws: samples and
    ``fields_out`` equal bit for bit.  Returns the records and (kernel,
    (differing, max_abs_err)) pairs."""
    from qbmx_torch.samplers import gibbs, gibbs_cuda, kernel_call, sa_cuda, sa_torch
    from qbmx_torch.samplers import launches as launches_mod

    S, rec, pairs = 100, {}, []
    for label, (G, B, R, n) in chain_layout_calls().items():
        Q, he, init01, u = structured_problem(rng, G, B, n, R, S, dev)
        hv = (init01, u)
        for name, width in K1_K2:
            kernel = "sa_metropolis" if width == 0 else "sa_heatbath"
            plain = (sa_torch.sa_sample_groups_plain(Q, he, R, S, host_variates=hv) if width == 0
                     else gibbs.gibbs_sample_groups_plain(Q, he, R, S, pair=True,
                                                          host_variates=hv))
            form = structured_form(Q, he, S, width)
            shape = f"G={G} B={B} R={R} n={n} S={S}"
            outs, fracs = {}, {}
            for L in k1k2_layouts(n, width):
                fields = None if L == 1 else torch.empty((G, B, R, n), device=dev)
                out = k1k2_launch(width, form, R, S, host_variates=hv, lanes=L,
                                  fields_out=fields)
                lay = kernel_call.chain_layout(G, B, R, n, L, width)
                fracs[L], err = compare(out, plain, f"{name} at {label} {shape}, "
                                                    f"{lay.route} (forced)")
                pairs.append((kernel, (fracs[L], err)))
                outs[L] = (out, fields)
            picked = kernel_call.chain_layout(G, B, R, n, width=width)
            launches_mod.reset()
            got = (sa_cuda.sa_sample_groups_cuda(Q, he, R, S, host_variates=hv) if width == 0
                   else gibbs_cuda.gibbs_sample_groups_cuda(Q, he, R, S, pair=True,
                                                            host_variates=hv))
            torch.cuda.synchronize()
            check(launches_mod.counts() == {kernel: 1},
                  f"{name} at {label}: the sampler's entry launched {launches_mod.counts()}")
            pairs.append((kernel, compare(got, plain, f"{name} at {label} {shape}, "
                                                      f"{picked.route} (the rule's)")))
            check(torch.equal(got, outs[picked.lanes][0]),
                  f"{name} at {label}: the sampler's entry and {picked.route} forced differ")
            equal = []
            for L in outs:
                if 1 < L < 32:
                    same = (torch.equal(outs[L][0], outs[32][0])
                            and torch.equal(outs[L][1], outs[32][1]))
                    check(same, f"{name} at {label}: {L} lanes a chain and a warp a chain "
                                "differ (samples or fields) on the same draws")
                    equal.append(L)
            print(f"phase 3 {name} at {label} {shape}: GROUP at {equal} lanes a chain equals "
                  "LANES bit for bit (samples and fields_out); the rule picks "
                  f"{picked.route}", flush=True)
            rec[f"{name} at {label}"] = {
                "G": G, "B": B, "R": R, "n": n, "S": S, "picked_lanes": picked.lanes,
                "route": picked.route, "differing_chains_by_lanes": fracs,
                "group_equal_to_lanes": equal}
            del outs, got, plain
        del Q, he, init01, u, hv
        torch.cuda.empty_cache()
    return rec, pairs


# phase 6: K1 and K2 pair at the calls whose layouts moved when THREAD went
# past n = 8 and GROUP came: label -> (width, G, B, R, n)
LAYOUT_TIMING_CALLS = {
    "K1 at the search's SA h8 call": (0, 20, 20, 1000, 9),
    "K2 pair at the search's BMS h8 call": (2, 20, 20, 1000, 9),
    "K1 at the warm start": (0, 2, 60, 100, 10),
    "K1 at the (b) sweep call": (0, 20, 3, 100, 41),
    "K2 pair at the (b) sweep call": (2, 20, 3, 100, 41),
}


def parent_lanes(G: int, B: int, R: int, n: int) -> int:
    """The layout the K1/K2 rule picked before THREAD went past n = 8 and
    GROUP came: a thread a chain at n ≤ 8 and more than 4,224 chains, else a
    warp a chain."""
    return 1 if n <= 8 and G * B * R > 4_224 else 32


def chain_layout_times(dev, rng, smi: str) -> dict:
    """Phase 6: each of ``LAYOUT_TIMING_CALLS`` at S=1000 in Philox mode on
    random QUBOs, the layout the rule picks and the earlier rule's
    (``parent_lanes``) forced, in turns (``in_turns``), beside its bound
    (``roofline.anneal_bound`` from the flips of one more launch)."""
    from qbmx_torch.core.qubo import random_qubo_batch
    from qbmx_torch.samplers import kernel_call
    from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

    S, out = 1000, {}
    for label, (width, G, B, R, n) in LAYOUT_TIMING_CALLS.items():
        Qg = random_qubo_batch(rng, G, n).to(dev)
        he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        form = structured_form(Qg, he, S, width)
        picked = kernel_call.chain_layout(G, B, R, n, width=width)
        before = kernel_call.chain_layout(G, B, R, n, parent_lanes(G, B, R, n), width)
        run = lambda L: k1k2_launch(width, form, R, S, lanes=L, generator=gen_of(3))
        new_ms, old_ms = in_turns(lambda: run(picked.lanes), lambda: run(before.lanes), reps=2)
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        k1k2_launch(width, form, R, S, lanes=picked.lanes, generator=gen_of(3), flips=flips)
        decisions = None if width == 0 else G * B * R * heatbath_units(n, width) * S
        bound = anneal_bound(G, B, R, n, S, flips=int(flips.item()), decisions=decisions)
        out[label] = {"G": G, "B": B, "R": R, "n": n, "S": S, "lanes": picked.lanes,
                      "route": picked.route, "ms": new_ms, "parent_route": before.route,
                      "parent_ms": old_ms, "speedup": old_ms / new_ms,
                      "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        print(f"phase 6 layouts: {label} (G={G} B={B} R={R} n={n} S={S}): {picked.route} "
              f"{new_ms:.3f} ms, the earlier rule's {before.route} {old_ms:.3f} ms (forced; CUDA "
              f"events, in turns new old old new, medians of 2), {old_ms / new_ms:.2f}x; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bound_ms'] / new_ms:.1%}); {smi}", flush=True)
        del Qg, he, form
    return out



# K3's calls past n = 8 (phase 3), held against plain at every layout that
# takes them: label -> (B, M, R, n, S)
PT_LAYOUT_CALLS = {
    "the flat PT h8 call": (120, 8, 100, 9, 100),
    "the flat PT h8 call, all reads": (120, 8, 1000, 9, 20),
    "the CDQBM (b) PT call": (6, 8, 100, 41, 100),
    "the CDQBM (b) PT sweep call": (60, 8, 100, 41, 100),
    "n=32": (20, 8, 100, 32, 50),
    "n=33": (20, 8, 100, 33, 50),
    **{f"M={M}": (20, M, 100, 12, 50) for M in (4, 8, 16, 32)},
}


def pt_layouts_check(dev, rng) -> tuple[dict, list]:
    """Phase 3: K3 at ``PT_LAYOUT_CALLS``, each layout that takes the call
    forced and the layout the rule picks (through the sampler's entry),
    against the plain version under the same host variates (the 1% bound);
    GROUP (4, 8, 16 lanes a rung) against WARP (a rung a warp) forced on
    the same draws, samples equal bit for bit.  Returns the records and
    (differing, max_abs_err) pairs."""
    from qbmx_torch.core.qubo import random_qubo_batch
    from qbmx_torch.samplers import launches as launches_mod
    from qbmx_torch.samplers import pt_cuda, tempering

    rec, pairs = {}, []
    for label, (B, M, R, n, S) in PT_LAYOUT_CALLS.items():
        Q = random_qubo_batch(rng, B, n).to(dev)
        hv = pt_hv(rng, B * M, R, n, S, dev)
        plain = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
        shape = f"B={B} M={M} R={R} n={n} S={S}"
        outs, fracs = {}, {}
        for L in pt_cuda.LAYOUTS:
            if n > pt_cuda.max_n(L) or (L == pt_cuda.RUNG and M > pt_cuda.RUNG_MAX_M):
                continue
            outs[L] = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M, host_variates=hv,
                                                   _layout=L)
            route = pt_cuda.pt_layout(B, M, R, n, L).route
            fracs[L], err = compare(outs[L], plain, f"K3 at {label} {shape}, {route} (forced)")
            pairs.append((fracs[L], err))
        picked = pt_cuda.pt_layout(B, M, R, n)
        launches_mod.reset()
        got = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M, host_variates=hv)
        torch.cuda.synchronize()
        check(launches_mod.counts() == {"pt_heatbath": 1},
              f"K3 at {label}: the sampler's entry launched {launches_mod.counts()}")
        pairs.append(compare(got, plain, f"K3 at {label} {shape}, {picked.route} (the rule's)"))
        check(torch.equal(got, outs[picked.lanes]),
              f"K3 at {label}: the sampler's entry and {picked.route} forced differ")
        equal = [L for L in pt_cuda.GROUP_LANES if L in outs]
        for L in equal:
            check(torch.equal(outs[L], outs[pt_cuda.WARP]),
                  f"K3 at {label}: {L} lanes a rung and a rung a warp differ on the same draws")
        print(f"phase 3 K3 at {label} {shape}: GROUP at {equal} lanes a rung equals a rung a warp "
              f"bit for bit; the rule picks {picked.route}", flush=True)
        rec[label] = {"B": B, "M": M, "R": R, "n": n, "S": S, "picked_lanes": picked.lanes,
                      "route": picked.route, "differing_chains_by_lanes": fracs,
                      "group_equal_to_warp": equal}
        del Q, hv, plain, outs, got
        torch.cuda.empty_cache()
    return rec, pairs


# phase 6: K3 at the users' calls past n = 8 (PERF.md §6): label -> (B, M, R,
# n, S of the turns); the sweep's turns are cut to 100 sweeps (a rung a warp
# takes seconds there), its rule's layout also timed at 1000
PT_TIMING_CALLS = {
    "the flat PT h8 call": (120, 8, 1000, 9, 1000),
    "the flat PT h8 sweep call": (1200, 8, 1000, 9, 100),
    "qm.main's PT call": (20, 8, 100, 11, 1000),
    "the CDQBM (b) PT call": (6, 8, 100, 41, 1000),
    "the CDQBM (b) PT sweep call": (60, 8, 100, 41, 1000),
}
PT_PLAIN_S = 100  # phase 6: the plain version's depth at those calls
# the route pt_cuda.pt_layout gives each (phase 3 checks it)
PT_USER_ROUTES = {
    "the flat PT h8 call": "a rung a thread",
    "the flat PT h8 sweep call": "a rung a thread",
    "qm.main's PT call": "a rung a thread",
    "the CDQBM (b) PT call": "16 lanes a rung",
    "the CDQBM (b) PT sweep call": "8 lanes a rung",
}


def pt_layout_times(dev, rng, smi: str) -> dict:
    """Phase 6: each of ``PT_TIMING_CALLS`` in Philox mode on random QUBOs,
    every layout that takes the call forced, in turns (a rotation through
    the layouts and back, each turn a median of 2 CUDA-event runs after a
    warm-up): the rule's layout against the fastest and against a rung a
    warp, beside the plain version's time at ``PT_PLAIN_S`` sweeps and the
    bound (``roofline.anneal_bound`` from K3's decisions alone).  A record,
    not a gate: times move up to 16% between calls (PERF.md §6)."""
    from qbmx_torch.core.qubo import random_qubo_batch
    from qbmx_torch.samplers import pt_cuda, tempering
    from qbmx_torch.utils.roofline import anneal_bound

    out = {}
    for label, (B, M, R, n, S) in PT_TIMING_CALLS.items():
        Q = random_qubo_batch(rng, B, n).to(dev)
        picked = pt_cuda.pt_layout(B, M, R, n)
        run = lambda L, S=S: pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M,
                                                          generator=gen_of(3), _layout=L)
        order = [L for L in pt_cuda.LAYOUTS
                 if n <= pt_cuda.max_n(L) and (L != pt_cuda.RUNG or M <= pt_cuda.RUNG_MAX_M)]
        turns = {L: [] for L in order}
        for L in [*order, *reversed(order)]:
            turns[L].append(cuda_ms(lambda L=L: run(L), runs=2))
        ms = {L: statistics.mean(v) for L, v in turns.items()}
        best = min(order, key=ms.get)
        new_ms, warp_ms = ms[picked.lanes], ms[pt_cuda.WARP]
        full_ms = new_ms if S == 1000 else cuda_ms(lambda: run(picked.lanes, 1000), runs=3)
        plain_ms = cuda_ms(lambda: tempering.pt_sample_batch_plain(
            Q, R, PT_PLAIN_S, num_replicas=M), runs=1)
        bound = anneal_bound(B, 1, R, n, 1000, decisions=B * M * R * n * 1000)
        out[label] = {"B": B, "M": M, "R": R, "n": n, "S": S, "lanes": picked.lanes,
                      "route": picked.route, "turns_ms": {str(L): v for L, v in turns.items()},
                      "ms": new_ms, "fastest_lanes": best, "over_fastest": new_ms / ms[best],
                      "warp_ms": warp_ms, "speedup": warp_ms / new_ms, "ms_s1000": full_ms,
                      "plain_ms": plain_ms, "plain_S": PT_PLAIN_S,
                      "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        print(f"phase 6 K3 layouts: {label} (B={B} M={M} R={R} n={n} S={S}): "
              + ", ".join(f"{L} lanes {v[0]:.3f}/{v[1]:.3f}" for L, v in turns.items())
              + f" ms (forced; CUDA events, a rotation there and back, medians of 2); the rule's "
              f"{picked.route} {new_ms:.3f} ms, {new_ms / ms[best]:.3f}x the fastest ({best} "
              f"lanes), {warp_ms / new_ms:.2f}x faster than a rung a warp; at S=1000 "
              f"{full_ms:.3f} ms; plain {plain_ms:.3f} ms at S={PT_PLAIN_S}; bound at S=1000 "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bound_ms'] / full_ms:.1%}); {smi}", flush=True)
        del Q
    return out

def layout_turns(dev, smi: str) -> dict:
    """K4's shared and global-field layouts, and K5's dense and global
    paths, each forced on the same call, timed in turns (``in_turns``;
    Philox mode): K4 Metropolis and pair at the CDQBM (a) call's G=2 B=20
    R=100 across n up to the shared layout's widest (random QUBOs, S=10;
    at n=717 also the CDQBM (a) step's own QUBOs), K5 M=8 at the flat H=300
    PT call and at G=2 B=20 R=100 across n."""
    from qbmx_torch.core.qubo import random_qubo_batch
    from qbmx_torch.models.cdqbm import cdqbm_a_qubos
    from qbmx_torch.samplers import pt_wide_cuda, wide_cuda

    t0 = time.perf_counter()
    rng = np.random.default_rng(3368)
    out = {"k4": [], "k5": []}
    G, B, R = 2, 20, 100
    switch, pt_switch = wide_cuda.switch_n(), pt_wide_cuda.switch_n()
    for n, what in ((242, "random"), (512, "random"), (717, "random"), (717, "CDQBM (a) step"),
                    (1024, "random"), (1280, "random"), (1536, "random"), (1792, "random"),
                    (2048, "random"), (2232, "random"), (switch, "random"),
                    (switch + 1, "random"), (3000, "random"), (3368, "random")):
        S = 10
        if what == "random":
            Q = random_qubo_batch(rng, G, n).to(dev)
            he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        else:
            Q, he = cdqbm_a_qubos(B, dev)
        for rule, label in ((0, "Metropolis"), (2, "pair")):
            J, h, hot, logr = structured_form(Q, he, S, rule)
            geo = {lay: wide_cuda.layout_geometry(G, B, R, n, lay)
                   for lay in (wide_cuda.SHARED, wide_cuda.GLOBAL)}
            run = lambda lay: lambda: wide_cuda.launch(J, h, hot, logr, R, S, rule,
                                                       generator=gen_of(5), geometry=geo[lay])
            shared, glob = in_turns(run(wide_cuda.SHARED), run(wide_cuda.GLOBAL),
                                    reps=1 if n > 2048 else 2)
            out["k4"].append({"n": n, "qubos": what, "rule": label, "S": S, "shared_ms": shared,
                              "global_ms": glob,
                              "shared_chains_a_block": geo[wide_cuda.SHARED].chains_per_block,
                              "global_chains_a_block": geo[wide_cuda.GLOBAL].chains_per_block})
            print(f"phase 10 K4 layouts in turns G={G} B={B} R={R} n={n} S={S} {label} ({what} "
                  f"QUBOs): shared {shared:.3f} ms ({geo[wide_cuda.SHARED].chains_per_block} "
                  f"chains a block), global {glob:.3f} ms "
                  f"({geo[wide_cuda.GLOBAL].chains_per_block}); global/shared {glob / shared:.3f}")
    M = 8
    for G, B, R, n, S, what in ((2, 60, 16, 301, 100, "qbm_main --solver PT -hn 300's call"),
                                (2, 20, 100, 717, 10, "random"), (2, 20, 100, 1024, 10, "random"),
                                (2, 20, 100, 1536, 10, "random"), (2, 20, 100, 2048, 4, "random"),
                                (2, 20, 100, 1056, 4, "random"), (2, 20, 100, 1280, 4, "random"),
                                (2, 20, 100, pt_switch, 4, "random"),
                                (2, 20, 100, pt_switch + 1, 4, "random"),
                                (2, 20, 100, 3368, 4, "random")):
        Q = random_qubo_batch(rng, G, n).to(dev)
        he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        form = pt_wide_cuda.structured_form(Q, he, M)
        run = lambda path: lambda: pt_wide_cuda.launch(*form, R, S, generator=gen_of(5), path=path)
        dense, glob = in_turns(run(pt_wide_cuda.DENSE), run(pt_wide_cuda.GLOBAL),
                               reps=1 if n > 2048 else 2)
        out["k5"].append({"G": G, "B": B, "R": R, "n": n, "M": M, "S": S, "qubos": what,
                          "dense_ms": dense, "global_ms": glob})
        print(f"phase 10 K5 paths in turns G={G} B={B} R={R} n={n} M={M} S={S} ({what}): dense "
              f"{dense:.3f} ms, global {glob:.3f} ms ({S + 1} launches); global/dense "
              f"{glob / dense:.3f}")
        del Q, he, form
    print(f"phase 10 layouts in turns ({smi}): {time.perf_counter() - t0:.1f} s")
    return out


def sparse_structured(rng, G, B, n, dev, density=0.005):
    """G QUBOs whose couplings are ``density`` nonzeros, and the restricted
    flat model's pattern besides (variable 0, the output, coupled to every
    other: ``qbm_main -hn 3400``'s unclamped group), and their h_extra."""
    from qbmx_torch.core.qubo import random_qubo_batch

    Q = random_qubo_batch(rng, G, n).to(dev)
    keep = torch.as_tensor(rng.random((G, n, n)) < density, device=dev)
    keep[:, 0, :] = True
    Q = torch.where(keep | torch.eye(n, dtype=torch.bool, device=dev), Q, torch.zeros_like(Q))
    return Q, torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)


def dense_h300_check(dev) -> tuple:
    """Phase 3's K4 dense shared path at the call that launches it on the
    main path (``qbm_main -hn 300 -r False``: a dense ``w_hh``), on that
    step's own QUBOs (G=2 B=60 n=301 R=100, the bands' batch; S cut to 10),
    Metropolis and pair through the samplers' entries against plain under
    host variates, each launching ``anneal_wide`` alone, and again with
    ``dense_couplings`` (the model's hint: no count of J's nonzeros) to the
    same samples bit for bit; returns the QUBOs and the two comparisons."""
    from qbmx_torch.cli.compare_kernels import flat_step_qubos
    from qbmx_torch.samplers import gibbs, gibbs_cuda, sa_cuda, sa_torch, wide_cuda

    Qu, hu = flat_step_qubos(300, 60, dev, restricted=False)
    G, B, n = hu.shape
    R, S = 100, 10
    rng = np.random.default_rng(301)
    hv = (bits(rng, (G, B, R, n), dev), uniforms(rng, (S, G, B, n, R), dev))
    results = []
    for width, kern, plain in (
            ("Metropolis", lambda **kw: sa_cuda.sa_sample_groups_cuda(Qu, hu, R, S,
                                                                      host_variates=hv, **kw),
             lambda: sa_torch.sa_sample_groups_plain(Qu, hu, R, S, host_variates=hv)),
            ("pair", lambda **kw: gibbs_cuda.gibbs_sample_groups_cuda(Qu, hu, R, S, pair=True,
                                                                      host_variates=hv, **kw),
             lambda: gibbs.gibbs_sample_groups_plain(Qu, hu, R, S, pair=True,
                                                     host_variates=hv))):
        for c in (sa_cuda, gibbs_cuda, wide_cuda):
            c.reset_launch_counts()
        out = kern()
        hinted = kern(dense_couplings=True)
        torch.cuda.synchronize()
        got = {k: v for c in (sa_cuda, gibbs_cuda, wide_cuda)
               for k, v in c.launch_counts.items() if v}
        check(got == {"anneal_wide": 2}, f"K4 {width} at qbm_main -hn 300 -r False: {got}")
        check(torch.equal(out, hinted), f"K4 {width} at qbm_main -hn 300 -r False: the "
                                        "dense_couplings hint changed the samples")
        results.append(compare(out, plain(), f"K4 {width} dense path, qbm_main -hn 300 -r False's "
                                             f"step QUBOs G={G} B={B} n={n} R={R} S={S}"))
    return Qu, hu, results


def sparse_shared_phase(dev, smi: str, counters) -> dict:
    """Phase 10's K4 sparse shared path (module docstring): on the step
    QUBOs of CDQBM (a) and of ``qbm_main -hn 300 -r True``, both shared
    paths forced, equal bit for bit, and the sparse path through the
    samplers' entries against plain (depth cut); then a few
    training steps on each path through the models, ending in the same
    parameters; returns its record."""
    import functools

    from qbmx_torch.cli.compare_kernels import flat_step_qubos
    from qbmx_torch.core.qubo import split_qubo
    from qbmx_torch.models.base import tree_leaves
    from qbmx_torch.models.cdqbm import CDQBM, cdqbm_a_qubos
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.samplers import gibbs, gibbs_cuda, pt_wide_cuda, sa_cuda, sa_torch, wide_cuda

    t0 = time.perf_counter()
    rng = np.random.default_rng(717)
    rec = {"max_abs_err": [], "differing_chains": [], "calls": {}, "training": {}}

    def launched() -> dict:
        return {k: v for c in counters for k, v in c.launch_counts.items() if v}

    S = 65  # past the refresh at sweep 64
    Sp, Rp = 10, 100  # the plain version's check, through the samplers' entries
    for label, (Q, he) in (("CDQBM (a)", cdqbm_a_qubos(20, dev)),
                           ("restricted H=300", flat_step_qubos(300, 73, dev))):
        G, B, n = he.shape
        R = 100
        nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Q)[1]))
        geo = wide_cuda.wide_geometry(G, B, R, n)
        check(wide_cuda.shared_path(nnz, n, geo.chains_per_block) == wide_cuda.SPARSE,
              f"phase 10 {label}: the rule does not take the sparse shared path ({nnz})")
        hv = (bits(rng, (G, B, R, n), dev), uniforms(rng, (S, G, B, n, R), dev))
        hvp = (bits(rng, (G, B, Rp, n), dev), uniforms(rng, (Sp, G, B, n, Rp), dev))
        for name, rule in (("Metropolis", 0), ("single", 1), ("pair", 2), ("quad", 4)):
            J, h, hot, logr = structured_form(Q, he, S, rule)
            res = {}
            for path in (wide_cuda.DENSE, wide_cuda.SPARSE):
                fields = torch.empty((G, B, R, n), device=dev)
                flips = torch.zeros(2, dtype=torch.int64, device=dev)
                for c in counters:
                    c.reset_launch_counts()
                out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=hv,
                                       fields_out=fields, flips=flips, field_pass=path)
                torch.cuda.synchronize()
                key = "anneal_wide" if path == wide_cuda.DENSE else "anneal_wide_sparse"
                check(launched() == {key: 1}, f"phase 10 {label} {name} {path}: {launched()}")
                res[path] = (out, fields, flips)
            unequal = [k for k, a, b in zip(("samples", "fields", "counters"), res["dense"],
                                            res["sparse"]) if not torch.equal(a, b)]
            check(not unequal, f"phase 10 K4 shared paths at {label} {name} S={S}: {unequal} "
                               "differ")
            changes, work = res["sparse"][2].tolist()
            for c in counters:
                c.reset_launch_counts()
            if rule == 0:
                got = sa_cuda.sa_sample_groups_cuda(Q, he, Rp, Sp, host_variates=hvp)
                plain = sa_torch.sa_sample_groups_plain(Q, he, Rp, Sp, host_variates=hvp)
            else:
                kw = dict(pair=rule == 2, quad=rule == 4, host_variates=hvp)
                got = gibbs_cuda.gibbs_sample_groups_cuda(Q, he, Rp, Sp, **kw)
                plain = gibbs.gibbs_sample_groups_plain(Q, he, Rp, Sp, **kw)
            torch.cuda.synchronize()
            check(launched() == {"anneal_wide_sparse": 1},
                  f"phase 10 {label} {name}: the sampler launched {launched()}")
            frac_err = compare(got, plain, f"K4 sparse {name} {label} G={G} B={B} n={n} R={Rp} "
                                           f"S={Sp} (the step's QUBOs, {max(nnz)} nonzeros; "
                                           "the sampler's entry)", phase=10)
            rec["differing_chains"].append(frac_err[0])
            rec["max_abs_err"].append(frac_err[1])
            rec["calls"][f"{label} {name}"] = {"bit_for_bit": True, "changes": changes,
                                               "flip_work": work,
                                               "differing_chains": frac_err[0]}
            print(f"phase 10 K4 shared paths forced at {label} {name} G={G} B={B} n={n} R={R} "
                  f"S={S}: dense (J_g in tiles) and sparse (row lists, {max(nnz)} nonzeros) "
                  f"equal bit for bit in samples, fields and counters ({changes} changes, "
                  f"{work} nonzeros of their rows)")
            del res, got, plain
        del hv, hvp
    # a few training steps on each path: the same parameters bit for bit
    dense_launch = functools.partial(wide_cuda.launch, field_pass=wide_cuda.DENSE)
    ximg = torch.as_tensor(rng.random((20, 28, 28), dtype=np.float32), device=dev)
    x = torch.as_tensor(rng.random((73, 784), dtype=np.float32), device=dev)
    for label, make, inputs in (
            ("CDQBM (a)", lambda solver: CDQBM(
                pooling_size=4, pooling_type="probabilistic", sequential_layer_sizes=[4],
                hidden_bias_type="shared", sample_count=100, anneal=1000, beta_eff=5.0,
                solver=solver, device=dev), (ximg, torch.arange(20, device=dev) % 2)),
            ("restricted H=300", lambda solver: DiscQBM(
                dim_input=784, n_hidden_nodes=300, sample_count=100, anneal_steps=1000,
                restricted=True, solver=solver, device=dev), (x, torch.arange(73, device=dev) % 2))):
        for solver in ("SA", "BMS"):
            runs = {}
            for path in (wide_cuda.SPARSE, wide_cuda.DENSE):
                m = make(solver)
                mask = torch.ones(inputs[0].shape[0], device=dev)
                saved = wide_cuda.launch
                if path == wide_cuda.DENSE:
                    wide_cuda.launch = dense_launch  # the sampler's calls, dense path forced
                try:
                    for c in counters:
                        c.reset_launch_counts()
                    nll = [float(m._step(*inputs, mask, 0.02)[0]) for _ in range(3)]
                    torch.cuda.synchronize()
                    counts = launched()
                finally:
                    wide_cuda.launch = saved
                key = "anneal_wide" if path == wide_cuda.DENSE else "anneal_wide_sparse"
                check(counts == {key: 3}, f"phase 10 {label} {solver} {path}: launches {counts}")
                runs[path] = (nll, [a.clone() for a in tree_leaves(m.params)])
            same = runs["sparse"][0] == runs["dense"][0] and all(
                torch.equal(a, b) for a, b in zip(runs["sparse"][1], runs["dense"][1]))
            check(same, f"phase 10 {label} {solver}: 3 steps on the sparse path do not end in "
                        "the dense path's parameters")
            rec["training"][f"{label} {solver}"] = {"steps": 3, "bit_for_bit": same,
                                                    "nll": runs["sparse"][0]}
            print(f"phase 10 {label} {solver} sc100 anneal 1000: 3 steps on K4's sparse shared "
                  f"path and 3 with its dense path forced end in the same parameters and nll "
                  f"bit for bit ({runs['sparse'][0]})")
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 10 K4 sparse shared path: {rec['seconds']:.1f} s ({smi})")
    return rec


def wide_phase(dev, smi: str, counters, made) -> dict:
    """Phase 10 (module docstring): the widths and ladders past the shared
    layouts -- K4's global-field layout and K5's global path, each with its
    dense and its sparse field pass -- and the flat trainer at ``qbm_main
    -hn 3400``, restricted and dense; returns its record."""
    from qbmx_torch.cli import qbm_main as qm
    from qbmx_torch.core.qubo import split_qubo
    from qbmx_torch.samplers import (gibbs, gibbs_cuda, pt_wide_cuda, sa_cuda, sa_torch,
                                     tempering, wide_cuda)
    from qbmx_torch.samplers.api import densify_groups
    from qbmx_torch.utils.roofline import anneal_bound, global_field_bytes, heatbath_units

    t0 = time.perf_counter()
    rng = np.random.default_rng(3401)
    kernels = ("anneal_wide_global", "anneal_wide_global_sparse", "pt_wide_global",
               "pt_wide_global_sparse")
    errs, fracs = {k: [] for k in kernels}, {k: [] for k in kernels}

    def note(kernel, frac_err):
        fracs[kernel].append(frac_err[0])
        errs[kernel].append(frac_err[1])

    def launched() -> dict:
        return {k: v for c in counters for k, v in c.launch_counts.items() if v}

    # K4's global-field layout forced at n = 717 with each field pass: the
    # shared layout's samples, fields and counters bit for bit, every rule,
    # past a refresh, on dense and on sparse QUBOs
    for rule in (0, 1, 2, 4):
        for qubos in ("dense", "sparse"):
            G, B, n, R, S = 2, 3, 717, 20, 70
            if qubos == "dense":
                Q, he, init01, u = structured_problem(rng, G, B, n, R, S, dev)
            else:
                Q, he = sparse_structured(rng, G, B, n, dev)
                init01, u = bits(rng, (G, B, R, n), dev), uniforms(rng, (S, G, B, n, R), dev)
            J, h, hot, logr = structured_form(Q, he, S, rule)
            res = []
            for layout, field_pass in ((wide_cuda.SHARED, None), (wide_cuda.GLOBAL, "dense"),
                                       (wide_cuda.GLOBAL, "sparse")):
                fields = torch.empty((G, B, R, n), device=dev)
                flips = torch.zeros(2, dtype=torch.int64, device=dev)
                out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=(init01, u),
                                       fields_out=fields, flips=flips, field_pass=field_pass,
                                       geometry=wide_cuda.WideGeometry.of(G, B, R, n, 7, layout))
                torch.cuda.synchronize()
                res.append((out, fields, flips))
            check(all(torch.equal(a, b) for other in res[1:] for a, b in zip(res[0], other)),
                  f"K4 rule {rule} n={n} ({qubos} QUBOs): the global-field layout's passes "
                  "differ from the shared layout")
    print(f"phase 10 K4 global-field layout forced at G=2 B=3 n=717 R=20 S=70 (7 chains a "
          "block), dense and sparse QUBOs: samples, fields and counters of its dense and its "
          "sparse pass equal the shared layout's bit for bit, Metropolis and heat-bath single, "
          "pair, quad")
    # ... and past the shared layout, through the wrappers, against plain: on
    # dense QUBOs the dense pass, on sparse ones the sparse pass
    for n in (3369, 4096, 8192):
        for rule, label in ((0, "Metropolis"), (2, "pair"), (4, "quad")):
            for qubos, kernel in (("dense", "anneal_wide_global"),
                                  ("sparse", "anneal_wide_global_sparse")):
                G, B, R, S = 1, 2, 128, 2
                if qubos == "dense":
                    Q, he = structured_problem(rng, G, B, n, 1, 1, dev)[:2]
                else:
                    Q, he = sparse_structured(rng, G, B, n, dev)
                hv = (bits(rng, (G, B, R, n), dev), uniforms(rng, (S, G, B, n, R), dev))
                for c in counters:
                    c.reset_launch_counts()
                if rule == 0:
                    got = sa_cuda.sa_sample_groups_cuda(Q, he, R, S, host_variates=hv)
                    want = sa_torch.sa_sample_groups_plain(Q, he, R, S, host_variates=hv)
                else:
                    kw = dict(beta=1.0, pair=rule == 2, quad=rule == 4, host_variates=hv)
                    got = gibbs_cuda.gibbs_sample_groups_cuda(Q, he, R, S, **kw)
                    want = gibbs.gibbs_sample_groups_plain(Q, he, R, S, **kw)
                torch.cuda.synchronize()
                check(launched() == {kernel: 1},
                      f"K4 n={n} {label} ({qubos}): launches {launched()}, not {kernel} alone")
                note(kernel, compare(
                    got, want, f"K4 global-field {label} G={G} B={B} n={n} R={R} S={S} "
                    f"({qubos} QUBOs: the {kernel} pass)", phase=10))
                del Q, he, hv, got, want
    # K5's global path forced at n = 300 with each field pass: the dense
    # path's samples, states, fields, energies and counters bit for bit
    G, B, n, M, R, S = 2, 2, 300, 8, 8, 70
    for qubos in ("dense", "sparse"):
        Q, he = (structured_problem(rng, G, B, n, 1, 1, dev)[:2] if qubos == "dense"
                 else sparse_structured(rng, G, B, n, dev))
        J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, he, M)
        hv = pt_hv(rng, G * B * M, R, n, S, dev)
        res = []
        for path, field_pass in ((pt_wide_cuda.DENSE, None), (pt_wide_cuda.GLOBAL, "dense"),
                                 (pt_wide_cuda.GLOBAL, "sparse")):
            outs = (torch.empty((G * B * M, R, n), device=dev),
                    torch.empty((G * B * M, R, n), device=dev),
                    torch.empty((G * B * M, R), device=dev),
                    torch.zeros(2, dtype=torch.int64, device=dev))
            out = pt_wide_cuda.launch(J, h, betas, dbeta, R, S, host_variates=hv,
                                      states_out=outs[0], fields_out=outs[1], energy_out=outs[2],
                                      flips=outs[3], path=path, field_pass=field_pass)
            torch.cuda.synchronize()
            res.append((out, *outs))
        check(all(torch.equal(a, b) for other in res[1:] for a, b in zip(res[0], other)),
              f"K5 n=300 M=8 ({qubos} QUBOs): the global path's passes differ from the dense "
              "path")
    print(f"phase 10 K5 global path forced at G={G} B={B} n={n} M={M} R={R} S={S}, dense and "
          "sparse QUBOs: samples, states, fields, energies and counters of its dense and its "
          "sparse pass equal the dense path's bit for bit")
    # ... and past the shared paths, through the sampler's entry, against plain
    for G, B, n, M, R, S, qubos, why in (
            (2, 2, 3401, 8, 64, 4, "dense", "qbm_main -hn 3400 -r False's PT call, cut"),
            (2, 2, 3401, 8, 64, 4, "sparse", "qbm_main -hn 3400's restricted PT call, cut"),
            (1, 1, 3000, 24, 256, 4, "dense", "past a cluster of 2-rung blocks"),
            (1, 1, 300, 300, 256, 6, "dense", "past a cluster of 32-warp blocks"),
            (1, 1, 4100, 3, 256, 3, "dense", "past the 10-bit Philox block"),
            (1, 2, 4096, 2, 128, 2, "sparse", "n = 4096"),
            (1, 2, 8192, 2, 128, 2, "dense", "n = 8192"),
            (1, 2, 8192, 2, 128, 2, "sparse", "n = 8192")):
        Q, he = (structured_problem(rng, G, B, n, 1, 1, dev)[:2] if qubos == "dense"
                 else sparse_structured(rng, G, B, n, dev))
        kernel = "pt_wide_global" if qubos == "dense" else "pt_wide_global_sparse"
        hv = pt_hv(rng, G * B * M, R, n, S, dev)
        for c in counters:
            c.reset_launch_counts()
        got = pt_wide_cuda.pt_sample_groups(Q, he, R, S, num_replicas=M, host_variates=hv)
        torch.cuda.synchronize()
        check(launched() == {kernel: 1}, f"K5 n={n} M={M} ({qubos}): launches {launched()}, "
                                         f"not {kernel} alone")
        want = tempering.pt_sample_batch_plain(densify_groups(Q, he), R, S, num_replicas=M,
                                               host_variates=hv).reshape(G, B, R, n)
        note(kernel, compare(got, want, f"K5 global path G={G} B={B} n={n} M={M} R={R} S={S} "
                                        f"({why}; {qubos} QUBOs: {kernel})", phase=10))
        del Q, he, hv, got, want

    # the flat trainer at qbm_main -hn 3400 (n = 3401), both ways: restricted
    # (qm.main's default: J_g all zeros but the output's row and column, on
    # the global layouts' sparse pass) and as the CLI runs it (-r False, its
    # default: a dense w_hh, on the dense pass); SA and BMS on K4's global-
    # field layout, PT on K5's global path, one launch a sampler call
    anneal, bs = 5, 20
    steps, predictions = math.ceil(600 / bs), 2
    x = torch.as_tensor(np.random.default_rng(1).random((bs, 784), dtype=np.float32), device=dev)
    y = torch.as_tensor(np.arange(bs) % 2, device=dev)
    mask = torch.ones(bs, device=dev)
    R, M = 100, 8
    calls = {}
    for restricted in (True, False):
        how = "restricted" if restricted else "dense"
        tail = "_sparse" if restricted else ""
        kernel_of = {"SA": "anneal_wide_global" + tail, "BMS": "anneal_wide_global" + tail,
                     "PT": "pt_wide_global" + tail}
        runs = {}
        for solver, kernel in kernel_of.items():
            for c in counters:
                c.reset_launch_counts()
            t1 = time.perf_counter()
            acc, f1, precision, recall, auc = qm.main(
                device="cuda", data_set="synthetic", n_hidden_nodes=3400, sample_count=R,
                anneal=anneal, batch_size=bs, epochs=1, save="", solver=solver,
                restricted=restricted)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = launched()
            model = made[-1]
            nlls = model.training_history.nll_per_batch
            check(counts == {kernel: steps + predictions},
                  f"H=3400 {how} {solver}: launch counts {counts} for {steps} steps + "
                  f"{predictions} predictions")
            check(model.n_hidden_nodes + model.n_output_nodes == 3401, "H=3400: n is not 3401")
            check(model.restricted == restricted, f"H=3400 {how}: the model's restricted flag")
            check(len(nlls) == steps and all(math.isfinite(v) for v in nlls),
                  f"H=3400 {how} {solver}: nll {nlls}")
            check(all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc)),
                  f"H=3400 {how} {solver}: metrics out of range")
            for c in counters:
                c.reset_launch_counts()
            step = cuda_ms(lambda: model._step(x, y, mask, 0.01), runs=3)
            check(launched() == {kernel: 4}, f"H=3400 {how} {solver}: {launched()} for 4 steps")
            runs[solver] = {"launches": counts, "step_ms": step, "wall_s": wall,
                            "nll": [nlls[0], nlls[-1]], "acc": acc, "auc": auc}
            print(f"phase 10 slice {solver} ({how}): qbm_main cuda synthetic H=3400 (n=3401) "
                  f"{'restricted (qm.main default)' if restricted else '-r False (the CLI default)'}"
                  f" sc{R} anneal{anneal} bs{bs} e1: launch counts {counts} for {steps} steps + "
                  f"{predictions} predictions, nll {nlls[0]:.4f} -> {nlls[-1]:.4f}, test acc "
                  f"{acc:.4f} auc {auc:.4f}, wall {wall:.2f} s, step {step:.3f} ms (CUDA events, "
                  f"median of 3; one {kernel} launch a step; {smi})")
            runs[solver]["qubos"] = model.step_qubos(model.params, x,
                                                     y[:, None].to(torch.float32))
        model = None
        made.clear()

        # times at the trainer's call (G=2 B=20 R=100 n=3401 S=anneal, the
        # step's own QUBOs, Philox mode), the plain versions on the same
        # inputs (one run after a warm-up), bounds
        g = torch.Generator().manual_seed(7)
        Qs, hs = runs["SA"]["qubos"]
        G, B, n = hs.shape
        S = anneal
        k4 = lambda: sa_cuda.sa_sample_groups_cuda(Qs, hs, R, S, generator=g)
        k4_pair = lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qs, hs, R, S, generator=g,
                                                              pair=True)
        k5 = lambda: pt_wide_cuda.pt_sample_groups(Qs, hs, R, S, num_replicas=M, generator=g)
        times = {name: cuda_ms(fn, runs=3) for name, fn in (("k4", k4), ("k4_pair", k4_pair),
                                                            ("k5", k5))}
        plain = {}
        for name, fn in (("k4", lambda: sa_torch.sa_sample_groups_plain(Qs, hs, R, S,
                                                                        generator=g)),
                         ("k4_pair", lambda: gibbs.gibbs_sample_groups_plain(
                             Qs, hs, R, S, generator=g, pair=True)),
                         ("k5", lambda: tempering.pt_sample_batch_plain(
                             densify_groups(Qs, hs), R, S, num_replicas=M, generator=g))):
            plain[name] = cuda_ms(fn, runs=1)
        bounds, changes = {}, {}
        for name, rule in (("k4", wide_cuda.METROPOLIS), ("k4_pair", wide_cuda.PAIR)):
            J, h, hot, logr = structured_form(Qs, hs, S, rule)
            w = torch.zeros(2, dtype=torch.int64, device=dev)
            wide_cuda.launch(J, h, hot, logr, R, S, rule, generator=g, flips=w)
            units = n if rule == wide_cuda.METROPOLIS else heatbath_units(n, 2)
            bounds[name] = anneal_bound(G, B, R, n, S, decisions=G * B * R * units * S,
                                        flip_work=int(w[1]))
            changes[name] = [int(v) for v in w.tolist()]
        w = torch.zeros(2, dtype=torch.int64, device=dev)
        pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Qs, hs, M), R, S, generator=g, flips=w)
        bounds["k5"] = anneal_bound(G, B, R, n, S, rungs=M, flip_work=int(w[1]))
        changes["k5"] = [int(v) for v in w.tolist()]
        nnz = int((split_qubo(Qs)[1] != 0).sum())
        print(f"phase 10 global_field_bytes_model ({how} call; a formula, not a measurement: "
              "chains x S x 2 x 5 x (n rounded up to 8), one read and one write of each chain's "
              f"fields and state bytes a sweep): K4 {global_field_bytes(G * B * R, n, S)} bytes, "
              f"K5 {global_field_bytes(G * B * R * M, n, S)} bytes")
        print(f"phase 10 time at the H=3400 {how} step's call G={G} B={B} n={n} R={R} S={S} "
              f"(its own QUBOs: {nnz} nonzero couplings; Philox; CUDA events, kernels median of "
              f"3, plain one run after a warm-up; {smi}): K4 Metropolis {times['k4']:.3f} ms "
              f"(plain {plain['k4']:.3f}; bound {bounds['k4']['bound_ms']:.4f} by "
              f"{bounds['k4']['bound_by']}, {changes['k4'][0]} changes), pair "
              f"{times['k4_pair']:.3f} ms (plain {plain['k4_pair']:.3f}; bound "
              f"{bounds['k4_pair']['bound_ms']:.4f}, {changes['k4_pair'][0]} changes); K5 M={M} "
              f"{times['k5']:.3f} ms (plain {plain['k5']:.3f}; bound "
              f"{bounds['k5']['bound_ms']:.4f} by {bounds['k5']['bound_by']}, "
              f"{changes['k5'][0]} changes; {S + 1} launches)")

        # each kernel against its plain version at the trainer's own call,
        # each solver's step QUBOs, under variates drawn on the card
        main_path = {}
        for solver, name in (("SA", "K4 Metropolis"), ("BMS", "K4 pair"), ("PT", f"K5 M={M}")):
            Qs, hs = runs[solver]["qubos"]
            kernel = kernel_of[solver]
            if solver == "PT":
                hv = card_pt_hv(17, G * B * M, R, n, S, dev)
            else:
                init01, u = card_pt_hv(13, G * B, R, n, S, dev)[:2]
                hv = (init01.reshape(G, B, R, n), u.reshape(S, G, B, n, R))
            for c in counters:
                c.reset_launch_counts()
            if solver == "SA":
                got = sa_cuda.sa_sample_groups_cuda(Qs, hs, R, S, host_variates=hv)
            elif solver == "BMS":
                got = gibbs_cuda.gibbs_sample_groups_cuda(Qs, hs, R, S, pair=True,
                                                          host_variates=hv)
            else:
                got = pt_wide_cuda.pt_sample_groups(Qs, hs, R, S, num_replicas=M,
                                                    host_variates=hv)
            torch.cuda.synchronize()
            check(launched() == {kernel: 1},
                  f"{name} at the H=3400 {how} call: launch counts {launched()}")
            if solver == "SA":
                want = sa_torch.sa_sample_groups_plain(Qs, hs, R, S, host_variates=hv)
            elif solver == "BMS":
                want = gibbs.gibbs_sample_groups_plain(Qs, hs, R, S, pair=True, host_variates=hv)
            else:
                want = tempering.pt_sample_batch_plain(densify_groups(Qs, hs), R, S,
                                                       num_replicas=M,
                                                       host_variates=hv).reshape(G, B, R, n)
            frac_err = compare(got, want, f"{name} ({kernel}) at the H=3400 {how} step's call "
                                          f"G={G} B={B} n={n} R={R} S={S} (its {solver} step "
                                          "QUBOs, variates drawn on the card)", phase=10)
            note(kernel, frac_err)
            main_path[name] = {"kernel": kernel, "differing_chains": frac_err[0],
                               "max_abs_err": frac_err[1]}
            del hv, got, want
        calls[how] = {"trainer": {k: {kk: vv for kk, vv in v.items() if kk != "qubos"}
                                  for k, v in runs.items()},
                      "kernel_of": kernel_of, "nonzero_couplings": nnz, "times_ms": times,
                      "plain_ms": plain, "bounds": bounds, "changes": changes,
                      "main_path_check": main_path}
        del runs, Qs, hs
    sparse_shared = sparse_shared_phase(dev, smi, counters)
    turns = layout_turns(dev, smi)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"calls": calls, "anneal": anneal, "sparse_shared": sparse_shared,
            "max_abs_err": {k: max(v) for k, v in errs.items()},
            "differing_chains": {k: max(v) for k, v in fracs.items()},
            "layout_turns": turns, "seconds": time.perf_counter() - t0}


# -- phase 11: the user scripts (the exact studies, the breastmnist search) ------

# the bars rows against qbmx's recorded table: NLL (absolute), accuracies
# (images of 80), bias sensitivity (relative)
BARS_BAND = {"nll": 0.02, "acc_images": 3, "sensitivity_rel": 0.02}
CARD_CPU_P_ATOL = 1e-4  # the bars variants' p(y=1|x) after 20 steps, card against CPU
MEDMNIST_SHAPES = {"breastmnist": (546, 78, 156), "pneumoniamnist": (4708, 524, 624)}
SEARCH_CONFIGS = {  # bms_hyper_search --configs at the script's widths, one epoch
    "sa_metropolis": {"solver": "SA", "h": 5, "lr": 0.307, "e": 1},
    "sa_heatbath": {"solver": "BMS", "h": 8, "lr": 0.453, "e": 1},
    "pt_heatbath": {"solver": "PT", "h": 5, "lr": 0.453, "sweeps": 128, "e": 1},
}
SEARCH_SA_H8 = {"solver": "SA", "h": 8}  # the search's SA h8 width (n = 9)


def read_table(text: str) -> list[dict]:
    """The rows of a study's markdown table: variant, QUBO vars and the four
    numeric columns (the last: bias sensitivity or test AUC)."""
    rows = []
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 6 and cells[1].isdigit():
            rows.append({"name": cells[0], "vars": int(cells[1]), "nll": float(cells[2]),
                         "acc_train": float(cells[3]), "acc_test": float(cells[4]),
                         "last": float(cells[5])})
    return rows


def bars_spreads(rows: list[dict], recorded: list[dict]) -> dict:
    """The largest differences of bars rows (``cdqbm_exact_study.main``'s, or
    a written table's ``read_table``) from the recorded ones, row by row:
    NLL, accuracies in images of 80, sensitivity relative; and whether the
    variants and QUBO-variable counts are the same."""
    last = lambda r: r.get("sensitivity", r.get("last"))
    return {
        "rows_equal": [(r["name"], r["vars"]) for r in rows]
                      == [(r["name"], r["vars"]) for r in recorded],
        "nll": max(abs(a["nll"] - b["nll"]) for a, b in zip(rows, recorded)),
        "acc_images": max(abs(round(a[k] * 80) - round(b[k] * 80))
                          for a, b in zip(rows, recorded) for k in ("acc_train", "acc_test")),
        "sensitivity_rel": max(abs(last(a) - last(b)) / abs(last(b))
                               for a, b in zip(rows, recorded)),
    }


def write_medmnist(root: Path, seed: int = 11) -> None:
    """Seeded MedMNIST files of the real shapes under ``root/medmnist``
    (28×28 uint8 images, labels (N, 1), 27% positive): a class template
    plus noise."""
    r = np.random.default_rng(seed)
    (root / "medmnist").mkdir(parents=True, exist_ok=True)
    for name, sizes in MEDMNIST_SHAPES.items():
        template = r.uniform(0, 1, (2, 28, 28))
        arrays = {}
        for split, n in zip(("train", "val", "test"), sizes):
            y = (r.random(n) < 0.27).astype(np.int64)
            img = 0.4 * template[y] + 0.6 * r.uniform(0, 1, (n, 28, 28))
            arrays[f"{split}_images"] = (img * 255).astype(np.uint8)
            arrays[f"{split}_labels"] = y[:, None]
        np.savez(root / "medmnist" / f"{name}.npz", **arrays)


def search_calls(search, data, smi: str) -> dict:
    """K1, K2 pair and K3 at the search's own step calls (10 seeds: G=20
    groups of B=20, R=1000; each solver's step QUBOs on the first batch),
    and K1 at its SA h8 call (n = 9),
    each launched once through its wrapper against its plain version under
    host variates (depth cut: K1 and K2 100 sweeps, K3 16), then timed at
    the full depth (Philox, CUDA events, median of 3) beside its bound and
    the plain version's time at the cut depth (one run after a warm-up)."""
    from qbmx_torch.samplers import (gibbs, gibbs_cuda, kernel_call, pt_cuda, sa_cuda, sa_torch,
                                     tempering)
    from qbmx_torch.samplers import launches as launches_mod
    from qbmx_torch.samplers.api import densify_groups
    from qbmx_torch.train.sweep import SeedParallelDQBM
    from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

    dev, rng, g = torch.device("cuda"), np.random.default_rng(15), gen_of(15)
    seeds = (list(search.DEFAULT_SEEDS) + search.EXTRA_SEEDS)[:10]
    x = torch.as_tensor(data[0][0][:20], device=dev)
    y = torch.as_tensor(np.asarray(data[0][1][:20]), device=dev)
    pair = WIDTH_OF["pair"]

    def counted(launch, *args):
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        launch(*args, generator=g, flips=flips)
        return int(flips.item())

    out = {}
    for key, cfg in (*SEARCH_CONFIGS.items(), ("sa_metropolis h8", SEARCH_SA_H8)):
        kernel = key.split()[0]
        sw = SeedParallelDQBM(seeds, dim_input=x.shape[1], n_hidden_nodes=cfg["h"],
                              restricted=False, sample_count=1000,
                              anneal_steps=cfg.get("sweeps", 1000), solver=cfg["solver"],
                              device=dev)
        Q, h = sw.step_qubos(x, y)
        G, B, n = h.shape
        R, S = 1000, cfg.get("sweeps", 1000)
        if kernel == "pt_heatbath":
            Qd, Sc, M = densify_groups(Q, h), 16, 8
            hv = pt_hv(rng, G * B * M, R, n, Sc, dev)
            kern = lambda: pt_cuda.pt_sample_batch_cuda(Qd, R, Sc, num_replicas=M, host_variates=hv)
            plain = lambda: tempering.pt_sample_batch_plain(Qd, R, Sc, num_replicas=M,
                                                            host_variates=hv)
            full = lambda: pt_cuda.pt_sample_batch_cuda(Qd, R, S, num_replicas=M, generator=g)
            bound = anneal_bound(G * B, 1, R, n, S, decisions=G * B * M * R * n * S)
        else:
            Sc = 100
            hv = (bits(rng, (G, B, R, n), dev), uniforms(rng, (Sc, G, B, n, R), dev))
            if kernel == "sa_metropolis":
                kern = lambda: sa_cuda.sa_sample_groups_cuda(Q, h, R, Sc, host_variates=hv)
                plain = lambda: sa_torch.sa_sample_groups_plain(Q, h, R, Sc, host_variates=hv)
                full = lambda: sa_cuda.sa_sample_groups_cuda(Q, h, R, S, generator=g)
                bound = anneal_bound(G, B, R, n, S, flips=counted(
                    sa_cuda.launch, *structured_form(Q, h, S), R, S))
            elif kernel == "sa_heatbath":
                kern = lambda: gibbs_cuda.gibbs_sample_groups_cuda(Q, h, R, Sc, pair=True,
                                                                   host_variates=hv)
                plain = lambda: gibbs.gibbs_sample_groups_plain(Q, h, R, Sc, pair=True,
                                                                host_variates=hv)
                full = lambda: gibbs_cuda.gibbs_sample_groups_cuda(Q, h, R, S, pair=True,
                                                                   generator=g)
                bound = anneal_bound(G, B, R, n, S, decisions=G * B * R * heatbath_units(n, pair) * S,
                                     flips=counted(gibbs_cuda.launch,
                                                   *structured_form(Q, h, S, pair), R, S, pair))
        launches_mod.reset()
        got = kern()
        torch.cuda.synchronize()
        counts = launches_mod.counts()
        check(counts == {kernel: 1}, f"phase 11: the search's {cfg['solver']} call launched "
                                     f"{counts}")
        label = (f"{kernel} at the search's {cfg['solver']} call G={G} B={B} n={n} R={R} "
                 f"S={Sc} (of {S}; the step's QUBOs)")
        frac, err = compare(got, plain(), label, phase=11)
        del got
        k_ms, p_ms = cuda_ms(full, runs=3), cuda_ms(plain, runs=1)
        del hv
        lay = None if kernel == "pt_heatbath" else kernel_call.chain_layout(
            G, B, R, n, width=pair if kernel == "sa_heatbath" else 0)
        lanes = lay and lay.lanes
        if n > 8:  # the h8 calls (n = 9, 400,000 chains): the route the rule names
            check(lay.route == H8_ROUTE, f"phase 11: {kernel} at the search's h8 call takes "
                                         f"{lay.route}, not {H8_ROUTE}")
        out[key] = {"G": G, "B": B, "n": n, "R": R, "S": S, "plain_S": Sc, "lanes": lanes,
                    "route": lay and lay.route,
                    "differing_chains": frac, "max_abs_err": err, "ms": k_ms,
                    "plain_ms_at_plain_S": p_ms, "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"]}
        print(f"phase 11 time {kernel} at the search's {cfg['solver']} h{cfg['h']} call (G={G} "
              f"B={B} n={n} R={R} S={S}): kernel {k_ms:.3f} ms (CUDA events, median of 3), plain "
              f"{p_ms:.3f} ms at S={Sc} (one run after a warm-up), bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}; {smi}")
    return out


def scripts_phase(smi: str) -> dict:
    """Phase 11: the user scripts' CLIs on the card, in a temporary working
    directory (their tables and records go to its ``out/parity_torch/``)
    with seeded MedMNIST files under ``$QBMX_DATA_DIR``."""
    import contextlib
    import io
    import os

    from qbmx_torch.cli import (bms_hyper_search, bms_winner_curves, cdqbm_breast_exact_study,
                                cdqbm_exact_study, cdqbm_multikernel_study, exact_harness)
    from qbmx_torch.samplers import launches as launches_mod

    t_phase = time.perf_counter()
    rec = {}
    recorded = lambda name: read_table((ROOT / "out" / "parity" / name).read_text())
    cwd, data_env = os.getcwd(), os.environ.get("QBMX_DATA_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        os.environ["QBMX_DATA_DIR"] = str(Path(tmp) / "data")
        try:
            # the bars study at full size: 14 variants × 400 Adam steps, 80/80 images
            t0 = time.perf_counter()
            rows = cdqbm_exact_study.main(["--device", "cuda"])
            rec["bars_s"] = time.perf_counter() - t0
            spreads = bars_spreads(rows, recorded("cdqbm_exact_study.md"))
            rec["bars_spreads"], rec["bars_band"] = spreads, BARS_BAND
            check(spreads["rows_equal"], "phase 11: the bars variants or QUBO-variable counts "
                  "differ from out/parity/cdqbm_exact_study.md")
            for k, limit in BARS_BAND.items():
                check(spreads[k] <= limit, f"phase 11: bars {k} {spreads[k]} past the band "
                      f"{limit} of out/parity/cdqbm_exact_study.md")
            print(f"phase 11 bars study (cdqbm_exact_study.main, 14 × 400 Adam steps): "
                  f"{rec['bars_s']:.1f} s, {smi}; against qbmx's recorded table: NLL "
                  f"{spreads['nll']:.4f} (band {BARS_BAND['nll']}), accuracies "
                  f"{spreads['acc_images']} images (band {BARS_BAND['acc_images']}), "
                  f"sensitivity {spreads['sensitivity_rel']:.5f} relative "
                  f"(band {BARS_BAND['sensitivity_rel']})")

            # each variant 20 steps on the card and on the CPU from the same inputs
            X, Y = cdqbm_exact_study.make_bars(np.random.default_rng(0))
            worst = {}
            for name, kw in cdqbm_exact_study.variants():
                kw = dict(kw)
                Xs = X * 2.0 - 1.0 if kw.pop("signed", False) else X
                p = {}
                for d in ("cuda", "cpu"):
                    m = cdqbm_exact_study.make_model(X.shape[1:], d, **kw)
                    params, _ = cdqbm_exact_study.train_exact(m, Xs, Y, steps=20)
                    p[d] = exact_harness.predict_p1(
                        lambda q, x: cdqbm_exact_study.exact_p1(m, q, x), params, Xs)
                worst[name] = float(np.abs(p["cuda"] - p["cpu"]).max())
            rec["card_cpu_p_after_20_steps"] = worst
            check(max(worst.values()) <= CARD_CPU_P_ATOL,
                  f"phase 11: p(y=1|x) after 20 steps, card against CPU: {worst}")
            print(f"phase 11 bars, 20 steps, card against CPU: max |Δp| "
                  f"{max(worst.values()):.2e} over the 14 variants (bar {CARD_CPU_P_ATOL})")

            # the two MedMNIST studies on seeded files of the real shapes
            write_medmnist(Path(tmp) / "data")
            for study, name in ((cdqbm_breast_exact_study, "cdqbm_breast_exact_study.md"),
                                (cdqbm_multikernel_study, "cdqbm_multikernel_study.md")):
                t0 = time.perf_counter()
                out = study.main(["--device", "cuda"])
                seconds = time.perf_counter() - t0
                flat = out if isinstance(out, list) else [r for rows_ in out.values() for r in rows_]
                key = name.removesuffix(".md")
                check([(r["name"], r["vars"]) for r in flat]
                      == [(r["name"], r["vars"]) for r in recorded(name)],
                      f"phase 11: {key}'s variants or QUBO-variable counts differ from the "
                      "recorded table")
                check(all(math.isfinite(r["nll"]) for r in flat), f"phase 11: {key} NLL")
                rec[key] = {"seconds": seconds,
                            "rows": [{k: r[k] for k in ("name", "vars", "nll", "seconds")}
                                     for r in flat]}
                print(f"phase 11 {key} (seeded files): {len(flat)} rows in {seconds:.1f} s, "
                      f"{smi}; QUBO vars as recorded, NLL finite")

            # the search: one config a solver, 10 seeds, one epoch; one launch a step
            data = bms_hyper_search.breast_data()
            n_train = len(data[0][0])
            rec["search"] = {}
            for kernel, cfg in SEARCH_CONFIGS.items():
                steps = math.ceil(n_train / cfg.get("bs", 20))
                launches_mod.reset()
                t0 = time.perf_counter()
                records = bms_hyper_search.main(["--configs", json.dumps([cfg]), "--seeds", "10",
                                                 "--device", "cuda"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = launches_mod.counts()
                check(counts == {kernel: steps + 1},
                      f"phase 11: bms_hyper_search {cfg} launched {counts}, not {kernel} once a "
                      f"step ({steps}) and once for validation")
                check(set(records[0]) == {"cfg", "n_seeds", "time_s", "mean_acc", "std_acc",
                                          "mean_auc", "best_single", "any_beats_ref",
                                          "per_seed"}, "phase 11: the search record's keys")
                rec["search"][cfg["solver"]] = {
                    "cfg": cfg, "launches": counts, "seconds": seconds,
                    "ms_a_seed_step": seconds * 1000 / (steps * 10),
                    "mean_acc": records[0]["mean_acc"], "best_single": records[0]["best_single"]}
                print(f"phase 11 bms_hyper_search {cfg['solver']} (h{cfg['h']}, 10 seeds, "
                      f"{steps} steps + validation): {counts}, {seconds:.2f} s, "
                      f"{seconds * 1000 / (steps * 10):.3f} ms a seed-step (epoch wall with "
                      f"validation ÷ steps·seeds), {smi}")
            written = Path("out/parity_torch/bms_hyper_search.jsonl").read_text().splitlines()
            check(len(written) == len(SEARCH_CONFIGS), "phase 11: the search's JSONL lines")
            rec["search_calls"] = search_calls(bms_hyper_search, data, smi)

            # the winner curves: BMS h8 bs36, one epoch, 10 seeds, 100 prediction reads
            steps = math.ceil(n_train / 36)
            launches_mod.reset()
            t0 = time.perf_counter()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                path = bms_winner_curves.main(["--e", "1", "--seeds", "10", "--predict_reads",
                                               "100", "--device", "cuda"])
            seconds = time.perf_counter() - t0
            counts = launches_mod.counts()
            print(printed.getvalue(), end="")
            curves = json.loads(Path(path).read_text())["curves"]
            check(len(curves) == 10 and all(len(c["acc"]) == 1 for c in curves.values()),
                  "phase 11: the winner curves' JSON")
            check("acc/AUC Pareto front" in printed.getvalue()
                  and "top by acc (prob-scored AUC)" in printed.getvalue(),
                  "phase 11: the winner curves' fronts")
            check(counts == {"sa_heatbath": steps + 1},
                  f"phase 11: bms_winner_curves launched {counts}")
            rec["winner_curves"] = {"launches": counts, "seconds": seconds}
            print(f"phase 11 bms_winner_curves (BMS h8, 10 seeds, {steps} steps): {counts}, "
                  f"{seconds:.2f} s")
        finally:
            os.chdir(cwd)
            if data_env is None:
                os.environ.pop("QBMX_DATA_DIR", None)
            else:
                os.environ["QBMX_DATA_DIR"] = data_env
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 11 user scripts: {rec['phase_s']:.1f} s")
    return rec


# phase 12: the band settings (``qbmx_torch/cli/bands.py``), each with the
# kernel (its launch counter) and the route its every sampler call must take
BAND_ROUTES = {
    "flat_sa_h2": ("sa_metropolis", "a thread a chain"),
    "flat_bms_h2": ("sa_heatbath", "a thread a chain"),
    "flat_pt_h2": ("pt_heatbath", "a rung a thread"),
    "flat_sa_h8": ("sa_metropolis", "a thread a chain"),
    "flat_bms_h8": ("sa_heatbath", "a thread a chain"),
    "flat_pt_h8": ("pt_heatbath", "a rung a thread"),
    "cdqbm_b_sa": ("sa_metropolis", "8 lanes a chain"),
    "cdqbm_b_bms": ("sa_heatbath", "8 lanes a chain"),
    "cdqbm_b_pt": ("pt_heatbath", "8 lanes a rung"),
    "flat_sa_h300": ("anneal_wide", "shared layout"),
    "flat_pt_h300": ("pt_wide", "dense path"),
    "flat_bms_h300": ("anneal_wide", "shared layout"),
}
PT_RUNGS = 8  # the CLIs' PT ladder
H8_ROUTE = "a thread a chain"  # K1 and K2 pair at the search's h8 calls (phase 11)


def band_route(kernel: str, G: int, B: int, R: int, n: int) -> str:
    """The route the layout rules give ``kernel`` at a sampler call of G
    groups of B problems, R reads, width n."""
    from qbmx_torch.samplers import kernel_call, pt_cuda, pt_wide_cuda, wide_cuda

    if kernel in ("sa_metropolis", "sa_heatbath"):  # the bands' BMS is pair
        return kernel_call.chain_layout(G, B, R, n, width=2 if kernel == "sa_heatbath" else 0).route
    if kernel == "anneal_wide":
        return f"{wide_cuda.wide_geometry(G, B, R, n).layout} layout"
    route = pt_wide_cuda.pt_route(G, B, PT_RUNGS, R, n)
    if kernel == "pt_heatbath" and route == kernel:
        return pt_cuda.pt_layout(G * B, PT_RUNGS, R, n).route
    if kernel == "pt_wide" and route == kernel:
        return f"{pt_wide_cuda.pt_wide_geometry(G, B, PT_RUNGS, R, n).path} path"
    return f"{route} (not {kernel})"


def band_phase(smi: str) -> dict:
    """Phase 12: North-star check 3 on the card for every route by which a
    kernel trains.  Each setting of :data:`BAND_ROUTES` trains the port's
    10-seed sweep through its CLI (``bands.train_port``) and its lr/10
    control; each must launch only its kernel, once a step and once a
    validation chunk, every call on the named route; the sweep must hold
    ``qbmx``'s committed band (``out/bands/<setting>/qbmx/``) at the
    Bonferroni width of all the settings' comparisons, and the control must
    fail it.  Every setting runs before the verdicts are checked."""
    import contextlib
    import io

    import qbmx_torch.cli.cdqbm_main as cm
    import qbmx_torch.cli.qbm_main as qm
    from qbmx_torch.cli import bands
    from qbmx_torch.samplers import launches as launches_mod
    from qbmx_torch.samplers.api import sampler_sample_groups
    from qbmx_torch.train import sweep as sweep_mod

    t_phase = time.perf_counter()
    settings = list(BAND_ROUTES)
    check(sorted(settings) == sorted(bands.SETTINGS), f"phase 12: the band settings "
          f"{sorted(bands.SETTINGS)} against the routes {sorted(settings)}")
    missing = [s for s in settings if not (bands.reference_dir(s) / "manifest.json").is_file()]
    check(not missing, f"phase 12: no committed qbmx reference for {missing}")
    k, z = bands.z_all(settings)
    calls = []

    class ShapeLog:
        """A sweep's sampler, recording each call's (groups, problems, reads, n)."""

        def __init__(self, inner):
            self.inner = inner

        def sample_groups(self, generator, Q_shared, h_extra, num_reads):
            G, B, n = h_extra.shape
            calls.append((G, B, num_reads, n))
            return sampler_sample_groups(self.inner, generator, Q_shared, h_extra, num_reads)

    class LoggedDQBM(sweep_mod.SeedParallelDQBM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sampler = ShapeLog(self.sampler)

    class LoggedCDQBM(sweep_mod.SeedParallelCDQBM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.model.sampler = ShapeLog(self.model.sampler)

    saved = qm.SeedParallelDQBM, cm.SeedParallelCDQBM
    qm.SeedParallelDQBM, cm.SeedParallelCDQBM = LoggedDQBM, LoggedCDQBM
    rec = {"k": k, "z": z, "settings": {}}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for s in settings:
                kernel, route = BAND_ROUTES[s]
                module, args = bands.SETTINGS[s]
                batch = int(args[args.index("-b") + 1])
                steps = bands.epochs(s) * math.ceil(600 / batch)  # synthetic: 600 train images
                srec = {"kernel": kernel, "route": route}
                for label, div in (("band", 1), ("control", bands.CONTROL_DIV)):
                    folder = Path(tmp, s, label)
                    calls.clear()
                    launches_mod.reset()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        bands.train_port(s, folder, device="cuda", lr_div=div)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts = launches_mod.counts()
                    train_calls = sum(1 for c in calls if c[0] == 2 * len(bands.SEEDS))
                    routes = sorted({band_route(kernel, *c) for c in calls})
                    check(counts == {kernel: len(calls)} and train_calls == steps,
                          f"phase 12 {s} {label}: launches {counts} for {len(calls)} sampler "
                          f"calls, {train_calls} of them steps (want {kernel} once a call and "
                          f"{steps} steps)")
                    check(routes == [route], f"phase 12 {s} {label}: routes {routes}, not "
                                             f"{route!r}")
                    holds, rows = bands.hold(s, folder, z)
                    srec[label] = {"holds": holds, "launches": counts[kernel], "steps": steps,
                                   "shapes": sorted(set(calls)), "wall_s": wall,
                                   "widest": bands.widest(rows), "means": bands.means(rows)}
                srec["reference"] = bands.means(rows, "ref")
                rec["settings"][s] = srec
                b, c = srec["band"], srec["control"]
                fin = lambda side, m: side[m][-1][0]
                print(f"phase 12 {s}: {kernel} ({route}) launched {b['launches']} times "
                      f"({steps} steps + validation) at {b['shapes']}; final epoch acc "
                      f"qbmx {fin(srec['reference'], 'acc'):.4f} port {fin(b['means'], 'acc'):.4f}"
                      f", auc qbmx {fin(srec['reference'], 'auc'):.4f} port "
                      f"{fin(b['means'], 'auc'):.4f}; widest {b['widest']['metric']} epoch "
                      f"{b['widest']['epoch']} {b['widest']['diff']:+.4f} of "
                      f"±{b['widest']['half_width']:.4f}: {'HOLDS' if b['holds'] else 'FAILS'}; "
                      f"control lr/10 final acc {fin(c['means'], 'acc'):.4f}, widest "
                      f"{c['widest']['diff']:+.4f} of ±{c['widest']['half_width']:.4f}: "
                      f"{'holds' if c['holds'] else 'fails'}; wall {b['wall_s']:.1f} + "
                      f"{c['wall_s']:.1f} s; {smi}")
    finally:
        qm.SeedParallelDQBM, cm.SeedParallelCDQBM = saved
    rec["phase_s"] = time.perf_counter() - t_phase
    bad = [s for s, r in rec["settings"].items() if not r["band"]["holds"]]
    loose = [s for s, r in rec["settings"].items() if r["control"]["holds"]]
    print(f"phase 12 bands: {len(settings)} settings, k = {k} comparisons at z_k = {z:.4f}; "
          f"bands held {len(settings) - len(bad)}/{len(settings)}, controls failed "
          f"{len(settings) - len(loose)}/{len(settings)}; {rec['phase_s']:.1f} s")
    check(not bad, f"phase 12: the port's band fails qbmx's at z_k = {z:.4f} for {bad}")
    check(not loose, f"phase 12: the lr/10 control holds qbmx's band for {loose}")
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    if not (ROOT / "qbmx_torch" / "csrc" / "sa_metropolis.cu").is_file():
        fail(f"{ROOT} is not a qbmx checkout (qbmx_torch/csrc is missing)")
    sys.path.insert(0, str(ROOT))
    from qbmx_torch import _build
    from qbmx_torch.cli.compare_kernels import flat_step_qubos
    from qbmx_torch.models.cdqbm import cdqbm_a_qubos
    from qbmx_torch.core.qubo import default_beta_range, random_qubo_batch, split_qubo
    from qbmx_torch.core.rng import draw_seed
    from qbmx_torch.samplers import (gibbs, gibbs_cuda, kernel_call, pt_cuda, pt_wide_cuda, sa_cuda,
                                     sa_torch, tempering, wide_cuda)
    from qbmx_torch.samplers import launches as launches_mod
    from qbmx_torch.samplers.api import densify_groups
    from qbmx_torch.samplers.exact import exact_boltzmann
    from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    dev = torch.device("cuda:0")
    t_all = time.perf_counter()
    clock = lambda phase: print(f"chip_smoke: phase {phase} starts at "
                                f"{time.perf_counter() - t_all:.1f} s")

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    print(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}) | nvcc: {nvcc} | count {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    _build.load_kernels()
    print(f"phase 2 build: {_build.info.seconds:.2f} s "
          f"({'compiled' if _build.info.built else 'cached'}) -> {_build.info.path}")

    # -- 3. kernel vs plain under host variates ------------------------------
    clock(3)
    rng = np.random.default_rng(2024)
    errs = {"sa_metropolis": [], "sa_heatbath": [], "pt_heatbath": [], "anneal_wide": [],
            "anneal_wide_sparse": [], "pt_wide": [], "pt_wide_sparse": []}
    fracs = {k: [] for k in errs}

    def record(kernel, frac_err):
        fracs[kernel].append(frac_err[0])
        errs[kernel].append(frac_err[1])

    SG = dict(G=2, B=60, n=6, R=1000, S=1000)
    Qg, h_extra, init01, u = structured_problem(rng, *SG.values(), dev)
    args, hv = (Qg, h_extra, SG["R"], SG["S"]), (init01, u)
    record("sa_metropolis", compare(sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv),
                                    sa_torch.sa_sample_groups_plain(*args, host_variates=hv),
                                    "K1 structured G=2 B=60 n=6 R=1000 S=1000"))
    record("sa_heatbath", compare(
        gibbs_cuda.gibbs_sample_groups_cuda(*args, pair=True, host_variates=hv),
        gibbs.gibbs_sample_groups_plain(*args, pair=True, host_variates=hv),
        "K2 pair structured G=2 B=60 n=6 R=1000 S=1000"))
    del hv, init01, u

    SD = dict(B=60, n=41, R=100, S=1000)
    Qd, init_d, u_d = dense_problem(rng, *SD.values(), dev)
    args, hv = (Qd, SD["R"], SD["S"]), (init_d, u_d)
    record("sa_metropolis", compare(sa_cuda.sa_sample_batch_cuda(*args, host_variates=hv),
                                    sa_torch.sa_sample_batch_plain(*args, host_variates=hv),
                                    "K1 dense B=60 n=41 R=100 S=1000"))
    for width in ("single", "quad"):
        record("sa_heatbath", compare(
            gibbs_cuda.gibbs_sample_batch_cuda(*args, **WIDTHS[width], host_variates=hv),
            gibbs.gibbs_sample_batch_plain(*args, **WIDTHS[width], host_variates=hv),
            f"K2 {width} dense B=60 n=41 R=100 S=1000"))
    del hv, init_d, u_d

    # the few-chain layout of K1 and K2 (a warp a chain) at the CDQBM (b)
    # call; the layout rule is the two kernels' one kernel_call.chain_layout
    # (the dense bench: 8 lanes a chain, single and quad 16)
    SB = dict(G=2, B=3, n=41, R=100, S=1000)
    layouts = {f"{label} width {w}": kernel_call.chain_layout(G, B, R, n, width=w).lanes
               for label, (G, B, R, n) in (
                   ("flagship", (2, 60, 1000, 6)), ("dense bench", (60, 1, 100, 41)),
                   ("CDQBM (b)", (SB["G"], SB["B"], SB["R"], SB["n"])))
               for w in (0, 1, 2, 4)}
    want = {**{f"flagship width {w}": 1 for w in (0, 1, 2, 4)},
            **{f"dense bench width {w}": 8 for w in (0, 2)},
            **{f"dense bench width {w}": 16 for w in (1, 4)},
            **{f"CDQBM (b) width {w}": 32 for w in (0, 1, 2, 4)}}
    check(layouts == want, f"K1/K2 layouts (lanes a chain) {layouts}, not {want}")
    Qcb, hcb, init_b, u_b = structured_problem(rng, *SB.values(), dev)
    args, hv = (Qcb, hcb, SB["R"], SB["S"]), (init_b, u_b)
    record("sa_metropolis", compare(sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv),
                                    sa_torch.sa_sample_groups_plain(*args, host_variates=hv),
                                    "K1 structured G=2 B=3 n=41 R=100 S=1000 (a warp a chain)"))
    record("sa_heatbath", compare(
        gibbs_cuda.gibbs_sample_groups_cuda(*args, pair=True, host_variates=hv),
        gibbs.gibbs_sample_groups_plain(*args, pair=True, host_variates=hv),
        "K2 pair structured G=2 B=3 n=41 R=100 S=1000 (a warp a chain)"))
    del hv, init_b, u_b
    # K1 and K2 pair past n = 8: every layout that holds the call, forced and
    # as the rule picks it, against plain; GROUP against LANES bit for bit
    chain_rec, pairs = chain_layouts_check(dev, np.random.default_rng(17))
    for kernel, frac_err in pairs:
        record(kernel, frac_err)

    Qpt = densify_groups(Qg, h_extra)  # (120, 6, 6): the PT slice's sampler input
    SP = dict(B=120, M=8, n=6, R=1000)
    BM = SP["B"] * SP["M"]
    # all reads at 100 sweeps, and the main path's 1000 sweeps (where K3's
    # running energies, E += ds·f, have the most updates to drift over) at
    # 100 reads: 2.3 GB of uniforms each
    for R, S in ((SP["R"], 100), (100, 1000)):
        hv = (bits(rng, (BM, R, SP["n"]), dev), uniforms(rng, (S, BM, SP["n"], R), dev),
              uniforms(rng, (S, BM, R), dev))
        record("pt_heatbath", compare(
            pt_cuda.pt_sample_batch_cuda(Qpt, R, S, num_replicas=SP["M"], host_variates=hv),
            tempering.pt_sample_batch_plain(Qpt, R, S, num_replicas=SP["M"], host_variates=hv),
            f"K3 densified B=120 n=6 M=8 R={R} S={S} (a rung a thread)"))
        del hv
    # K3 beyond the one-thread design's M·n ≤ 2048: a rung a warp at n = 241
    SPW = dict(B=4, M=12, n=241, R=32, S=20)  # M·n = 2,892; 30 MB of uniforms
    pt_layouts = {label: pt_cuda.pt_layout(*shape).route for label, shape in (
        ("flagship", (120, 8, 1000, 6)), ("CLI defaults", (146, 8, 100, 3)),
        ("n=241 M=12", (SPW["B"], SPW["M"], SPW["R"], SPW["n"])),
        *((label, (B, M, R, n)) for label, (B, M, R, n, _) in PT_TIMING_CALLS.items()))}
    want = {"flagship": "a rung a thread", "CLI defaults": "a rung a thread",
            "n=241 M=12": "a rung a warp", **PT_USER_ROUTES}
    check(pt_layouts == want, f"K3 layouts {pt_layouts}, not {want}")
    Qp3 = random_qubo_batch(rng, SPW["B"], SPW["n"]).to(dev)
    BM3, R3, S3, n3 = SPW["B"] * SPW["M"], SPW["R"], SPW["S"], SPW["n"]
    hv = (bits(rng, (BM3, R3, n3), dev), uniforms(rng, (S3, BM3, n3, R3), dev),
          uniforms(rng, (S3, BM3, R3), dev))
    record("pt_heatbath", compare(
        pt_cuda.pt_sample_batch_cuda(Qp3, R3, S3, num_replicas=SPW["M"], host_variates=hv),
        tempering.pt_sample_batch_plain(Qp3, R3, S3, num_replicas=SPW["M"], host_variates=hv),
        "K3 B=4 n=241 M=12 R=32 S=20 (M·n = 2892; a rung a warp)"))
    del hv
    # K3 past n = 8: every layout that takes each call, forced and as the rule
    # picks it, against plain; GROUP against WARP bit for bit
    pt_rec, pt_pairs = pt_layouts_check(dev, np.random.default_rng(19))
    for frac_err in pt_pairs:
        record("pt_heatbath", frac_err)

    # K4 at the CDQBM probabilistic-pooling shape: the K1/K2 wrappers route
    # n = 717 to it (kernel_call.fits_shared), which the counts confirm
    SW = dict(G=2, B=20, n=717, R=100, S=10)
    check(not kernel_call.fits_shared(SW["n"]), "n=717 should not fit shared memory")
    Qw, hw, init_w, u_w = structured_problem(rng, *SW.values(), dev)
    args, hv = (Qw, hw, SW["R"], SW["S"]), (init_w, u_w)
    for width, kern, plain in (
            ("Metropolis", lambda: sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv),
             lambda: sa_torch.sa_sample_groups_plain(*args, host_variates=hv)),
            ("pair", lambda: gibbs_cuda.gibbs_sample_groups_cuda(*args, pair=True, host_variates=hv),
             lambda: gibbs.gibbs_sample_groups_plain(*args, pair=True, host_variates=hv))):
        for c in (sa_cuda, gibbs_cuda, wide_cuda):
            c.reset_launch_counts()
        out = kern()
        torch.cuda.synchronize()
        check(wide_cuda.launch_counts["anneal_wide"] == 1
              and sa_cuda.launch_counts["sa_metropolis"] == 0
              and gibbs_cuda.launch_counts["sa_heatbath"] == 0,
              f"K4 {width}: n=717 was not served by K4 alone")
        record("anneal_wide", compare(out, plain(), f"K4 {width} structured G=2 B=20 n=717 "
                                                    "R=100 S=10"))
    del hv, init_w, u_w
    SWD = dict(B=32, n=717, R=100, S=10)
    Qwd, init_wd, u_wd = dense_problem(rng, *SWD.values(), dev)
    args, hv = (Qwd, SWD["R"], SWD["S"]), (init_wd, u_wd)
    wide_cuda.reset_launch_counts()
    record("anneal_wide", compare(sa_cuda.sa_sample_batch_cuda(*args, host_variates=hv),
                                  sa_torch.sa_sample_batch_plain(*args, host_variates=hv),
                                  "K4 Metropolis dense B=32 n=717 R=100 S=10"))
    record("anneal_wide", compare(gibbs_cuda.gibbs_sample_batch_cuda(*args, pair=True,
                                                                     host_variates=hv),
                                  gibbs.gibbs_sample_batch_plain(*args, pair=True,
                                                                 host_variates=hv),
                                  "K4 pair dense B=32 n=717 R=100 S=10"))
    check(wide_cuda.launch_counts["anneal_wide"] == 2, "K4 dense: not launched by the wrappers")
    del hv, init_wd, u_wd
    # K4's shared layout at the widest n the rule gives it (31 chains a block)
    SX = dict(G=1, B=1, n=wide_cuda.switch_n(), R=200, S=2)
    Qx, hx, init_x, u_x = structured_problem(rng, *SX.values(), dev)
    args, hv = (Qx, hx, SX["R"], SX["S"]), (init_x, u_x)
    record("anneal_wide", compare(sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv),
                                  sa_torch.sa_sample_groups_plain(*args, host_variates=hv),
                                  f"K4 Metropolis structured at its widest shared n={SX['n']} R=200 S=2"))
    record("anneal_wide", compare(
        gibbs_cuda.gibbs_sample_groups_cuda(*args, pair=True, host_variates=hv),
        gibbs.gibbs_sample_groups_plain(*args, pair=True, host_variates=hv),
        f"K4 pair structured at its widest shared n={SX['n']} R=200 S=2"))
    del Qx, hx, hv, init_x, u_x
    # K4's dense shared path at the call that launches it on the main path
    Qu, hu, frac_errs = dense_h300_check(dev)
    for frac_err in frac_errs:
        record("anneal_wide", frac_err)
    # K5 at the shapes K3 cannot hold (pt_wide_cuda.pt_route), through the
    # sampler's structured entry, against the plain version on the densified
    # batch; the launch counts show K5 alone served each.  The first three
    # shapes place one ladder a block; the main path's CDQBM (a) PT call
    # places four (pt_wide_geometry), so the ladders of a block share its
    # energies there
    SK5 = {"n=300": dict(G=2, B=4, n=300, M=8, R=16, S=20),
           "n=717": dict(G=2, B=2, n=717, M=8, R=8, S=10),
           "n=241 M=16": dict(G=1, B=4, n=241, M=16, R=16, S=20),
           "CDQBM (a) PT": dict(G=2, B=20, n=717, M=8, R=100, S=10)}  # 0.9 GB of uniforms
    k5_problems, k5_ladders = {}, {}
    for label, (G, B, n, M, R, S) in ((k, tuple(v.values())) for k, v in SK5.items()):
        check(pt_wide_cuda.pt_route(G, B, M, R, n) == "pt_wide", f"K5 {label}: not routed to K5")
        k5_ladders[label] = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n).ladders_per_block
        Qk = random_qubo_batch(rng, G, n).to(dev)
        hk = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        k5_problems[label] = (Qk, hk)
        GBM = G * B * M
        hv = (bits(rng, (GBM, R, n), dev), uniforms(rng, (S, GBM, n, R), dev),
              uniforms(rng, (S, GBM, R), dev))
        pt_cuda.reset_launch_counts()
        pt_wide_cuda.reset_launch_counts()
        out = pt_wide_cuda.pt_sample_groups(Qk, hk, R, S, num_replicas=M, host_variates=hv)
        torch.cuda.synchronize()
        check(pt_wide_cuda.launch_counts["pt_wide"] == 1
              and pt_cuda.launch_counts["pt_heatbath"] == 0, f"K5 {label}: not served by K5 alone")
        want = tempering.pt_sample_batch_plain(densify_groups(Qk, hk), R, S, num_replicas=M,
                                               host_variates=hv).reshape(G, B, R, n)
        record("pt_wide", compare(out, want, f"K5 structured G={G} B={B} n={n} M={M} R={R} "
                                             f"S={S} ({label}; {k5_ladders[label]} ladders a "
                                             "block)"))
        del hv, out, want
    check(k5_ladders == {"n=300": 1, "n=717": 1, "n=241 M=16": 1, "CDQBM (a) PT": 4},
          f"K5 ladders a block {k5_ladders}")
    # K5's ladders are the plain version's, bit for bit, on the card too
    for label, (Qk, hk) in k5_problems.items():
        M = SK5[label]["M"]
        _, _, bk, dk = pt_wide_cuda.structured_form(Qk, hk, M)
        want_b, want_d = tempering.ladder_betas(densify_groups(Qk, hk), M)
        check(torch.equal(bk, want_b) and torch.equal(dk, want_d),
              f"K5 {label}: its ladders are not the plain version's bit for bit")
    print(f"phase 3 K5 ladders a block {k5_ladders}; the ladder betas equal "
          "tempering.ladder_betas on the densified batch bit for bit at each shape")
    # a block's spare ladders (B·R no multiple of its ladders L) run only
    # with a geometry forced past the rule: L=3 at the n=300 problems puts
    # ladder 63 of each group beside two spares
    G, B, n, M, R, S = SK5["n=300"].values()
    Qk, hk = k5_problems["n=300"]
    check(B * R % 3 != 0, "K5 forced geometry: no spare ladder")
    GBM = G * B * M
    hv = (bits(rng, (GBM, R, n), dev), uniforms(rng, (S, GBM, n, R), dev),
          uniforms(rng, (S, GBM, R), dev))
    out = pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Qk, hk, M), R, S, host_variates=hv,
                              geometry=pt_wide_cuda.PTWideGeometry.of(G, B, M, R, n, 3))
    want = tempering.pt_sample_batch_plain(densify_groups(Qk, hk), R, S, num_replicas=M,
                                           host_variates=hv).reshape(G, B, R, n)
    record("pt_wide", compare(out, want, f"K5 G={G} B={B} n={n} M={M} R={R} S={S}, 3 ladders "
                                         "a block forced (spare ladders)"))
    del hv, out, want
    # K5's dense path at phase 5's flat PT step (qbm_main --solver PT -hn
    # 300) on the step's own QUBOs (DiscQBM.step_qubos: J_g dense at n =
    # 301), with the geometry the step gets; S cut from 100 to 20
    from qbmx_torch.models.dqbm import DiscQBM

    frng = np.random.default_rng(301)
    G, B, M, R, S = 2, 60, 8, 16, 20
    flat_pt = DiscQBM(dim_input=784, n_hidden_nodes=300, seed=19, solver="PT",
                      sample_count=R, anneal_steps=S, device=dev)
    xf = torch.as_tensor(frng.random((B, 784), dtype=np.float32), device=dev)
    yf = (torch.arange(B, device=dev) % 2).to(torch.float32)[:, None]
    Qf, hf = flat_pt.step_qubos(flat_pt.params, xf, yf)
    n = Qf.shape[-1]
    geo_f = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(max(
        pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Qf)[1])))))
    check(n == 301 and geo_f.path == pt_wide_cuda.DENSE and geo_f.ladders_per_block == 4
          and geo_f.cluster == 1 and geo_f.grid == (240, 2), f"K5 flat PT H=300: n={n}, {geo_f}")
    hv = pt_hv(frng, G * B * M, R, n, S, dev)
    pt_cuda.reset_launch_counts()
    pt_wide_cuda.reset_launch_counts()
    out = pt_wide_cuda.pt_sample_groups(Qf, hf, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    check(pt_wide_cuda.launch_counts == {"pt_wide": 1, "pt_wide_sparse": 0,
                                         "pt_wide_global": 0, "pt_wide_global_sparse": 0}
          and pt_cuda.launch_counts["pt_heatbath"] == 0,
          f"K5 flat PT H=300: not served by the dense path alone ({pt_wide_cuda.launch_counts})")
    want = tempering.pt_sample_batch_plain(densify_groups(Qf, hf), R, S, num_replicas=M,
                                           host_variates=hv).reshape(G, B, R, n)
    record("pt_wide", compare(out, want, f"K5 dense G={G} B={B} n={n} M={M} R={R} S={S} "
                                         "(qbm_main --solver PT -hn 300, the step's QUBOs; "
                                         f"{geo_f.ladders_per_block} ladders a block on a grid "
                                         f"of {geo_f.grid})"))
    # its time at the step's own depth (S=100) through the sampler's entry,
    # beside the plain version's at S=20 and the bound of the S=100 call
    gf = gen_of(301)
    k5_h300 = {"G": G, "B": B, "M": M, "R": R, "n": n, "S": 100, "plain_S": S,
               "ms": cuda_ms(lambda: pt_wide_cuda.pt_sample_groups(Qf, hf, R, 100, num_replicas=M,
                                                                   generator=gf), runs=3),
               "plain_ms_at_plain_S": cuda_ms(lambda: tempering.pt_sample_batch_plain(
                   densify_groups(Qf, hf), R, S, num_replicas=M, host_variates=hv), runs=1)}
    flips_f = torch.zeros(2, dtype=torch.int64, device=dev)
    pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Qf, hf, M), R, 100, generator=gf,
                        flips=flips_f)
    k5_h300.update(anneal_bound(G, B, R, n, 100, rungs=M, flip_work=int(flips_f[1].item())))
    print(f"phase 3 time K5 dense at qbm_main --solver PT -hn 300's call (G={G} B={B} n={n} M={M} "
          f"R={R} S=100, the step's QUBOs, the sampler's entry): kernel {k5_h300['ms']:.3f} ms "
          f"(CUDA events, median of 3), plain {k5_h300['plain_ms_at_plain_S']:.3f} ms at S={S} "
          f"(one run after a warm-up), bound {k5_h300['bound_ms']:.4f} ms by "
          f"{k5_h300['bound_by']}; {smi}")
    del hv, out, want, flat_pt, Qf, hf
    # K5's sparse path: the CDQBM (a) PT call on the step's own QUBOs (J_g
    # 98% zeros: its row lists fit a block beside 32 rungs), through the
    # sampler's structured entry, against the plain version
    Qs, hs = cdqbm_a_qubos(20, dev)
    nnz_s = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Qs)[1]))
    G, B, n, M, R, S = 2, 20, 717, 8, 100, 10
    geo_s = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(max(nnz_s)))
    check(geo_s.path == pt_wide_cuda.SPARSE and geo_s.ladders_per_block == 4,
          f"K5 CDQBM (a) PT: {geo_s}")
    hv = pt_hv(rng, G * B * M, R, n, S, dev)
    pt_cuda.reset_launch_counts()
    pt_wide_cuda.reset_launch_counts()
    out = pt_wide_cuda.pt_sample_groups(Qs, hs, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    check(pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 1,
                                         "pt_wide_global": 0, "pt_wide_global_sparse": 0}
          and pt_cuda.launch_counts["pt_heatbath"] == 0,
          "K5 CDQBM (a) PT: not served by the sparse path alone")
    want = tempering.pt_sample_batch_plain(densify_groups(Qs, hs), R, S, num_replicas=M,
                                           host_variates=hv).reshape(G, B, R, n)
    record("pt_wide_sparse", compare(out, want, f"K5 sparse G={G} B={B} n={n} M={M} R={R} S={S} "
                                                f"(CDQBM (a) PT, the step's QUBOs: {nnz_s} "
                                                "nonzeros; 4 ladders a block)"))
    del hv, out, want
    # ladders over a thread block cluster, on both paths: past K3's 64 rungs
    # at n = 4, and 40 rungs at n = 717 (two blocks of 20)
    SCL = {"M=65 n=4": (1, 2, 4, 65, 16, 20, None, pt_wide_cuda.SPARSE),
           "M=40 n=717 CDQBM (a)": (2, 4, 717, 40, 8, 10, (Qs, hs[:, :4]), pt_wide_cuda.SPARSE),
           "M=40 n=717": (1, 4, 717, 40, 8, 10, None, pt_wide_cuda.DENSE)}
    clusters = {}
    for label, (G, B, n, M, R, S, qh, path) in SCL.items():
        Qk, hk = qh or (random_qubo_batch(rng, G, n).to(dev),
                        torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32),
                                        device=dev))
        check(pt_wide_cuda.pt_route(G, B, M, R, n) == "pt_wide", f"K5 {label}: not routed to K5")
        hv = pt_hv(rng, G * B * M, R, n, S, dev)
        pt_wide_cuda.reset_launch_counts()
        out = pt_wide_cuda.pt_sample_groups(Qk, hk, R, S, num_replicas=M, host_variates=hv)
        torch.cuda.synchronize()
        kernel = "pt_wide_sparse" if path == pt_wide_cuda.SPARSE else "pt_wide"
        check(pt_wide_cuda.launch_counts[kernel] == 1 and sum(pt_wide_cuda.launch_counts.values())
              == 1, f"K5 {label}: not served by the {path} path")
        Jk = split_qubo(Qk)[1]
        geo = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(
            max(pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(Jk)))))
        check(geo.path == path and geo.cluster > 1, f"K5 {label}: {geo}")
        clusters[label] = (geo.cluster, geo.warps)
        want = tempering.pt_sample_batch_plain(densify_groups(Qk, hk), R, S, num_replicas=M,
                                               host_variates=hv).reshape(G, B, R, n)
        record(kernel, compare(out, want, f"K5 {path} G={G} B={B} n={n} M={M} R={R} S={S}, a "
                                          f"ladder over a cluster of {geo.cluster} blocks of "
                                          f"{geo.warps} warps ({label})"))
        del hv, out, want
    # both paths forced on the CDQBM (a) PT call's QUBOs, past the refresh at
    # sweep 64: the same samples, states, fields, energies and counters
    G, B, n, M, R, S = 2, 20, 717, 8, 100, 70
    form = pt_wide_cuda.structured_form(Qs, hs, M)
    paths = {}
    for path in (pt_wide_cuda.DENSE, pt_wide_cuda.SPARSE):
        outs = dict(states_out=torch.empty((G * B * M, R, n), device=dev),
                    fields_out=torch.empty((G * B * M, R, n), device=dev),
                    energy_out=torch.empty((G * B * M, R), device=dev),
                    flips=torch.zeros(2, dtype=torch.int64, device=dev))
        out = pt_wide_cuda.launch(*form, R, S, path=path, generator=gen_of(12), **outs)
        paths[path] = dict(out=out, **outs)
    torch.cuda.synchronize()
    unequal = [k for k, v in paths[pt_wide_cuda.DENSE].items()
               if not torch.equal(v, paths[pt_wide_cuda.SPARSE][k])]
    check(not unequal, f"K5 paths forced on the CDQBM (a) PT call at S={S}: {unequal} differ")
    equal_flips = paths[pt_wide_cuda.SPARSE]["flips"].tolist()
    # how many clusters of 8 blocks (the largest the rule asks for) of 32
    # warps the card holds at once at n = 717, on each path (0: refused)
    lib = _build.load_kernels()
    active = {path: lib.qbmx_pt_wide_max_active_clusters(
        717, 32 * pt_wide_cuda.MAX_CLUSTER, pt_wide_cuda.MAX_CLUSTER,
        geo_s.nnz_pad if path == pt_wide_cuda.SPARSE else 0)
        for path in (pt_wide_cuda.DENSE, pt_wide_cuda.SPARSE)}
    check(min(active.values()) >= 1, f"K5: a cluster of 8 blocks does not fit the card: {active}")
    print(f"phase 3 K5 paths at G={G} B={B} n={n} M={M} R={R} S={S} (the step's QUBOs, both "
          f"forced): samples, states, fields, energies and counters {equal_flips} equal bit for "
          f"bit; clusters (blocks, warps a block) {clusters}; clusters of 8 32-warp blocks the "
          f"card holds at once at n=717 (cudaOccupancyMaxActiveClusters) {active}")
    del paths, form
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 4. Philox path vs the exact oracle -----------------------------------
    clock(4)
    # the problems and bound of tests/test_samplers.py::test_marginals_match_oracle
    # (annealing ends frozen at the cold beta, so on some random problems
    # SA's marginals sit further from the oracle's, on every implementation)
    worst = 0.0
    for n in (2, 5, 8):
        Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
        s = sa_cuda.sa_sample_batch_cuda(Q, 512, 200, generator=torch.Generator().manual_seed(n))
        check(tuple(s.shape) == (1, 512, n), f"oracle n={n}: shape {tuple(s.shape)}")
        _, cold = default_beta_range(Q[0])
        _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
        err = (s[0].mean(0) - marg).abs().max().item()
        worst = max(worst, err)
        check(err <= ORACLE_ATOL, f"oracle n={n}: marginals off by {err:.4f}")
    # K1 at each layout forced on the same problems; at n = 12 (THREAD past
    # n = 8) a schedule that ends at beta 1, where the chains still mix (the
    # default one freezes SA short of the oracle at n = 12 on every
    # implementation), against the oracle at beta 1
    k1_oracle = {}
    for n in (2, 5, 8, 12):
        Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
        J, h, hot, logr = structured_form(Q, torch.zeros((1, 1, n), device=dev), 200)
        cold = float(default_beta_range(Q[0])[1]) if n < 12 else 1.0
        if n >= 12:
            hot, logr = sa_torch.schedule_params(h, J[:, None], 200, 0.1, 1.0)
        _, _, marg, _ = exact_boltzmann(Q[0], beta=cold)
        for lanes in k1k2_layouts(n, 0):
            s = sa_cuda.launch(J, h, hot, logr, 512, 200, lanes=lanes, generator=gen_of(n))[0, 0]
            k1_oracle[f"n={n} lanes {lanes}"] = err = (s.mean(0) - marg).abs().max().item()
            check(err <= ORACLE_ATOL, f"K1 oracle n={n} at {lanes} lanes a chain: marginals "
                                      f"off by {err:.4f}")
    # K2 and K3 at beta 1 (tests/test_gibbs_pt_pallas_debug.py's problems),
    # each layout forced: K2 a thread or a warp a chain, K3 a rung a thread
    # or a rung a warp
    oracle = {}
    for width in WIDTHS:
        for n in (6, 12):  # n = 12: THREAD past n = 8, the same draw of couplings, 4x the reads
            seed, reads, sweeps, bar = (9, 384, 48, HB_ATOL) if width == "single" else \
                (11, 2048, 64, JOINT_ATOL)
            reads *= 1 if n == 6 else 4
            Q = torch.as_tensor(np.triu(np.random.default_rng(seed).uniform(-1, 1, (1, n, n)))
                                .astype(np.float32), device=dev)
            form = structured_form(Q, torch.zeros((1, 1, n), device=dev), sweeps,
                                   WIDTH_OF[width])
            for lanes in k1k2_layouts(n, WIDTH_OF[width]):
                s = gibbs_cuda.launch(*form, reads, sweeps, WIDTH_OF[width], lanes=lanes,
                                      generator=torch.Generator().manual_seed(4))[0, 0]
                err, moment = oracle_error(s, Q[0], joint=width != "single")
                oracle[f"K2 {width} n={n} lanes {lanes}"] = (err, moment)
                check(err <= bar and moment <= MOMENT_ATOL, f"K2 {width} oracle n={n} at {lanes} "
                      f"lanes a chain: marginals off by {err:.4f}, moments by {moment:.4f}")
    # K3 at each layout: n = 5 (tests/test_gibbs_pt_pallas_debug.py's problem),
    # and n = 12 (a rung a thread past n = 8) on 1024 reads
    for n, reads in ((5, 384), (12, 1024)):
        Q = torch.as_tensor(np.triu(np.random.default_rng(3).uniform(-1.5, 1.5, (1, n, n)))
                            .astype(np.float32), device=dev)
        for layout in pt_cuda.LAYOUTS:
            if n > pt_cuda.max_n(layout):
                continue
            name = f"{pt_cuda.pt_layout(1, 4, reads, n, layout).route} n={n}"
            s = pt_cuda.pt_sample_batch_cuda(Q, reads, 24, num_replicas=4, _layout=layout,
                                             generator=torch.Generator().manual_seed(0))[0]
            oracle[f"K3 {name}"] = oracle_error(s, Q[0], joint=False)
            check(oracle[f"K3 {name}"][0] <= HB_ATOL,
                  f"K3 oracle, {name}: marginals off by {oracle[f'K3 {name}'][0]:.4f}")
    # weak couplings and a mild schedule keep the samples diffuse, so equal
    # samples can only come from equal streams
    Qa = random_qubo_batch(rng, 3, 6, scale=0.2).to(dev)
    Qb = Qa.clone()
    Qb[1:] = random_qubo_batch(rng, 2, 6, scale=0.2).to(dev)
    zeros = torch.zeros((3, 1, 6), device=dev)
    gen = gen_of
    runs = {
        "K1": lambda Q, seed: sa_cuda.sa_sample_groups_cuda(
            Q, zeros, 64, 50, generator=gen(seed), beta_hot=0.5, beta_cold=1.0)[:, 0],
        "K2": lambda Q, seed: gibbs_cuda.gibbs_sample_batch_cuda(
            Q, 64, 20, pair=True, beta=0.5, generator=gen(seed)),
        "K3": lambda Q, seed: pt_cuda.pt_sample_batch_cuda(
            Q, 64, 10, num_replicas=4, beta_target=0.5, generator=gen(seed)),
    }
    distinct = {}
    for name, run in runs.items():
        sa, sb, sc = run(Qa, 7), run(Qb, 7), run(Qa, 8)
        distinct[name] = len({tuple(r) for r in sa[0].cpu().tolist()})
        check(distinct[name] > 5, f"{name}: chains look like copies: {distinct[name]} "
              "distinct states of 64")
        check(torch.equal(sa[0], sb[0]), f"{name}: problem 0's samples changed with its "
              "batch-mates")
        check(not torch.equal(sa[0], sc[0]), f"{name}: another seed gave the same samples")
    # the kernels' own draws, written out on the host, drive the plain
    # versions to the kernels' samples (flagship widths, 100 sweeps; K3 20)
    G, B, n, R, S = 2, 60, 6, 1000, 100
    seed = draw_seed(gen(5))
    hv = tuple(torch.as_tensor(a, device=dev)
               for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    k_out = sa_cuda.sa_sample_groups_cuda(Qg, h_extra, R, S, generator=gen(5))
    p_out = sa_torch.sa_sample_groups_plain(Qg, h_extra, R, S, host_variates=hv)
    philox = {"K1": differing(k_out, p_out)}
    for width in WIDTHS:  # K2 draws K1's streams: the same seed, the same arrays
        k_out = gibbs_cuda.gibbs_sample_groups_cuda(Qg, h_extra, R, S, **WIDTHS[width],
                                                    generator=gen(5))
        p_out = gibbs.gibbs_sample_groups_plain(Qg, h_extra, R, S, **WIDTHS[width],
                                                host_variates=hv)
        philox[f"K2 {width}"] = differing(k_out, p_out)
        k_out = gibbs_cuda.launch(*structured_form(Qg, h_extra, S, WIDTH_OF[width]), R, S,
                                  WIDTH_OF[width], lanes=32, generator=gen(5))
        philox[f"K2 {width} a warp a chain"] = differing(k_out, p_out)
    del hv
    # every layout of K1 and K2 forced on its own draws, at the flagship
    # widths (n = 6) and at n = THREAD_MAX_N (THREAD past n = 8; G=2 B=20
    # R=100 S=20)
    Qt, ht, _, _ = structured_problem(rng, 2, 20, kernel_call.THREAD_MAX_N, 1, 1, dev)
    for (Qp, hp, Rp, Sp) in ((Qg, h_extra, R, S), (Qt, ht, 100, 20)):
        Gp, Bp, n_p = hp.shape
        seed = draw_seed(gen(8))
        hv = tuple(torch.as_tensor(a, device=dev)
                   for a in sa_torch.philox_variates(seed, Gp, Bp, Rp, n_p, Sp))
        for width in ("Metropolis", *WIDTHS):
            w = 0 if width == "Metropolis" else WIDTH_OF[width]
            p_out = (sa_torch.sa_sample_groups_plain(Qp, hp, Rp, Sp, host_variates=hv) if w == 0
                     else gibbs.gibbs_sample_groups_plain(Qp, hp, Rp, Sp, **WIDTHS[width],
                                                          host_variates=hv))
            form = structured_form(Qp, hp, Sp, w)
            for lanes in k1k2_layouts(n_p, w):
                k_out = k1k2_launch(w, form, Rp, Sp, lanes=lanes, generator=gen(8))
                philox[f"{'K1' if w == 0 else 'K2 ' + width} n={n_p} lanes {lanes}"] = \
                    differing(k_out, p_out)
        del hv
    # K3 at each layout on its own draws: the flagship PT call (n = 6) and the
    # flat PT h8 call (n = 9) at 100 reads
    S_pt = 20
    Qh8 = random_qubo_batch(rng, SP["B"], 9).to(dev)
    for Qp, Rp in ((Qpt, SP["R"]), (Qh8, 100)):
        n_p = Qp.shape[-1]
        seed = draw_seed(gen(6))
        hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
            seed, SP["B"], SP["M"], Rp, n_p, S_pt))
        p_out = tempering.pt_sample_batch_plain(Qp, Rp, S_pt, num_replicas=SP["M"],
                                                host_variates=hv)
        philox[f"K3 n={n_p}"] = differing(pt_cuda.pt_sample_batch_cuda(
            Qp, Rp, S_pt, num_replicas=SP["M"], generator=gen(6)), p_out)
        for layout in pt_cuda.LAYOUTS:
            route = pt_cuda.pt_layout(SP["B"], SP["M"], Rp, n_p, layout).route
            k_out = pt_cuda.pt_sample_batch_cuda(Qp, Rp, S_pt, num_replicas=SP["M"],
                                                 generator=gen(6), _layout=layout)
            philox[f"K3 n={n_p} {route}"] = differing(k_out, p_out)
        del hv, k_out, p_out
    S_w = 3
    seed = draw_seed(gen(7))
    hv = tuple(torch.as_tensor(a, device=dev)
               for a in sa_torch.philox_variates(seed, SW["G"], SW["B"], SW["R"], SW["n"], S_w))
    k_out = sa_cuda.sa_sample_groups_cuda(Qw, hw, SW["R"], S_w, generator=gen(7))
    p_out = sa_torch.sa_sample_groups_plain(Qw, hw, SW["R"], S_w, host_variates=hv)
    philox["K4"] = differing(k_out, p_out)
    k_out = gibbs_cuda.gibbs_sample_groups_cuda(Qw, hw, SW["R"], S_w, pair=True, generator=gen(7))
    p_out = gibbs.gibbs_sample_groups_plain(Qw, hw, SW["R"], S_w, pair=True, host_variates=hv)
    philox["K4 pair"] = differing(k_out, p_out)
    del hv, k_out, p_out

    def forced_wide(Q, R, S, rule, seed):
        """K4 launched directly on a dense batch, past the routing."""
        form = structured_form(Q, torch.zeros((Q.shape[0], 1, Q.shape[-1]), device=dev), S, rule)
        return wide_cuda.launch(*form, R, S, rule, generator=gen(seed))[:, 0]

    worst_wide = {"Metropolis": 0.0, "pair": 0.0, "pair moments": 0.0}
    for n in (2, 5, 8):
        Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
        s = forced_wide(Q, 512, 200, wide_cuda.METROPOLIS, n)
        _, cold = default_beta_range(Q[0])
        _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
        worst_wide["Metropolis"] = max(worst_wide["Metropolis"],
                                       (s[0].mean(0) - marg).abs().max().item())
        Q = torch.as_tensor(np.triu(np.random.default_rng(11).uniform(-1, 1, (1, n, n)))
                            .astype(np.float32), device=dev)
        err, moment = oracle_error(forced_wide(Q, 2048, 64, wide_cuda.PAIR, 4)[0], Q[0], joint=True)
        worst_wide["pair"] = max(worst_wide["pair"], err)
        worst_wide["pair moments"] = max(worst_wide["pair moments"], moment)
    check(worst_wide["Metropolis"] <= ORACLE_ATOL and worst_wide["pair"] <= JOINT_ATOL
          and worst_wide["pair moments"] <= MOMENT_ATOL,
          f"K4 forced oracle: worst errors {worst_wide}")
    # K5 launched directly (past the routing) against the exact oracle at
    # beta 1: K3's problems and bar; then on its own Philox draws, written
    # out on the host, at the phase-3 n=300 shape
    worst_k5 = {pt_wide_cuda.DENSE: 0.0, pt_wide_cuda.SPARSE: 0.0}
    for n in (2, 5, 8):
        Q = torch.as_tensor(np.triu(np.random.default_rng(3).uniform(-1.5, 1.5, (1, n, n)))
                            .astype(np.float32), device=dev)
        form = pt_wide_cuda.structured_form(Q, torch.zeros((1, 1, n), device=dev), 4)
        for path in worst_k5:
            s = pt_wide_cuda.launch(*form, 384, 24, path=path, generator=gen(0))[0, 0]
            worst_k5[path] = max(worst_k5[path], oracle_error(s, Q[0], joint=False)[0])
    for path, err in worst_k5.items():
        oracle[f"K5 {path} forced"] = (err, 0.0)
    check(max(worst_k5.values()) <= HB_ATOL, f"K5 forced oracle: marginals off by {worst_k5}")
    G, B, n, M, R, S = SK5["n=300"].values()
    Qk, hk = k5_problems["n=300"]
    seed = draw_seed(gen(10))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
        seed, G * B, M, R, n, S, var_shift=pt_wide_cuda.VAR_SHIFT))
    k_out = pt_wide_cuda.pt_sample_groups(Qk, hk, R, S, num_replicas=M, generator=gen(10))
    p_out = tempering.pt_sample_batch_plain(densify_groups(Qk, hk), R, S, num_replicas=M,
                                            host_variates=hv)
    philox["K5"] = differing(k_out, p_out.reshape(G, B, R, n))
    # the sparse path on its own draws, at the CDQBM (a) PT call's QUBOs
    G, B, n, M, R, S = 2, 4, 717, 8, 16, 6
    seed = draw_seed(gen(13))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
        seed, G * B, M, R, n, S, var_shift=pt_wide_cuda.VAR_SHIFT))
    pt_wide_cuda.reset_launch_counts()
    k_out = pt_wide_cuda.pt_sample_groups(Qs, hs[:, :B], R, S, num_replicas=M, generator=gen(13))
    check(pt_wide_cuda.launch_counts["pt_wide_sparse"] == 1, "K5 sparse Philox: not launched")
    p_out = tempering.pt_sample_batch_plain(densify_groups(Qs, hs[:, :B]), R, S, num_replicas=M,
                                            host_variates=hv)
    philox["K5 sparse"] = differing(k_out, p_out.reshape(G, B, R, n))
    del hv, k_out, p_out
    for name, frac in philox.items():
        check(frac <= MAX_DIFF_FRAC, f"Philox mode {name}: {frac:.4%} of chains differ from "
              "the plain version on the kernel's own draws")
    # K4's incremental fields at the main path's depth (CDQBM (a), S=1000),
    # every rule, against h + J·s recomputed in float64, within the limit
    # of the adds since the last refresh (wide_cuda.field_drift_bound); then
    # chain (0, 0, 0)'s fields each one add of their row's median |J_jk|
    # short must all fail it
    drift_max, drift_ratio, planted_ratio = {}, {}, math.inf
    for rule_name, rule in (("Metropolis", wide_cuda.METROPOLIS), ("single", wide_cuda.HEATBATH),
                            ("pair", wide_cuda.PAIR), ("quad", wide_cuda.QUAD)):
        Jw, hw_eff, hot_w, logr_w = structured_form(Qw, hw, 1000, rule)
        fields = torch.empty((SW["G"], SW["B"], SW["R"], SW["n"]), device=dev)
        flips_w = torch.zeros(2, dtype=torch.int64, device=dev)
        s_w = wide_cuda.launch(Jw, hw_eff, hot_w, logr_w, SW["R"], 1000, rule,
                               generator=gen(8), fields_out=fields, flips=flips_w)
        exact = hw_eff.double()[:, :, None] + torch.einsum("gbrj,gij->gbri", s_w.double(),
                                                          Jw.double())
        drift = (fields.double() - exact).abs()
        bound = wide_cuda.field_drift_bound(hw_eff, Jw, 1000)
        drift_max[rule_name] = drift.max().item()
        drift_ratio[rule_name] = (drift / bound).max().item()
        check(bool(torch.isfinite(fields).all()) and drift_ratio[rule_name] <= 1.0,
              f"K4 {rule_name} field drift at S=1000: max {drift_max[rule_name]:.3e}, "
              f"{drift_ratio[rule_name]:.3e} of its limit")
        if rule == wide_cuda.METROPOLIS:
            flips_full = [int(v) for v in flips_w.tolist()]
            typical = Jw[0].abs().masked_fill(Jw[0] == 0, math.nan).nanmedian(dim=1).values
            lost = fields[0, 0, 0].double() - typical.double()
            planted_ratio = ((lost - exact[0, 0, 0]).abs() / bound[0, 0, 0]).min().item()
            check(planted_ratio > 1.0, f"K4 field drift check: a field one add short reads "
                  f"only {planted_ratio:.3f} of the limit")
        del fields, exact, drift, bound, s_w
    # K2's incremental fields (GROUP and LANES, each forced) after the main
    # path's S=1000 at the CDQBM (b) call, every width, against h + J·s in
    # float64, within the limit of the adds since its last refresh (every
    # 16th sweep); the planted fault as for K4
    k2_drift_ratio, k2_planted = {}, math.inf
    for width in WIDTHS:
        Jb, hb_eff, hot_b, logr_b = structured_form(Qcb, hcb, 1000, WIDTH_OF[width])
        for lanes in [L for L in k1k2_layouts(SB["n"], WIDTH_OF[width]) if L > 1]:
            fields = torch.empty((SB["G"], SB["B"], SB["R"], SB["n"]), device=dev)
            s_b = gibbs_cuda.launch(Jb, hb_eff, hot_b, logr_b, SB["R"], 1000, WIDTH_OF[width],
                                    generator=gen(9), fields_out=fields, lanes=lanes)
            exact = hb_eff.double()[:, :, None] + torch.einsum("gbrj,gij->gbri", s_b.double(),
                                                               Jb.double())
            bound = wide_cuda.field_drift_bound(hb_eff, Jb, 1000, gibbs_cuda.REFRESH_PERIOD)
            drift = (fields.double() - exact).abs()
            key = f"{width} lanes {lanes}"
            k2_drift_ratio[key] = (drift / bound).max().item()
            check(bool(torch.isfinite(fields).all()) and k2_drift_ratio[key] <= 1.0,
                  f"K2 {key} field drift at S=1000: {k2_drift_ratio[key]:.3e} of its limit")
            typical = Jb[0].abs().masked_fill(Jb[0] == 0, math.nan).nanmedian(dim=1).values
            lost = fields[0, 0, 0].double() - typical.double()
            k2_planted = min(k2_planted,
                             ((lost - exact[0, 0, 0]).abs() / bound[0, 0, 0]).min().item())
            del fields, exact, drift, bound, s_b
    check(k2_planted > 1.0, f"K2 field drift check: a field one add short reads only "
          f"{k2_planted:.3f} of the limit")
    # K5's fields and energies after the main path's S=1000 at the CDQBM (a)
    # PT call's shape (G=2 B=20 M=8 R=100 n=717, the K4 check's problem),
    # every rung's, against h + J·s and h·s + ½ sᵀJs in float64, within
    # field_drift_bound and energy_drift_bound; then one chain's fields each
    # one median |J_jk| short, and its energy one flip's median |f_i| short,
    # must fail them
    # the dense path on the random QUBOs of the K4 check, the sparse path on
    # the step's own QUBOs (rows without nonzeros take no add to lose)
    G, B, M, R, n = SW["G"], SW["B"], 8, SW["R"], SW["n"]
    k5_drift, k5_planted, k5_flips_full = {}, {}, {}
    for path, (Qd5, hd5) in ((pt_wide_cuda.DENSE, (Qw, hw)), (pt_wide_cuda.SPARSE, (Qs, hs))):
        Jk, hk5, bk, dk = pt_wide_cuda.structured_form(Qd5, hd5, M)
        states = torch.empty((G * B * M, R, n), device=dev)
        fields = torch.empty_like(states)
        energy = torch.empty((G * B * M, R), device=dev)
        flips_k5 = torch.zeros(2, dtype=torch.int64, device=dev)
        pt_wide_cuda.launch(Jk, hk5, bk, dk, R, 1000, generator=gen(11), states_out=states,
                            fields_out=fields, energy_out=energy, flips=flips_k5, path=path)
        s64 = states.double().reshape(G, B, M, R, n)
        exact_f = hk5.double()[:, :, None, None] + torch.einsum("gbmrj,gij->gbmri", s64,
                                                                Jk.double())
        exact_e = 0.5 * (s64 * (hk5.double()[:, :, None, None] + exact_f)).sum(-1)
        fb = wide_cuda.field_drift_bound(hk5, Jk, 1000)[:, :, None]  # (G, B, 1, 1, n)
        eb = pt_wide_cuda.energy_drift_bound(hk5, Jk, 1000)  # (G, B, 1, 1)
        f64, e64 = fields.double().reshape(G, B, M, R, n), energy.double().reshape(G, B, M, R)
        drift = (f64 - exact_f).abs()
        # a variable without couplings or linear term (the clamped group's
        # padding) has a limit of 0: its field must be exact
        drift = torch.where(fb > 0, drift / fb, torch.where(drift == 0, 0.0, math.inf))
        k5_drift[path] = {"fields": drift.max().item(),
                          "energies": ((e64 - exact_e).abs() / eb).max().item()}
        check(bool(torch.isfinite(fields).all() and torch.isfinite(energy).all())
              and max(k5_drift[path].values()) <= 1.0,
              f"K5 {path} drift at S=1000, of its limit: {k5_drift[path]}")
        g = 1  # the unclamped group: every variable's row (the clamped pads n_out empty ones)
        typical = Jk[g].abs().masked_fill(Jk[g] == 0, math.nan).nanmedian(dim=1).values
        coupled = ~typical.isnan()
        k5_planted[path] = {
            "fields": ((f64[g, 0, 0, 0] - typical.double() - exact_f[g, 0, 0, 0]).abs()
                       / fb[g, 0, 0, 0])[coupled].min().item(),
            "energies": ((e64[g, 0, 0, 0] - exact_f[g, 0, 0, 0].abs().median()
                          - exact_e[g, 0, 0, 0]).abs() / eb[g, 0, 0, 0]).item()}
        check(min(k5_planted[path].values()) > 1.0, f"K5 {path} drift check: one add or flip "
              f"short reads only {k5_planted[path]} of the limit")
        k5_flips_full[path] = [int(v) for v in flips_k5.tolist()]
        del states, fields, energy, s64, exact_f, exact_e, f64, e64, drift
    beta1 = ", ".join(f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in oracle.items())
    print(f"phase 4 oracle: K1 n in (2, 5, 8), 512 reads, 200 sweeps, worst marginal "
          f"error {worst:.4f} (limit {ORACLE_ATOL}); K1 at each layout forced {k1_oracle} "
          f"(n = 12: beta 0.1 to 1, the oracle at 1); at beta 1 marginal/moment errors "
          f"{beta1} (limits {HB_ATOL} single and PT, {JOINT_ATOL} pair and quad, moments "
          f"{MOMENT_ATOL}; K2 at each layout, K3 at each layout at n = 5 and 12); "
          f"distinct states of 64 {distinct}; per-problem streams "
          "independent of batch-mates; Philox draws vs plain at G=2 B=60 n=6 R=1000 S=100 "
          f"(K3 at each layout: B=120 M=8 S={S_pt}, n=6 R=1000 and n=9 R=100; K4: G=2 B=20 "
          f"n=717 R=100 S={S_w}): differing chains "
          f"{philox} (K1 and K2 at each layout: G=2 B=60 n=6 R=1000 S=100 and G=2 B=20 "
          f"n={kernel_call.THREAD_MAX_N} R=100 S=20); K4 forced at n in (2, 5, 8): worst "
          f"oracle errors {worst_wide} (limits "
          f"{ORACLE_ATOL} Metropolis at the cold beta, {JOINT_ATOL} pair and {MOMENT_ATOL} "
          "pair moments at beta 1); K4 fields after S=1000 at G=2 B=20 n=717 R=100 vs h + J·s "
          f"in float64: max drift {drift_max}, of the limit at most {drift_ratio}; one "
          f"add of the row's median |J_jk| short reads at least {planted_ratio:.3f} of the "
          f"limit (must exceed 1); {flips_full} variables changed and their rows' nonzeros "
          f"(Metropolis); K2 fields "
          f"after S=1000 at G=2 B=3 n=41 R=100 (GROUP and LANES), of their limit at most "
          f"{k2_drift_ratio}, one "
          f"add short at least {k2_planted:.3f}; K5 forced at n in (2, 5, 8): worst marginal "
          f"error {worst_k5} (limit {HB_ATOL}); K5 fields and energies after S=1000 at G=2 "
          f"B=20 M=8 R=100 n=717 (dense path: a random QUBO; sparse: the step's QUBOs), of "
          f"their limits at most {k5_drift}, one add (fields) or flip (energies) short at least "
          f"{k5_planted}; [variables changed, nonzeros of their rows] {k5_flips_full}")

    # -- 5. the slices: qbm_main on cuda, one solver at a time ------------------
    clock(5)
    import qbmx_torch.cli.qbm_main as qm
    from qbmx_torch.models.dqbm import params_to_numpy

    made = []

    class RecordedDiscQBM(qm.DiscQBM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.initial_params = params_to_numpy(self.params)
            made.append(self)

    qm.DiscQBM = RecordedDiscQBM
    steps, predictions = math.ceil(600 / 60), 2  # 600 synthetic train images; val + test
    counters = launches_mod.MODULES
    x = torch.as_tensor(np.random.default_rng(0).random((60, 784), dtype=np.float32), device=dev)
    y = torch.as_tensor(np.arange(60) % 2, device=dev)
    mask = torch.ones(60, device=dev)
    launches, step_ms, singles = {}, {}, {}
    for solver, kernel in (("SA", "sa_metropolis"), ("BMS", "sa_heatbath"), ("PT", "pt_heatbath")):
        for c in counters:
            c.reset_launch_counts()
        t0 = time.perf_counter()
        acc, f1, precision, recall, auc = qm.main(
            device="cuda", data_set="synthetic", n_hidden_nodes=5, sample_count=1000,
            anneal=1000, batch_size=60, learning_rate=0.307, epochs=1, restricted=False,
            save="", solver=solver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.launch_counts.items()}
        launches[kernel] = counts[kernel]
        model = singles[solver] = made[-1]
        nlls = model.training_history.nll_per_batch
        moved = max(float(np.abs(v - model.initial_params[k]).max())
                    for k, v in params_to_numpy(model.params).items())
        check(launches[kernel] >= steps + predictions,
              f"{solver}: {kernel} launched {launches[kernel]} times for {steps} steps + "
              f"{predictions} predictions")
        check(len(nlls) == steps and all(math.isfinite(v) for v in nlls), f"{solver}: nll {nlls}")
        check(moved > 0.0, f"{solver}: training did not move the parameters")
        check(all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc)),
              f"{solver}: metrics out of range")
        step_ms[solver] = cuda_ms(lambda: model._step(x, y, mask, 0.307), runs=5)
        print(f"phase 5 slice {solver}: qbm_main cuda synthetic dim_input 784 H=5 sc1000 "
              f"anneal1000 bs60 e1: {steps} steps, launch counts {counts}, nll {nlls[0]:.4f} "
              f"-> {nlls[-1]:.4f}, max param change {moved:.4f}, test acc {acc:.4f} auc "
              f"{auc:.4f}, wall {wall:.2f} s, step {step_ms[solver]:.3f} ms (CUDA events, "
              "median of 5)")

    # the flat Disc_QBM with PT at 300 hidden nodes (n = 301, J_g dense: past
    # K3, and too many nonzeros for row lists): K5's dense path on every step
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    acc, f1, precision, recall, auc = qm.main(
        device="cuda", data_set="synthetic", n_hidden_nodes=300, sample_count=16, anneal=100,
        batch_size=60, learning_rate=0.307, epochs=1, restricted=False, save="", solver="PT")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for c in counters for k, v in c.launch_counts.items()}
    launches["pt_wide"] = counts["pt_wide"]
    model = made[-1]
    nlls = model.training_history.nll_per_batch
    check(counts["pt_wide"] >= steps + predictions and sum(counts.values()) == counts["pt_wide"],
          f"PT at H=300: launch counts {counts} for {steps} steps + {predictions} predictions")
    check(len(nlls) == steps and all(math.isfinite(v) for v in nlls), f"PT at H=300: nll {nlls}")
    check(all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc)),
          "PT at H=300: metrics out of range")
    print(f"phase 5 slice PT wide: qbm_main cuda synthetic dim_input 784 H=300 (n=301) sc16 "
          f"anneal100 bs60 e1: {steps} steps, launch counts {counts}, nll {nlls[0]:.4f} -> "
          f"{nlls[-1]:.4f}, test acc {acc:.4f}, wall {wall:.2f} s")

    # the CDQBM slice: cdqbm_main on cuda at its two full-width configurations
    import qbmx_torch.cli.cdqbm_main as cm
    from qbmx_torch.models import cdqbm

    cmade = []

    class RecordedCDQBM(cm.CDQBM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.initial_params = cdqbm.params_to_numpy(self.params)
            cmade.append(self)

    def flat(d):
        """Every array of a ``params_to_numpy`` dict."""
        return [a for v in d.values() if v is not None
                for a in (v if isinstance(v, tuple) else (v,))]

    cm.CDQBM = RecordedCDQBM
    cdqbm_launches, cmodels = {}, {}
    prob = dict(pooling_type="probabilistic", beta_eff=5.0, batch_size=20, learning_rate=0.02)
    for label, kernel, n_total, kw in (
        ("a", "anneal_wide_sparse", 717, prob),
        # PT at 717 variables on K5's sparse path, at 100 sweeps (3 steps at 1000 below)
        ("a PT", "pt_wide_sparse", 717, dict(prob, solver="PT", anneal=100)),
        ("b", "sa_metropolis", 41, dict()),
        ("b BMS", "sa_heatbath", 41, dict(solver="BMS")),
        ("b PT", "pt_heatbath", 41, dict(solver="PT")),  # K3 on 16 lanes (4,800 rungs)
    ):
        for c in counters:
            c.reset_launch_counts()
        t0 = time.perf_counter()
        acc, f1, precision, recall, auc = cm.main(
            device="cuda", data_set="synthetic", pooling_size=4, sequential_layer_sizes=(4,),
            sample_count=100, epochs=1, save="", **{"anneal": 1000, **kw})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.launch_counts.items()}
        model = cmodels[label] = cmade[-1]
        bs = kw.get("batch_size", 3)
        steps = math.ceil(600 / bs)
        cdqbm_launches[label] = counts
        check(model.geo.n_total == n_total, f"CDQBM ({label}): n_total {model.geo.n_total}")
        check(counts[kernel] >= steps + 4 and sum(counts.values()) == counts[kernel],
              f"CDQBM ({label}): launch counts {counts} for {steps} steps + 4 predictions")
        nlls = model.training_history.nll_per_batch
        moved = max(float(np.abs(a - b).max()) for a, b in
                    zip(flat(cdqbm.params_to_numpy(model.params)), flat(model.initial_params)))
        check(len(nlls) == steps and all(math.isfinite(v) for v in nlls),
              f"CDQBM ({label}): nll {nlls[:5]}")
        check(moved > 0.0, f"CDQBM ({label}): training did not move the parameters")
        check(all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc)),
              f"CDQBM ({label}): metrics out of range")
        ximg = torch.as_tensor(np.random.default_rng(1).random((bs, 28, 28), dtype=np.float32),
                               device=dev)
        yb, mb = torch.as_tensor(np.arange(bs) % 2, device=dev), torch.ones(bs, device=dev)
        step_ms[f"CDQBM {label}"] = cuda_ms(lambda: model._step(ximg, yb, mb, 0.01), runs=5)
        print(f"phase 5 slice CDQBM ({label}): cdqbm_main cuda synthetic {kw or 'defaults'} "
              f"n_total {n_total}: {steps} steps, launch counts {counts}, nll {nlls[0]:.4f} -> "
              f"{nlls[-1]:.4f}, max param change {moved:.4f}, test acc {acc:.4f} auc {auc:.4f}, "
              f"wall {wall:.2f} s, step {step_ms[f'CDQBM {label}']:.3f} ms (CUDA events, "
              "median of 5)")
    # the CDQBM (a) PT step at the main path's depth: 3 steps at anneal 1000,
    # each timed by CUDA events
    model = cmodels["a PT"]
    model.sampler = dataclasses.replace(model.sampler, num_sweeps=1000)
    ximg = torch.as_tensor(np.random.default_rng(1).random((20, 28, 28), dtype=np.float32),
                           device=dev)
    yb, mb = torch.as_tensor(np.arange(20) % 2, device=dev), torch.ones(20, device=dev)
    pt_wide_cuda.reset_launch_counts()
    pt_steps = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        nll, _ = model._step(ximg, yb, mb, 0.02)
        end.record()
        end.synchronize()
        pt_steps.append(start.elapsed_time(end))
        check(math.isfinite(float(nll)), f"CDQBM (a) PT at anneal 1000: nll {float(nll)}")
    check(pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 3,
                                         "pt_wide_global": 0, "pt_wide_global_sparse": 0},
          f"CDQBM (a) PT at anneal 1000: K5's sparse path did not serve every step: "
          f"{pt_wide_cuda.launch_counts}")
    step_ms["CDQBM a PT anneal1000"] = statistics.median(pt_steps)
    print(f"phase 5 slice CDQBM (a) PT at anneal 1000 (K5 sparse: G=2 B=20 M=8 R=100 n=717 "
          "S=1000): "
          f"steps {pt_steps} ms, median {step_ms['CDQBM a PT anneal1000']:.3f} ms (CUDA events)")

    # the 10-seed flagship sweep: qbm_main --seed_sweep, one sampler launch a
    # step for all ten seeds (G=20 groups of B=60), per solver
    from qbmx_torch.cli._common import load_dataset
    from qbmx_torch.data import loaders
    from qbmx_torch.samplers.api import sampler_sample_groups

    class ShapeLog:
        """A sweep's sampler, recording each call's (groups, problems, n)."""

        def __init__(self, inner):
            self.inner, self.calls = inner, []

        def sample_groups(self, generator, Q_shared, h_extra, num_reads):
            self.calls.append(tuple(h_extra.shape))
            return sampler_sample_groups(self.inner, generator, Q_shared, h_extra, num_reads)

    sweeps = []

    class RecordedSweep(qm.SeedParallelDQBM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.sampler = ShapeLog(self.sampler)
            self.initial = params_to_numpy(self.params)
            sweeps.append(self)

        def train(self, *a, **k):
            self.histories = super().train(*a, **k)
            return self.histories

    qm.SeedParallelDQBM = RecordedSweep
    seeds10, steps = list(range(10)), math.ceil(600 / 60)
    (train_X, train_y), (val_X, _), (test_X, _) = load_dataset("synthetic", seed=19)
    train_X, _, _ = loaders.preprocess_images(train_X, test_X, val_X)
    train_y = np.asarray(train_y)
    sweep_rec = {}
    for solver, kernel in (("SA", "sa_metropolis"), ("BMS", "sa_heatbath"), ("PT", "pt_heatbath")):
        with tempfile.TemporaryDirectory() as tmp:
            for c in counters:
                c.reset_launch_counts()
            t0 = time.perf_counter()
            accs, aucs = qm.main(
                device="cuda", data_set="synthetic", n_hidden_nodes=5, sample_count=1000,
                anneal=1000, batch_size=60, learning_rate=0.307, epochs=1, restricted=False,
                save=f"{tmp}/", name="sweep", solver=solver, seed_sweep=seeds10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for c in counters for k, v in c.launch_counts.items()}
            sw = sweeps[-1]
            check(sw.sampler.calls == [(20, 60, 6)] * steps + [(10, 100, 6)],
                  f"sweep {solver}: sampler calls {sw.sampler.calls}")
            check(counts[kernel] == steps + 1 and sum(counts.values()) == counts[kernel],
                  f"sweep {solver}: launch counts {counts} for {steps} steps + 1 validation")
            moved = [max(float(np.abs(v[i] - sw.initial[k][i]).max())
                         for k, v in params_to_numpy(sw.params).items())
                     for i in range(10)]
            check(min(moved) > 0.0, f"sweep {solver}: a seed's parameters did not move: {moved}")
            check(all(len(h.nll_per_batch) == steps and all(map(math.isfinite, h.nll_per_batch))
                      for h in sw.histories), f"sweep {solver}: nll not finite")
            check(all(0.0 <= v <= 1.0 for v in accs + aucs), f"sweep {solver}: metrics {accs}")
            pkls = sorted(Path(tmp, "best_model").glob("sweep_se*_best.pkl"))
            check(len(pkls) == 10, f"sweep {solver}: {len(pkls)} best-model pickles")
            for i, pkl in enumerate(sorted(pkls, key=lambda q: int(q.name.split("_se")[1]
                                                                   .split("_")[0]))):
                m = qm.DiscQBM(dim_input=784, n_hidden_nodes=5, restricted=False,
                               load_path=str(pkl), device=dev)
                best = params_to_numpy(sw.best_params_for_seed(i))
                check(all(np.array_equal(v, best[k]) for k, v in params_to_numpy(m.params).items()),
                      f"sweep {solver}: {pkl.name} does not load back into DiscQBM")
        step_ms[f"sweep {solver}"] = cuda_ms(lambda: sw._step(x, y, mask, 0.307), runs=5)
        t0 = time.perf_counter()
        sw.train(train_X, train_y, epochs=1, batch_size=60, learning_rate=0.307, verbose=False)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles[solver].train_epoch(train_X, train_y, 60, 0.307)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        sweep_rec[solver] = {"step_ms": step_ms[f"sweep {solver}"], "epoch_s": sweep_s,
                             "epoch_s_a_seed": sweep_s / 10, "single_model_epoch_s": single_s,
                             "launches": counts[kernel], "best_acc": accs, "best_auc": aucs,
                             "wall_s": wall}
        print(f"phase 5 sweep {solver}: qbm_main --seed_sweep 0..9 cuda synthetic H=5 sc1000 "
              f"anneal1000 bs60 e1: {steps} steps of one launch at G=20 B=60 n=6 + 1 "
              f"validation launch at G=10 B=100, launch counts {counts}, every seed moved "
              f"(min {min(moved):.4f}), best acc {min(accs):.4f}..{max(accs):.4f}, 10 best-model "
              f"pickles loaded back, wall {wall:.2f} s; step {step_ms[f'sweep {solver}']:.3f} ms "
              f"(CUDA events, median of 5) = {step_ms[f'sweep {solver}'] / 10:.3f} ms a seed "
              f"against a single-model step of {step_ms[solver]:.3f} ms; a training epoch "
              f"{sweep_s:.3f} s = {sweep_s / 10:.4f} s a seed, against {single_s:.4f} s for a "
              f"single model's ({10 * single_s:.3f} s for ten)")

    # K3 past n = 8 in training: qbm_main --solver PT -hn 8 at the flagship's
    # widths (the flat PT h8 call, (120, 9, 9) M=8 R=1000: a rung a thread),
    # qm.main()'s defaults with PT ((20, 11, 11) R=100), and the -hn 8 sweep
    # (G=20 B=60, anneal cut to 100 for the epoch): K3 once a sampler call and
    # nothing else, one launch a step (counted apart), every call on the rule's route
    pt_users = {}
    for label, kw in (("flat PT h8", dict(n_hidden_nodes=8, sample_count=1000, anneal=1000,
                                          batch_size=60, learning_rate=0.307, restricted=False)),
                      ("qm.main PT", dict()),
                      ("flat PT h8 sweep", dict(n_hidden_nodes=8, sample_count=1000, anneal=100,
                                                batch_size=60, learning_rate=0.307,
                                                restricted=False, seed_sweep=seeds10))):
        with tempfile.TemporaryDirectory() as tmp:
            for c in counters:
                c.reset_launch_counts()
            t0 = time.perf_counter()
            qm.main(device="cuda", data_set="synthetic", epochs=1, solver="PT",
                    save=f"{tmp}/" if "seed_sweep" in kw else "", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.launch_counts.items()}
        model = sweeps[-1] if "seed_sweep" in kw else made[-1]
        bs = kw.get("batch_size", 10)  # qm.main's default: 10
        n_u = kw.get("n_hidden_nodes", 10) + 1
        G = 20 if "seed_sweep" in kw else 2
        steps_pt = math.ceil(600 / bs)
        route = pt_cuda.pt_layout(G * bs, PT_RUNGS, model.sample_count, n_u).route
        check(counts == {**{k: 0 for k in counts}, "pt_heatbath": counts["pt_heatbath"]}
              and counts["pt_heatbath"] >= steps_pt + 1,
              f"{label}: launch counts {counts} for {steps_pt} steps and the predictions")
        if "seed_sweep" in kw:
            check(model.sampler.calls == [(20, 60, n_u)] * steps_pt + [(10, 100, n_u)],
                  f"{label}: sampler calls {model.sampler.calls}")
            nlls = [v for h in model.histories for v in h.nll_per_batch]
        else:
            nlls = model.training_history.nll_per_batch
        check(len(nlls) >= steps_pt and all(map(math.isfinite, nlls)), f"{label}: nll {nlls[:4]}")
        xb, yb_, mb_ = x[:bs], y[:bs], mask[:bs]
        pt_cuda.reset_launch_counts()
        model._step(xb, yb_, mb_, 0.307)
        torch.cuda.synchronize()
        check(pt_cuda.launch_counts["pt_heatbath"] == 1,
              f"{label}: a step launched K3 {pt_cuda.launch_counts['pt_heatbath']} times")
        ms = cuda_ms(lambda: model._step(xb, yb_, mb_, 0.307), runs=3)
        pt_users[label] = {"launches_an_epoch": counts["pt_heatbath"], "launches_a_step": 1,
                           "steps": steps_pt, "route": route, "step_ms": ms, "wall_s": wall,
                           "anneal": kw.get("anneal", 1000)}
        print(f"phase 5 K3 past n = 8, {label}: qbm_main --solver PT cuda synthetic "
              f"H={n_u - 1} sc{model.sample_count} anneal{kw.get('anneal', 1000)} bs{bs} e1: "
              f"{steps_pt} steps, pt_heatbath launched {counts['pt_heatbath']} times an epoch "
              f"and once a step ({route}), nothing else; step {ms:.3f} ms (CUDA events, median "
              f"of 3), wall {wall:.2f} s")

    # the 10-seed CDQBM sweeps: cdqbm_main --seed_sweep 0..9, one sampler
    # launch a step for all ten seeds. CDQBM (a) (n = 717): G=20 groups of
    # B=20 on K4 (SA, BMS) or K5's sparse path (PT), the anneal cut for the
    # epoch (SA and BMS 20 sweeps, PT 10), then SA at anneal 1000 for 3 steps
    # and a validation chunk; CDQBM (b) (n = 41, bs3): G=20 groups of B=3 on
    # K1 (SA) and K2 (BMS) at anneal 1000
    csweeps = []

    class RecordedCSweep(cm.SeedParallelCDQBM):
        """A CDQBM sweep that logs its sampler calls' shapes and times its
        steps by CUDA events."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.model.sampler = ShapeLog(self.model.sampler)
            self.initial = cdqbm.params_to_numpy(self.params)
            self.events = []
            csweeps.append(self)

        def _step(self, *a):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = super()._step(*a)
            end.record()
            self.events.append((start, end))
            return out

        def train(self, *a, **k):
            self.histories = super().train(*a, **k)
            return self.histories

        def step_times(self) -> list:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.events]

    cm.SeedParallelCDQBM = RecordedCSweep
    sweep_qubos = {}  # each sweep's step QUBOs, for phase 6's bounds
    cdqbm_a = dict(pooling_type="probabilistic", beta_eff=5.0, batch_size=20, learning_rate=0.02)
    csweep_rec = {}
    for label, solver, kernel, anneal, n_total, bs, kw in (
            ("a", "SA", "anneal_wide_sparse", 20, 717, 20, cdqbm_a),
            ("a", "BMS", "anneal_wide_sparse", 20, 717, 20, cdqbm_a),
            ("a", "PT", "pt_wide_sparse", 10, 717, 20, cdqbm_a),
            ("b", "SA", "sa_metropolis", 1000, 41, 3, {}),
            ("b", "BMS", "sa_heatbath", 1000, 41, 3, {}),
            # K3 on lanes (n = 41, 48,000 rungs), the anneal cut for the epoch
            ("b", "PT", "pt_heatbath", 100, 41, 3, {})):
        steps = math.ceil(600 / bs)
        with tempfile.TemporaryDirectory() as tmp:
            for c in counters:
                c.reset_launch_counts()
            t0 = time.perf_counter()
            accs, aucs = cm.main(
                device="cuda", data_set="synthetic", pooling_size=4, sequential_layer_sizes=(4,),
                sample_count=100, anneal=anneal, epochs=1, save=f"{tmp}/", name="csweep",
                solver=solver, seed_sweep=seeds10, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for c in counters for k, v in c.launch_counts.items()}
            sw = csweeps[-1]
            tag = f"CDQBM ({label}) sweep {solver}"
            check(sw.model.geo.n_total == n_total, f"{tag}: n_total {sw.model.geo.n_total}")
            check(sw.model.sampler.calls == [(20, bs, n_total)] * steps + [(10, 32, n_total)] * 4,
                  f"{tag}: sampler calls {sw.model.sampler.calls[:3]}... "
                  f"({len(sw.model.sampler.calls)})")
            check(counts[kernel] == steps + 4 and sum(counts.values()) == counts[kernel],
                  f"{tag}: launch counts {counts} for {steps} steps + 4 validation chunks")
            cur = cdqbm.params_to_numpy(sw.params)
            moved = [max(float(np.abs(a[i] - b[i]).max())
                         for a, b in zip(flat(cur), flat(sw.initial))) for i in range(10)]
            check(min(moved) > 0.0, f"{tag}: a seed's parameters did not move: {moved}")
            check(all(len(h.nll_per_batch) == steps and all(map(math.isfinite, h.nll_per_batch))
                      for h in sw.histories), f"{tag}: nll not finite")
            check(all(0.0 <= v <= 1.0 for v in accs + aucs), f"{tag}: metrics {accs} {aucs}")
            pkls = sorted(Path(tmp, "best_model").glob("csweep_se*_best.pkl"),
                          key=lambda q: int(q.name.split("_se")[1].split("_")[0]))
            check(len(pkls) == 10, f"{tag}: {len(pkls)} best-model pickles")
            m = sw.model
            for i, pkl in enumerate(pkls):
                back = cdqbm.CDQBM(pooling_size=4, pooling_type=m.geo.pooling_type,
                                   sequential_layer_sizes=[4], load_path=str(pkl), device=dev)
                check(all(np.array_equal(a, b) for a, b in zip(
                    flat(cdqbm.params_to_numpy(back.params)),
                    flat(cdqbm.params_to_numpy(sw.best_params_for_seed(i))))),
                      f"{tag}: {pkl.name} does not load back into CDQBM")
        sweep_steps = sw.step_times()[1:]  # the first step carries the warm-up
        single = cdqbm.CDQBM(pooling_size=4, pooling_type=m.geo.pooling_type,
                             sequential_layer_sizes=[4], hidden_bias_type="shared",
                             solver=solver, anneal=anneal, sample_count=100,
                             beta_eff=m.beta_eff, device=dev)
        ximg = torch.as_tensor(np.random.default_rng(1).random((bs, 28, 28), dtype=np.float32),
                               device=dev)
        yb, mb = torch.as_tensor(np.arange(bs) % 2, device=dev), torch.ones(bs, device=dev)
        single_ms = cuda_ms(lambda: single._step(ximg, yb, mb, 0.02), runs=3)
        sweep_qubos[f"{label} {solver}"] = sw.step_qubos(ximg, yb)
        rec = {"solver": solver, "anneal": anneal, "G": 20, "B": bs, "n": n_total,
               "steps": steps, "launches": counts[kernel],
               "step_ms": statistics.median(sweep_steps),
               "seed_step_ms": statistics.median(sweep_steps) / 10,
               "single_model_step_ms": single_ms, "best_acc": accs, "best_auc": aucs,
               "wall_s": wall}
        csweep_rec[f"{label} {solver}"] = rec
        print(f"phase 5 {tag}: cdqbm_main --seed_sweep 0..9 cuda synthetic n_total {n_total} "
              f"sc100 anneal{anneal}{' (cut for the epoch)' if anneal < 1000 else ''} bs{bs} "
              f"e1: {steps} steps of one launch at G=20 B={bs} + 4 validation launches at G=10 "
              f"B=32, launch counts {counts}, every seed moved (min {min(moved):.4f}), best acc "
              f"{min(accs):.4f}..{max(accs):.4f}, 10 best-model pickles loaded back, wall "
              f"{wall:.2f} s; step {rec['step_ms']:.3f} ms (CUDA events, median of "
              f"{len(sweep_steps)}) = {rec['seed_step_ms']:.3f} ms a seed against a single "
              f"model's step of {single_ms:.3f} ms at the same anneal (median of 3)")

        if (label, solver) == ("b", "PT"):
            # K3 at the sweep's call, (60, 41, 41) densified from its own step
            # QUBOs, against the plain version under host variates (S=100)
            Qb = densify_groups(*sweep_qubos["b PT"])
            hv = pt_hv(rng, 60 * PT_RUNGS, 100, n_total, 100, dev)
            launches_mod.reset()
            out = pt_cuda.pt_sample_batch_cuda(Qb, 100, 100, num_replicas=PT_RUNGS,
                                               host_variates=hv)
            torch.cuda.synchronize()
            check(launches_mod.counts() == {"pt_heatbath": 1},
                  f"{tag}: the G=20 call launched {launches_mod.counts()}")
            record("pt_heatbath", compare(out, tempering.pt_sample_batch_plain(
                Qb, 100, 100, num_replicas=PT_RUNGS, host_variates=hv),
                f"K3 B=60 n=41 M=8 R=100 S=100 (the 10-seed CDQBM (b) PT sweep's step QUBOs, "
                f"densified; {pt_cuda.pt_layout(60, PT_RUNGS, 100, 41).route})", phase=5))
            del hv, out
        elif label == "b":
            # K1 (SA) or K2 pair (BMS) at G=20 B=3 on the sweep's own step
            # QUBOs, against the plain version under host variates (S cut
            # to 100), with the layout the rule picks at that call
            Qb, hb = sweep_qubos[f"b {solver}"]
            Sb, lanes = 100, kernel_call.chain_layout(20, bs, 100, n_total).lanes
            hv = (bits(rng, (20, bs, 100, n_total), dev),
                  uniforms(rng, (Sb, 20, bs, n_total, 100), dev))
            args = (Qb, hb, 100, Sb)
            if solver == "SA":
                kern = lambda: sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv)
                plain = lambda: sa_torch.sa_sample_groups_plain(*args, host_variates=hv)
            else:
                kern = lambda: gibbs_cuda.gibbs_sample_groups_cuda(*args, pair=True,
                                                                   host_variates=hv)
                plain = lambda: gibbs.gibbs_sample_groups_plain(*args, pair=True, host_variates=hv)
            for c in counters:
                c.reset_launch_counts()
            out = kern()
            torch.cuda.synchronize()
            counts = {k: v for c in counters for k, v in c.launch_counts.items()}
            check(counts[kernel] == 1 and sum(counts.values()) == 1,
                  f"{tag}: the G=20 call was not served by {kernel} alone: {counts}")
            record(kernel, compare(out, plain(), f"{'K1' if solver == 'SA' else 'K2 pair'} "
                                                 f"structured G=20 B={bs} n={n_total} R=100 "
                                                 f"S={Sb} (the 10-seed CDQBM (b) sweep's step "
                                                 f"QUBOs; {lanes} lanes a chain)", phase=5))
            del hv, out
        if (label, solver) == ("a", "SA"):
            # K4 at G=20 on the sweep's own step QUBOs, against the plain
            # version under host variates (Metropolis and pair, S cut to 5)
            xw = torch.as_tensor(np.random.default_rng(3).random((20, 28, 28), dtype=np.float32),
                                 device=dev)
            Qsw, hsw = sw.step_qubos(xw, torch.as_tensor(np.arange(20) % 2, device=dev))
            geo_sw = wide_cuda.wide_geometry(20, 20, 100, 717)
            check((geo_sw.chains_per_block, geo_sw.grid) == (32, (63, 20)),
                  f"K4 at the sweep's call: {geo_sw}")
            S5 = 5
            hv = (bits(rng, (20, 20, 100, 717), dev), uniforms(rng, (S5, 20, 20, 717, 100), dev))
            args = (Qsw, hsw, 100, S5)
            for width, kern, plain in (
                    ("Metropolis", lambda: sa_cuda.sa_sample_groups_cuda(*args, host_variates=hv),
                     lambda: sa_torch.sa_sample_groups_plain(*args, host_variates=hv)),
                    ("pair", lambda: gibbs_cuda.gibbs_sample_groups_cuda(
                        *args, pair=True, host_variates=hv),
                     lambda: gibbs.gibbs_sample_groups_plain(*args, pair=True,
                                                             host_variates=hv))):
                wide_cuda.reset_launch_counts()
                out = kern()
                torch.cuda.synchronize()
                check(wide_cuda.launch_counts["anneal_wide_sparse"] == 1
                      and sum(wide_cuda.launch_counts.values()) == 1,
                      f"K4 {width} at the sweep's call: not its sparse path once")
                record("anneal_wide_sparse", compare(
                    out, plain(), f"K4 {width} structured G=20 B=20 n=717 R=100 S={S5} (the "
                                  "10-seed CDQBM (a) sweep's step QUBOs; 32 chains a block on a "
                                  f"grid of {geo_sw.grid})", phase=5))
            del hv, out
            # SA at the main path's anneal: 3 steps and one validation chunk
            m.sampler = ShapeLog(dataclasses.replace(m.sampler.inner, num_sweeps=1000))
            (tx, ty), _, (vx, vy) = load_dataset("synthetic", seed=44)
            sw.events = []
            wide_cuda.reset_launch_counts()
            sw.train(tx[:60], np.asarray(ty[:60]), vx[:32], np.asarray(vy[:32]), epochs=1,
                     batch_size=20, learning_rate=0.02, verbose=False)
            full = sw.step_times()
            check(m.sampler.calls == [(20, 20, 717)] * 3 + [(10, 32, 717)]
                  and wide_cuda.launch_counts["anneal_wide_sparse"] == 4
                  and sum(wide_cuda.launch_counts.values()) == 4,
                  f"CDQBM (a) sweep SA at anneal 1000: calls {m.sampler.calls}, launch counts "
                  f"{wide_cuda.launch_counts}")
            check(all(math.isfinite(h.nll_per_batch[-1]) for h in sw.histories),
                  "CDQBM (a) sweep SA at anneal 1000: nll not finite")
            rec.update(step_ms_anneal1000=statistics.median(full),
                       seed_step_ms_anneal1000=statistics.median(full) / 10,
                       steps_ms_anneal1000=full,
                       single_model_step_ms_anneal1000=step_ms["CDQBM a"])
            print(f"phase 5 CDQBM (a) sweep SA at anneal 1000 (K4: G=20 B=20 R=100 n=717 "
                  f"S=1000): 3 steps and 1 validation chunk, launch counts "
                  f"{wide_cuda.launch_counts}; steps {full} ms (CUDA events), median "
                  f"{statistics.median(full):.3f} ms = {statistics.median(full) / 10:.3f} ms a "
                  f"seed against a single model's step of {step_ms['CDQBM a']:.3f} ms")
        if (label, solver) == ("a", "PT"):
            # both K5 paths forced on the sweep's own step QUBOs at G=20, S=10:
            # the same samples, states, fields, energies and counters
            xw = torch.as_tensor(np.random.default_rng(3).random((20, 28, 28), dtype=np.float32),
                                 device=dev)
            Qsw, hsw = sw.step_qubos(xw, torch.as_tensor(np.arange(20) % 2, device=dev))
            G, B, n, M, R, S = 20, 20, 717, 8, 100, 10
            nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Qsw)[1]))
            geo_pt = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(max(nnz)))
            check(geo_pt.path == pt_wide_cuda.SPARSE and geo_pt.grid == (500, 20),
                  f"K5 at the sweep's call: {geo_pt}")
            # the sparse path through the sampler's structured entry against
            # the plain version on the densified batch, under the same variates
            hv = card_pt_hv(31, G * B * M, R, n, S, dev)
            pt_cuda.reset_launch_counts()
            pt_wide_cuda.reset_launch_counts()
            out = pt_wide_cuda.pt_sample_groups(Qsw, hsw, R, S, num_replicas=M, host_variates=hv)
            torch.cuda.synchronize()
            check(pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 1,
                                                 "pt_wide_global": 0, "pt_wide_global_sparse": 0}
                  and pt_cuda.launch_counts["pt_heatbath"] == 0,
                  f"K5 at the sweep's call: not served by the sparse path alone "
                  f"({pt_wide_cuda.launch_counts})")
            want = tempering.pt_sample_batch_plain(densify_groups(Qsw, hsw), R, S,
                                                   num_replicas=M,
                                                   host_variates=hv).reshape(G, B, R, n)
            record("pt_wide_sparse", compare(
                out, want, f"K5 sparse G={G} B={B} n={n} M={M} R={R} S={S} (the 10-seed CDQBM "
                           f"(a) PT sweep's step QUBOs; 4 ladders a block on a grid of "
                           f"{geo_pt.grid})", phase=5))
            del hv, out, want
            form = pt_wide_cuda.structured_form(Qsw, hsw, M)
            paths = {}
            for path in (pt_wide_cuda.DENSE, pt_wide_cuda.SPARSE):
                outs = dict(states_out=torch.empty((G * B * M, R, n), device=dev),
                            fields_out=torch.empty((G * B * M, R, n), device=dev),
                            energy_out=torch.empty((G * B * M, R), device=dev),
                            flips=torch.zeros(2, dtype=torch.int64, device=dev))
                out = pt_wide_cuda.launch(*form, R, S, path=path, generator=gen_of(21), **outs)
                paths[path] = dict(out=out, **outs)
            torch.cuda.synchronize()
            unequal = [k for k, v in paths[pt_wide_cuda.DENSE].items()
                       if not torch.equal(v, paths[pt_wide_cuda.SPARSE][k])]
            check(not unequal, f"K5 paths forced on the sweep's call: {unequal} differ")
            rec["k5_paths_equal_flips"] = paths[pt_wide_cuda.SPARSE]["flips"].tolist()
            del paths, outs, out
            print(f"phase 5 K5 paths forced at G={G} B={B} M={M} R={R} n={n} S={S} (the 10-seed "
                  f"CDQBM (a) sweep's step QUBOs: {len(nnz)} row lists, at most {max(nnz)} "
                  f"nonzeros; 4 ladders a block on a grid of {geo_pt.grid}): samples, states, "
                  f"fields, energies and counters {rec['k5_paths_equal_flips']} equal bit for bit")

    # resume: 2 epochs straight against 1 epoch with --checkpoint_every 1 and
    # then --resume for the second, on the card, for the flagship DQBM with
    # SA (K1), BMS (K2 pair) and PT (K3), CDQBM (b) (K1) and CDQBM (a) with
    # SA (K4), BMS (K4 pair) and PT (K5's sparse path) at a cut anneal: the
    # same parameters, history and random stream
    def same_run(a, b) -> list:
        """The fields in which two trained models differ (empty: bit for bit)."""
        from qbmx_torch.utils.checkpoint import flatten_params

        pa, pb = flatten_params(a.params), flatten_params(b.params)
        bad = [k for k in pa if not np.array_equal(pa[k], pb[k])]
        if not torch.equal(a.generator.get_state(), b.generator.get_state()):
            bad.append("generator state")
        ha, hb = dataclasses.asdict(a.training_history), dataclasses.asdict(b.training_history)
        return bad + [k for k in ha if k != "distribution_per_epoch" and ha[k] != hb[k]]

    resume_rec = {}
    cdqbm_a10 = dict(prob, pooling_size=4, sequential_layer_sizes=(4,), sample_count=100,
                     anneal=10)
    flagship = dict(n_hidden_nodes=5, sample_count=1000, anneal=1000, batch_size=60,
                    learning_rate=0.307, restricted=False)
    for label, main, models, kernel, kw in (
            ("flagship DQBM SA", qm.main, made, "sa_metropolis", dict(flagship, solver="SA")),
            ("flagship DQBM BMS", qm.main, made, "sa_heatbath", dict(flagship, solver="BMS")),
            ("flagship DQBM PT", qm.main, made, "pt_heatbath", dict(flagship, solver="PT")),
            ("CDQBM (b)", cm.main, cmade, "sa_metropolis",
             dict(pooling_size=4, sequential_layer_sizes=(4,))),
            ("CDQBM (a) SA, anneal 10", cm.main, cmade, "anneal_wide_sparse", cdqbm_a10),
            ("CDQBM (a) BMS, anneal 10", cm.main, cmade, "anneal_wide_sparse",
             dict(cdqbm_a10, solver="BMS")),
            ("CDQBM (a) PT, anneal 10", cm.main, cmade, "pt_wide_sparse",
             dict(cdqbm_a10, solver="PT"))):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            main(device="cuda", data_set="synthetic", epochs=2, save=f"{tmp}/a/",
                 checkpoint_every=1, **kw)
            whole = models[-1]
            main(device="cuda", data_set="synthetic", epochs=1, save=f"{tmp}/b/",
                 checkpoint_every=1, **kw)
            (state,) = Path(tmp, "b").glob("*/state.npz")
            for c in counters:
                c.reset_launch_counts()
            main(device="cuda", data_set="synthetic", epochs=2, save=f"{tmp}/c/",
                 resume=str(state), **kw)
            resumed = models[-1]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: v for c in counters for k, v in c.launch_counts.items()}
        steps_an_epoch = len(whole.training_history.nll_per_batch) // 2
        check(counts[kernel] >= steps_an_epoch and sum(counts.values()) == counts[kernel],
              f"resume {label}: the resumed epoch's launch counts {counts}")
        differ = same_run(whole, resumed)
        check(not differ, f"resume {label}: the resumed run differs from the uninterrupted one "
                          f"in {differ}")
        resume_rec[label] = {"epochs": 2, "equal": "bit for bit", "wall_s": wall,
                             "steps_an_epoch": steps_an_epoch,
                             "resumed_run_launches": counts[kernel]}
        print(f"phase 5 resume {label}: 2 epochs straight against 1 epoch + --resume for the "
              f"second on cuda: parameters, history and generator state equal bit for bit "
              f"({steps_an_epoch} steps an epoch; the resumed run launched {kernel} "
              f"{counts[kernel]} times; wall {wall:.2f} s)")

    # -- 6. kernel and plain times, generator mode -----------------------------
    clock(6)
    layout_times = chain_layout_times(dev, np.random.default_rng(18), smi)
    pt_times = pt_layout_times(dev, np.random.default_rng(20), smi)
    g1 = torch.Generator().manual_seed(1)
    Qcli = random_qubo_batch(rng, 146, 3).to(dev)  # the flat CLI defaults' PT call, densified
    times = {}
    for label, kern, plain in (
        ("K1 structured G=2 B=60 n=6 R=1000 S=1000",
         lambda: sa_cuda.sa_sample_groups_cuda(Qg, h_extra, 1000, 1000, generator=g1),
         lambda: sa_torch.sa_sample_groups_plain(Qg, h_extra, 1000, 1000)),
        ("K1 dense B=60 n=41 R=100 S=1000",
         lambda: sa_cuda.sa_sample_batch_cuda(Qd, 100, 1000, generator=g1),
         lambda: sa_torch.sa_sample_batch_plain(Qd, 100, 1000)),
        ("K1 CDQBM (b) G=2 B=3 n=41 R=100 S=1000",
         lambda: sa_cuda.sa_sample_groups_cuda(Qcb, hcb, 100, 1000, generator=g1),
         lambda: sa_torch.sa_sample_groups_plain(Qcb, hcb, 100, 1000)),
        ("K2 pair structured G=2 B=60 n=6 R=1000 S=1000",
         lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qg, h_extra, 1000, 1000, pair=True,
                                                     generator=g1),
         lambda: gibbs.gibbs_sample_groups_plain(Qg, h_extra, 1000, 1000, pair=True)),
        ("K2 pair CDQBM (b) G=2 B=3 n=41 R=100 S=1000",
         lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qcb, hcb, 100, 1000, pair=True,
                                                     generator=g1),
         lambda: gibbs.gibbs_sample_groups_plain(Qcb, hcb, 100, 1000, pair=True)),
        ("K2 single dense B=60 n=41 R=100 S=1000",
         lambda: gibbs_cuda.gibbs_sample_batch_cuda(Qd, 100, 1000, generator=g1),
         lambda: gibbs.gibbs_sample_batch_plain(Qd, 100, 1000)),
        ("K2 quad dense B=60 n=41 R=100 S=1000",
         lambda: gibbs_cuda.gibbs_sample_batch_cuda(Qd, 100, 1000, quad=True, generator=g1),
         lambda: gibbs.gibbs_sample_batch_plain(Qd, 100, 1000, quad=True)),
        ("K3 densified B=120 n=6 M=8 R=1000 S=1000",
         lambda: pt_cuda.pt_sample_batch_cuda(Qpt, 1000, 1000, num_replicas=8, generator=g1),
         lambda: tempering.pt_sample_batch_plain(Qpt, 1000, 1000, num_replicas=8)),
        ("K3 CLI defaults B=146 n=3 M=8 R=100 S=1000",
         lambda: pt_cuda.pt_sample_batch_cuda(Qcli, 100, 1000, num_replicas=8, generator=g1),
         lambda: tempering.pt_sample_batch_plain(Qcli, 100, 1000, num_replicas=8)),
        ("K4 Metropolis structured G=2 B=20 n=717 R=100 S=10",
         lambda: sa_cuda.sa_sample_groups_cuda(Qw, hw, 100, 10, generator=g1),
         lambda: sa_torch.sa_sample_groups_plain(Qw, hw, 100, 10)),
        ("K4 pair structured G=2 B=20 n=717 R=100 S=10",
         lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qw, hw, 100, 10, pair=True, generator=g1),
         lambda: gibbs.gibbs_sample_groups_plain(Qw, hw, 100, 10, pair=True)),
        ("K4 dense Metropolis qbm_main -hn 300 -r False, the step's QUBOs, G=2 B=60 n=301 R=100 "
         "S=10", lambda: sa_cuda.sa_sample_groups_cuda(Qu, hu, 100, 10, generator=g1),
         lambda: sa_torch.sa_sample_groups_plain(Qu, hu, 100, 10)),
        ("K4 dense pair qbm_main -hn 300 -r False, the step's QUBOs, G=2 B=60 n=301 R=100 S=10",
         lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qu, hu, 100, 10, pair=True, generator=g1),
         lambda: gibbs.gibbs_sample_groups_plain(Qu, hu, 100, 10, pair=True)),
        ("K4 sparse Metropolis CDQBM (a), the step's QUBOs, G=2 B=20 n=717 R=100 S=10",
         lambda: sa_cuda.sa_sample_groups_cuda(Qs, hs, 100, 10, generator=g1),
         lambda: sa_torch.sa_sample_groups_plain(Qs, hs, 100, 10)),
        ("K4 sparse pair CDQBM (a), the step's QUBOs, G=2 B=20 n=717 R=100 S=10",
         lambda: gibbs_cuda.gibbs_sample_groups_cuda(Qs, hs, 100, 10, pair=True, generator=g1),
         lambda: gibbs.gibbs_sample_groups_plain(Qs, hs, 100, 10, pair=True)),
        ("K5 dense CDQBM (a) PT shape, random QUBOs, G=2 B=20 M=8 n=717 R=100 S=10",
         lambda: pt_wide_cuda.pt_sample_groups(Qw, hw, 100, 10, num_replicas=8, generator=g1),
         lambda: tempering.pt_sample_batch_plain(densify_groups(Qw, hw), 100, 10,
                                                 num_replicas=8)),
        ("K5 sparse CDQBM (a) PT, the step's QUBOs, G=2 B=20 M=8 n=717 R=100 S=10",
         lambda: pt_wide_cuda.pt_sample_groups(Qs, hs, 100, 10, num_replicas=8, generator=g1),
         lambda: tempering.pt_sample_batch_plain(densify_groups(Qs, hs), 100, 10,
                                                 num_replicas=8)),
    ):
        k_ms, p_ms = cuda_ms(kern, runs=5), cuda_ms(plain, runs=1)
        times[label] = (k_ms, p_ms)
        print(f"phase 6 time {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(CUDA events, kernel median of 5, plain one run after a warm-up; {smi})")

    k4_full_ms = cuda_ms(lambda: sa_cuda.sa_sample_groups_cuda(Qw, hw, 100, 1000, generator=g1),
                         runs=3)
    print(f"phase 6 time K4 Metropolis structured G=2 B=20 n=717 R=100 S=1000: kernel "
          f"{k4_full_ms:.3f} ms (CUDA events, median of 3; the plain version is not run at "
          f"this depth; {smi})")
    k4_cdqbm_ms = cuda_ms(lambda: sa_cuda.sa_sample_groups_cuda(Qs, hs, 100, 1000, generator=g1),
                          runs=3)
    print(f"phase 6 time K4 Metropolis CDQBM (a) on the step's QUBOs G=2 B=20 n=717 R=100 "
          f"S=1000 (the sparse shared path): kernel {k4_cdqbm_ms:.3f} ms (CUDA events, median "
          f"of 3; {smi})")
    # K4's shared layout at S=1000 on the CDQBM (a) step's QUBOs and on qbm_main -hn 300
    # -r True's (G=2 B=73 R=100 n=301): the sparse path (the rule's) against the dense
    # path forced, in turns
    Qr, hr = flat_step_qubos(300, 73, dev)
    k4_paths_ms = {}
    for label, (Q, h), rule in (("CDQBM (a) Metropolis G=2 B=20 n=717", (Qs, hs), 0),
                                ("CDQBM (a) pair G=2 B=20 n=717", (Qs, hs), 2),
                                ("restricted H=300 Metropolis G=2 B=73 n=301", (Qr, hr), 0)):
        form = structured_form(Q, h, 1000, rule)
        run = lambda path, form=form, rule=rule: wide_cuda.launch(
            *form, 100, 1000, rule, generator=g1, field_pass=path)
        sparse_ms, dense_ms = in_turns(lambda: run(wide_cuda.SPARSE),
                                       lambda: run(wide_cuda.DENSE), 2)
        k4_paths_ms[label] = {"sparse_ms": sparse_ms, "dense_ms": dense_ms}
        print(f"phase 6 time K4 shared layout {label} R=100 S=1000, the step's QUBOs: sparse "
              f"path {sparse_ms:.3f} ms, dense path (forced) {dense_ms:.3f} ms (CUDA events, "
              f"median of 4 in turns sparse dense dense sparse; {smi})")
    k5_full_ms = {
        path: cuda_ms(lambda Q=Q, h=h: pt_wide_cuda.pt_sample_groups(
            Q, h, 100, 1000, num_replicas=8, generator=g1), runs=3)
        for path, (Q, h) in ((pt_wide_cuda.DENSE, (Qw, hw)), (pt_wide_cuda.SPARSE, (Qs, hs)))}
    print(f"phase 6 time K5 CDQBM (a) PT G=2 B=20 M=8 n=717 R=100 S=1000: dense path (random "
          f"QUBOs) {k5_full_ms['dense']:.3f} ms, sparse path (the step's QUBOs) "
          f"{k5_full_ms['sparse']:.3f} ms (CUDA events, median of 3; the plain version is not "
          f"run at this depth; {smi})")

    # the bounds (qbmx_torch/utils/roofline.py): K1 and K2 from the flips
    # their inputs make, K4 and K5 from the nonzeros of the changed rows,
    # counted by one more launch each; K3 from its decisions alone
    def counted(launch, *args, **kw):
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        launch(*args, generator=g1, flips=flips, **kw)
        return int(flips.item())

    def work(launch, *args, **kw):
        """The nonzeros of the changed rows (K4's and K5's second counter)."""
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        launch(*args, generator=g1, flips=flips, **kw)
        return int(flips[1].item())

    pair = WIDTH_OF["pair"]
    bounds = {
        "sa_metropolis": anneal_bound(2, 60, 1000, 6, 1000, flips=counted(
            sa_cuda.launch, *structured_form(Qg, h_extra, 1000), 1000, 1000)),
        "sa_heatbath": anneal_bound(
            2, 60, 1000, 6, 1000, decisions=2 * 60 * 1000 * heatbath_units(6, pair) * 1000,
            flips=counted(gibbs_cuda.launch, *structured_form(Qg, h_extra, 1000, pair), 1000,
                          1000, pair)),
        "sa_heatbath CDQBM (b), decisions only": anneal_bound(
            2, 3, 100, 41, 1000, decisions=2 * 3 * 100 * heatbath_units(41, pair) * 1000),
        "sa_heatbath CDQBM (b)": anneal_bound(
            2, 3, 100, 41, 1000, decisions=2 * 3 * 100 * heatbath_units(41, pair) * 1000,
            flips=counted(gibbs_cuda.launch, *structured_form(Qcb, hcb, 1000, pair), 100, 1000,
                          pair)),
        "pt_heatbath": anneal_bound(120, 1, 1000, 6, 1000, decisions=120 * 8 * 1000 * 6 * 1000),
        "pt_heatbath CLI defaults": anneal_bound(146, 1, 100, 3, 1000,
                                                 decisions=146 * 8 * 100 * 3 * 1000),
        "anneal_wide": anneal_bound(2, 60, 100, 301, 10, flip_work=work(
            wide_cuda.launch, *structured_form(Qu, hu, 10), 100, 10, wide_cuda.METROPOLIS)),
        "anneal_wide pair": anneal_bound(
            2, 60, 100, 301, 10, decisions=2 * 60 * 100 * heatbath_units(301, pair) * 10,
            flip_work=work(wide_cuda.launch, *structured_form(Qu, hu, 10, pair), 100, 10, pair)),
        "anneal_wide random n=717": anneal_bound(2, 20, 100, 717, 10, flip_work=work(
            wide_cuda.launch, *structured_form(Qw, hw, 10), 100, 10, wide_cuda.METROPOLIS)),
        "anneal_wide full depth": anneal_bound(2, 20, 100, 717, 1000, flip_work=flips_full[1]),
        "anneal_wide_sparse": anneal_bound(2, 20, 100, 717, 10, flip_work=work(
            wide_cuda.launch, *structured_form(Qs, hs, 10), 100, 10, wide_cuda.METROPOLIS)),
        "anneal_wide_sparse pair": anneal_bound(
            2, 20, 100, 717, 10, decisions=2 * 20 * 100 * heatbath_units(717, pair) * 10,
            flip_work=work(wide_cuda.launch, *structured_form(Qs, hs, 10, pair), 100, 10, pair)),
        "anneal_wide_sparse full depth": anneal_bound(2, 20, 100, 717, 1000, flip_work=work(
            wide_cuda.launch, *structured_form(Qs, hs, 1000), 100, 1000, wide_cuda.METROPOLIS)),
        "anneal_wide_sparse restricted H=300 full depth": anneal_bound(
            2, 73, 100, 301, 1000, flip_work=work(
                wide_cuda.launch, *structured_form(Qr, hr, 1000), 100, 1000,
                wide_cuda.METROPOLIS)),
        "pt_wide": anneal_bound(2, 20, 100, 717, 10, rungs=8, flip_work=work(
            pt_wide_cuda.launch, *pt_wide_cuda.structured_form(Qw, hw, 8), 100, 10)),
        "pt_wide full depth": anneal_bound(2, 20, 100, 717, 1000, rungs=8,
                                           flip_work=k5_flips_full["dense"][1]),
        "pt_wide_sparse": anneal_bound(2, 20, 100, 717, 10, rungs=8, flip_work=work(
            pt_wide_cuda.launch, *pt_wide_cuda.structured_form(Qs, hs, 8), 100, 10)),
        "pt_wide_sparse full depth": anneal_bound(2, 20, 100, 717, 1000, rungs=8,
                                                  flip_work=k5_flips_full["sparse"][1]),
        # the 10-seed sweeps' calls, on their own step QUBOs
        "anneal_wide_sparse CDQBM (a) sweep G=20 full depth": anneal_bound(
            20, 20, 100, 717, 1000, flip_work=work(
                wide_cuda.launch, *structured_form(*sweep_qubos["a SA"], 1000), 100, 1000,
                wide_cuda.METROPOLIS)),
        "pt_wide_sparse CDQBM (a) sweep G=20 S=100": anneal_bound(
            20, 20, 100, 717, 100, rungs=8, flip_work=work(
                pt_wide_cuda.launch, *pt_wide_cuda.structured_form(*sweep_qubos["a PT"], 8),
                100, 100)),
        "sa_metropolis CDQBM (b) sweep G=20": anneal_bound(20, 3, 100, 41, 1000, flips=counted(
            sa_cuda.launch, *structured_form(*sweep_qubos["b SA"], 1000), 100, 1000)),
        "sa_heatbath CDQBM (b) sweep G=20": anneal_bound(
            20, 3, 100, 41, 1000, decisions=20 * 3 * 100 * heatbath_units(41, pair) * 1000,
            flips=counted(gibbs_cuda.launch, *structured_form(*sweep_qubos["b BMS"], 1000, pair),
                          100, 1000, pair)),
    }
    print(f"phase 6 bounds (H100 SXM peaks, {smi}): "
          + "; ".join(f"{k} {b['bound_ms']:.4f} ms by {b['bound_by']}" for k, b in bounds.items()))

    # -- 7. the RBM family -------------------------------------------------------
    clock(7)
    rbm_rec = rbm_phase(dev, smi, counters)

    # -- 8. the host seams: the native annealer and the QPU seam -----------------
    clock(8)
    host_rec = host_seams_phase(dev, smi, counters, made, (x, y, mask), step_ms["SA"])

    # -- 9. the mesh: a world of one under NCCL, two ranks on the card over gloo ---
    clock(9)
    mesh_rec = mesh_phase(dev, smi)

    # -- 10. past the shared layouts: K4's global fields, K5's global path, H=3400 --
    clock(10)
    wide_rec = wide_phase(dev, smi, counters, made)

    # -- 11. the user scripts: the exact studies, the breastmnist search ----------
    clock(11)
    scripts_rec = scripts_phase(smi)
    for key, r in scripts_rec["search_calls"].items():
        record(key.split()[0], (r["differing_chains"], r["max_abs_err"]))
    search_launches = lambda kernel: next(r["launches"] for r in scripts_rec["search"].values()
                                          if kernel in r["launches"])

    # -- 12. the seed bands: every kernel's training route against qbmx's band --
    clock(12)
    band_rec = band_phase(smi)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    t = lambda prefix: next(v for k, v in times.items() if k.startswith(prefix))
    bound_keys = lambda name: {"bound_ms": bounds[name]["bound_ms"],
                               "bound_by": bounds[name]["bound_by"], "library_ms": None}
    record = {"kernels": [
        {"name": "sa_metropolis", "route": "cuda", "source": "qbmx_torch/csrc/sa_metropolis.cu",
         "replaces": "qbmx/samplers/sa_lane.py:144",
         "also_replaces": "qbmx/samplers/sa_pallas.py:196",
         "launches": launches["sa_metropolis"], "max_abs_err": max(errs["sa_metropolis"]),
         "differing_chains": max(fracs["sa_metropolis"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K1 structured")[0], "plain_ms": t("K1 structured")[1],
         **bound_keys("sa_metropolis"), "layouts_lanes": layouts,
         "dense_ms": t("K1 dense")[0], "dense_plain_ms": t("K1 dense")[1],
         "cdqbm_b_ms": t("K1 CDQBM (b)")[0], "cdqbm_b_plain_ms": t("K1 CDQBM (b)")[1],
         "cdqbm_b_sweep_launches": csweep_rec["b SA"]["launches"],
         "cdqbm_b_sweep_bound_ms": bounds["sa_metropolis CDQBM (b) sweep G=20"]["bound_ms"],
         "warm_start_launches": rbm_rec["warm_start"]["sa_metropolis_launches"],
         "warm_start_ms": rbm_rec["warm_start"]["k1_ms"],
         "warm_start_plain_ms": rbm_rec["warm_start"]["k1_plain_ms"],
         "warm_start_bound_ms": rbm_rec["warm_start"]["k1_bound_ms"],
         "warm_start_differing_chains": rbm_rec["warm_start"]["k1_differing_chains"],
         "bms_search_launches": search_launches("sa_metropolis"),
         "bms_search_call": scripts_rec["search_calls"]["sa_metropolis"],
         "bms_search_call_sa_h8": scripts_rec["search_calls"]["sa_metropolis h8"],
         "chain_layouts": {k: v for k, v in chain_rec.items() if k.startswith("K1 ")},
         "layout_times": {k: v for k, v in layout_times.items() if k.startswith("K1 ")}},
        {"name": "sa_heatbath", "route": "cuda", "source": "qbmx_torch/csrc/sa_heatbath.cu",
         "replaces": "qbmx/samplers/sa_lane.py:144",
         "also_replaces": "qbmx/samplers/sa_pallas.py:196",
         "launches": launches["sa_heatbath"], "max_abs_err": max(errs["sa_heatbath"]),
         "differing_chains": max(fracs["sa_heatbath"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K2 pair structured")[0], "plain_ms": t("K2 pair structured")[1],
         **bound_keys("sa_heatbath"), "layouts_lanes": layouts,
         "cdqbm_b_ms": t("K2 pair CDQBM (b)")[0], "cdqbm_b_plain_ms": t("K2 pair CDQBM (b)")[1],
         "cdqbm_b_bound_ms": bounds["sa_heatbath CDQBM (b)"]["bound_ms"],
         "cdqbm_b_bound_decisions_only_ms":
             bounds["sa_heatbath CDQBM (b), decisions only"]["bound_ms"],
         "cdqbm_b_launches": cdqbm_launches["b BMS"]["sa_heatbath"],
         "single_dense_ms": t("K2 single")[0], "single_dense_plain_ms": t("K2 single")[1],
         "quad_dense_ms": t("K2 quad")[0], "quad_dense_plain_ms": t("K2 quad")[1],
         "field_drift_of_limit": k2_drift_ratio, "field_one_add_short_of_limit": k2_planted,
         "cdqbm_b_sweep_launches": csweep_rec["b BMS"]["launches"],
         "cdqbm_b_sweep_bound_ms": bounds["sa_heatbath CDQBM (b) sweep G=20"]["bound_ms"],
         "bms_search_launches": search_launches("sa_heatbath"),
         "bms_search_call": scripts_rec["search_calls"]["sa_heatbath"],
         "bms_winner_curves_launches": scripts_rec["winner_curves"]["launches"],
         "chain_layouts": {k: v for k, v in chain_rec.items() if k.startswith("K2 ")},
         "layout_times": {k: v for k, v in layout_times.items() if k.startswith("K2 ")}},
        {"name": "pt_heatbath", "route": "cuda", "source": "qbmx_torch/csrc/pt_heatbath.cu",
         "replaces": "qbmx/samplers/sa_pallas.py:196",
         "launches": launches["pt_heatbath"], "max_abs_err": max(errs["pt_heatbath"]),
         "differing_chains": max(fracs["pt_heatbath"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K3 densified")[0], "plain_ms": t("K3 densified")[1],
         **bound_keys("pt_heatbath"), "layouts": pt_layouts,
         "cli_defaults_ms": t("K3 CLI defaults")[0],
         "cli_defaults_plain_ms": t("K3 CLI defaults")[1],
         "cli_defaults_bound_ms": bounds["pt_heatbath CLI defaults"]["bound_ms"],
         "bms_search_launches": search_launches("pt_heatbath"),
         "bms_search_call": scripts_rec["search_calls"]["pt_heatbath"],
         "layout_checks": pt_rec, "users_calls": pt_times, "users_training": pt_users,
         "cdqbm_b_launches": cdqbm_launches["b PT"]["pt_heatbath"],
         "cdqbm_b_sweep_launches": csweep_rec["b PT"]["launches"],
         "band_launches": {s_: band_rec["settings"][s_]["band"]["launches"]
                           for s_ in ("flat_pt_h2", "flat_pt_h8", "cdqbm_b_pt")}},
        {"name": "anneal_wide", "route": "cuda", "source": "qbmx_torch/csrc/anneal_wide.cu",
         "replaces": "qbmx/samplers/sa_lane.py:144",
         "also_replaces": "qbmx/samplers/sa_pallas.py:196",
         "path": "shared layout, dense path (J_g in tiles)",
         "launches": sum(band_rec["settings"][s_]["band"]["launches"]
                         for s_ in ("flat_sa_h300", "flat_bms_h300")),
         "launches_on": "the bands flat_sa_h300 and flat_bms_h300 (qbm_main -hn 300 -r False)",
         "max_abs_err": max(errs["anneal_wide"]),
         "differing_chains": max(fracs["anneal_wide"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K4 dense Metropolis")[0], "plain_ms": t("K4 dense Metropolis")[1],
         **bound_keys("anneal_wide"),
         "pair_ms": t("K4 dense pair")[0], "pair_plain_ms": t("K4 dense pair")[1],
         "pair_bound_ms": bounds["anneal_wide pair"]["bound_ms"],
         "shape": "qbm_main -hn 300 -r False's step QUBOs, G=2 B=60 n=301 R=100 S=10",
         "random_n717_ms": t("K4 Metropolis")[0], "random_n717_plain_ms": t("K4 Metropolis")[1],
         "random_n717_bound_ms": bounds["anneal_wide random n=717"]["bound_ms"],
         "random_n717_pair_ms": t("K4 pair")[0],
         "random_n717_pair_plain_ms": t("K4 pair")[1],
         "full_depth_ms": k4_full_ms,
         "full_depth_bound_ms": bounds["anneal_wide full depth"]["bound_ms"],
         "field_drift_max": drift_max, "field_drift_of_limit": drift_ratio,
         "field_one_add_short_of_limit": planted_ratio},
        {"name": "anneal_wide_sparse", "route": "cuda",
         "source": "qbmx_torch/csrc/anneal_wide_sparse.cu",
         "replaces": "qbmx/samplers/sa_lane.py:144",
         "also_replaces": "qbmx/samplers/sa_pallas.py:196",
         "path": "shared layout, sparse path (J_g's row lists in shared memory)",
         "launches": cdqbm_launches["a"]["anneal_wide_sparse"],
         "launches_on": "cdqbm_main CDQBM (a) (SA)",
         "max_abs_err": max(errs["anneal_wide_sparse"] + wide_rec["sparse_shared"]["max_abs_err"]),
         "differing_chains": max(fracs["anneal_wide_sparse"]
                                 + wide_rec["sparse_shared"]["differing_chains"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K4 sparse Metropolis")[0], "plain_ms": t("K4 sparse Metropolis")[1],
         **bound_keys("anneal_wide_sparse"),
         "pair_ms": t("K4 sparse pair")[0], "pair_plain_ms": t("K4 sparse pair")[1],
         "pair_bound_ms": bounds["anneal_wide_sparse pair"]["bound_ms"],
         "full_depth_ms": k4_cdqbm_ms,
         "full_depth_bound_ms": bounds["anneal_wide_sparse full depth"]["bound_ms"],
         "paths_in_turns_ms": k4_paths_ms,
         "restricted_h300_full_depth_bound_ms":
             bounds["anneal_wide_sparse restricted H=300 full depth"]["bound_ms"],
         "bit_for_bit_with_dense_path": wide_rec["sparse_shared"]["calls"],
         "training_bit_for_bit": wide_rec["sparse_shared"]["training"],
         "sweep_launches": {k: csweep_rec[f"a {k}"]["launches"] for k in ("SA", "BMS")},
         "sweep_full_depth_bound_ms":
             bounds["anneal_wide_sparse CDQBM (a) sweep G=20 full depth"]["bound_ms"]},
        {"name": "pt_wide", "route": "cuda", "source": "qbmx_torch/csrc/pt_wide.cu",
         "replaces": "qbmx/samplers/sa_pallas.py:196", "path": "dense (J_g in tiles)",
         "launches": launches["pt_wide"], "launches_on": "qbm_main --solver PT -hn 300",
         "max_abs_err": max(errs["pt_wide"]), "differing_chains": max(fracs["pt_wide"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K5 dense")[0], "plain_ms": t("K5 dense")[1], **bound_keys("pt_wide"),
         "full_depth_ms": k5_full_ms["dense"],
         "full_depth_bound_ms": bounds["pt_wide full depth"]["bound_ms"],
         "h300_pt_call": k5_h300,
         "drift_of_limit": k5_drift["dense"],
         "one_add_or_flip_short_of_limit": k5_planted["dense"]},
        {"name": "pt_wide_sparse", "route": "cuda", "source": "qbmx_torch/csrc/pt_wide.cu",
         "replaces": "qbmx/samplers/sa_pallas.py:196", "path": "sparse (J_g's row lists)",
         "launches": cdqbm_launches["a PT"]["pt_wide_sparse"],
         "launches_on": "cdqbm_main --solver PT (CDQBM (a))",
         "max_abs_err": max(errs["pt_wide_sparse"]),
         "differing_chains": max(fracs["pt_wide_sparse"]),
         "differing_chains_limit": MAX_DIFF_FRAC,
         "ms": t("K5 sparse")[0], "plain_ms": t("K5 sparse")[1], **bound_keys("pt_wide_sparse"),
         "full_depth_ms": k5_full_ms["sparse"],
         "full_depth_bound_ms": bounds["pt_wide_sparse full depth"]["bound_ms"],
         "cdqbm_a_pt_step_ms": step_ms["CDQBM a PT anneal1000"],
         "drift_of_limit": k5_drift["sparse"],
         "one_add_or_flip_short_of_limit": k5_planted["sparse"],
         "clusters": clusters, "active_clusters": active,
         "sweep_launches": csweep_rec["a PT"]["launches"],
         "sweep_s100_bound_ms": bounds["pt_wide_sparse CDQBM (a) sweep G=20 S=100"]["bound_ms"]},
        *({"name": name, "route": "cuda", "source": src, "replaces": "qbmx/samplers/sa_pallas.py:196",
           **({"also_replaces": "qbmx/samplers/sa_lane.py:144"} if key == "k4" else {}),
           "layout": layout,
           "launches": sum(r["launches"].get(name, 0)
                           for r in wide_rec["calls"][how]["trainer"].values()),
           "launches_on": f"qbm_main -hn 3400 {flag} " + solvers,
           "max_abs_err": wide_rec["max_abs_err"][name],
           "differing_chains": wide_rec["differing_chains"][name],
           "differing_chains_limit": MAX_DIFF_FRAC,
           "ms": wide_rec["calls"][how]["times_ms"][key],
           "plain_ms": wide_rec["calls"][how]["plain_ms"][key],
           "bound_ms": wide_rec["calls"][how]["bounds"][key]["bound_ms"],
           "bound_by": wide_rec["calls"][how]["bounds"][key]["bound_by"], "library_ms": None,
           **({"pair_ms": wide_rec["calls"][how]["times_ms"]["k4_pair"],
               "pair_plain_ms": wide_rec["calls"][how]["plain_ms"]["k4_pair"],
               "pair_bound_ms": wide_rec["calls"][how]["bounds"]["k4_pair"]["bound_ms"]}
              if key == "k4" else {}),
           "step_ms": {s_: wide_rec["calls"][how]["trainer"][s_]["step_ms"]
                       for s_ in solvers.split()}}
          for name, src, layout, key, how, flag, solvers in (
              ("anneal_wide_global", "qbmx_torch/csrc/anneal_wide.cu",
               "global fields, dense pass (n > 1056)", "k4", "dense", "-r False", "SA BMS"),
              ("anneal_wide_global_sparse", "qbmx_torch/csrc/anneal_wide.cu",
               "global fields, sparse pass (n > 1056, J_g at most SPARSE_DENSITY nonzeros)", "k4",
               "restricted", "(restricted)", "SA BMS"),
              ("pt_wide_global", "qbmx_torch/csrc/pt_wide.cu",
               "global path, dense pass (n > 1416 off the sparse path, or a ladder past a "
               "cluster; S + 1 launches a call)", "k5", "dense", "-r False", "PT"),
              ("pt_wide_global_sparse", "qbmx_torch/csrc/pt_wide.cu",
               "global path, sparse pass (as pt_wide_global, J_g at most SPARSE_DENSITY "
               "nonzeros; S + 1 launches a call)", "k5", "restricted", "(restricted)", "PT"))),
    ], "step_ms": step_ms, "cdqbm_launches": cdqbm_launches, "sweeps": sweep_rec,
        "cdqbm_sweeps": csweep_rec, "resume": resume_rec, "rbm": rbm_rec,
        "host_seams": host_rec, "mesh": mesh_rec,
        "wide": wide_rec, "scripts": scripts_rec, "bands": band_rec}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
