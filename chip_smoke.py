#!/usr/bin/env python3
"""Drive osqp_tpu_torch's main paths once on one CUDA GPU and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA device, ``nvcc`` and nothing of JAX.  Phases, in order; any
failure ends the run with a non-zero exit and no result line:

1. the card (nvidia-smi name and power limit) and the torch build;
2. build the kernels from ``osqp_tpu_torch/csrc`` and time the build;
3. K2 (chol_inverse) against its plain version on Schur matrices of the
   benchmark's data, n=100: B=512 in float64 and float32, and the main
   path's B=8192 in float32; the headline factor's inverse residual
   against the refine gate, which must flag 0 of 8192 instances, and how
   many the residual guard sends to Cholesky; n swept from 1 to the
   shared-memory bound in both dtypes, two launches bit-identical;
   kernel, plain and torch.linalg.inv timed at B=8192 beside the bound,
   with the kernel's blocks per SM; the library route above the bound
   (CVXQP2_M, both dtypes) timed as that case's library_ms; CVXQP2_S
   (B=1, n=100) timed beside its bound and torch.linalg.inv;
   then K2 above max_n (phase k2_route): the route dense_inv.init takes
   there (the blocked recursion on the leaf entry chol_inverse_leaf)
   against the plain route (the recursion on the plain leaves), the old
   library route and torch.linalg.inv, at the MPC cell (B=1000, n=372,
   float32), the portfolio leg (B=256, n=550, float32), CVXQP2_M (B=1,
   n=1000, both dtypes) and n = max_n + 1 (B=64, both dtypes): leaf
   launches a call and those of the leaf's cluster form (required at
   CVXQP2_M, four leaves of 256, 240, 256 and 248, and at B=64; excluded
   at the MPC cell and the portfolio), each leaf held against its plain version at
   the input the route gives it, the kernel route against the plain
   route, each route's worst residual against the refine gate (the
   kernel route's within the gate or 3x the other routes'), the
   instances the residual guard sends to Cholesky, times with and
   without the guard beside the bound, and the old tree's (leaves of
   max_n on one block each) where the cluster form runs; the leaf kernel
   timed at the portfolio's first leaf, its cluster form at CVXQP2_M's
   first leaf in both dtypes with every cluster size that fits;
4. K1 (admm_iter) against its plain version, one step from a random
   state: B=512 in float64 and float32 with half of the instances
   inactive, B=8192 in float32 half and all active, CVXQP2_M's shape at
   B=1 in both dtypes, and B=1, n=2, m=6000 in float64 (above what one
   block per instance could hold); every case launched twice and the two
   results held bit-identical; warm, L2-flushed and profiled device
   times beside the plain time and the bound at B=8192 and CVXQP2_M;
5. K4 (ruiz) against its plain version on the headline data (B=8192,
   n=100, m=200) in float32 and float64, which take the resident path in
   clusters of 2 and 4, and on CVXQP2_M (B=1, n=1000, m=1250, float64
   and float32), which takes the split path: D and E equal, c and the
   scaled data close, two launches bit-identical, the path each took
   checked against cluster_size; both timed, with the bound, and at the
   headline every cluster size that fits, with the clusters resident;
6. K3 (term_products) against its plain version at the same shapes from
   a random state, with and without the certificate products: one kernel
   launch a call (counted by the profiler, against
   term_products.launches_per_call), two calls bit-identical and sharing
   no output; both timed (warm, L2-flushed and device time), with the
   bound;
7. K1r (admm_iter_refined) against its plain version, one step from a
   random state, each case on the path refined_plan names (printed and
   required): B=512 in float64 and float32 with half of the instances
   inactive, B=8192 at the headline shape in float32 (all active) and
   float64 (half active), and the MPC cell's shape (B=1000, n=372, m=612,
   float32, its dense_inv factor; half and all active; the kernel also
   held against the float64 plain version on the same inputs, as K1's
   ill-conditioned case) on the resident path; CVXQP2_M's shape at B=1
   in both dtypes, B=1, n=2, m=6000 in float64 and B=1, n=m=3000 in
   float32 on the split path; two launches bit-identical; inactive
   instances bit-identical; the float32 carry held to TwoSum exactly;
   the float32 solve at CVXQP2_M held to a forward-error bound that a
   float32 residual misses; times as for K1; at the headline and MPC
   shapes every resident variant that fits (clusters of k, P's slab
   resident or not) and the split path timed in one call, and at the
   headline's n and m the resident path against the split path by B;
8. the batched slice on the GPU against the slice on the CPU (plain
   path), in float64 at B=64, n=20, m=30: equal statuses and iteration
   counts, x and y within 1e-6;
9. the batched slice at the repo's headline size through
   ``solve_batch``: B=8192, n=100, m=200, float32, eps 1e-3, polish off,
   with the kernel launch counts of that one solve (K4's on the resident
   path, which it must take), then 5 timed solves;
10. the stateful ``Solver`` path: README's quick start, CVXQP2_S and
    CVXQP2_M (read with ``osqp_tpu_torch.io.qps``) in float64 and
    float32, each held against the JAX package's results in
    ``tests/data/torch_goldens/solver_maros.npz``, and a warm re-solve
    after ``update_lin_cost`` held against the same sequence on the CPU;
    launch counts, loop body and times per solve; one more CVXQP2_M
    solve per dtype under the profiler, for ms per iteration and the
    K1/K1r device time per iteration;
11. K8 (kkt_lu_factor, kkt_lu_solve) against its plain versions: the
    ADMM-form K of the benchmark's data at B=512, N=75 in float64 and
    float32 (perm equal, lu and the solve within RTOL), the polish-form
    K_delta (delta 1e-6, the rows of A outside the active set that polish
    guesses at the ADMM point masked) of the headline data at B=8192,
    N=300 in float32 (the batched path) and of CVXQP2_S and CVXQP2_M at
    B=1, N=225 and 2250, in both dtypes (the cluster path and the strip
    solve); at every shape perm and lu bit for bit, through the K entry
    and through the blocks entry (kkt_lu_factor_blocks: P, A with the
    inactive rows zeroed, the shift and d, which polish and the kkt_lu
    backend call), each
    launched twice; the batched path at N = 1, 31, 33, 63, 65, 75 and 300
    at B = the SM count in both dtypes, through both entries;
    the solve of b = K x_true (x_true standard normal, so that the
    solution is known and O(1)) held three ways: its row-wise backward
    error against the factors it read under 8 sqrt(N) eps, its backward error
    against K under BACKWARD_BOUND, and its forward errors over the
    batch (64 right-hand sides at B=1), quantile by quantile, within
    RTOL plus three times the plain solve's (cond(K) sets both); two
    launches bit-identical; kernel (the factor through the blocks entry,
    which polish calls), plain and library (torch.linalg.lu_factor,
    lu_solve) times beside the bounds and the operations floor without
    fused multiply-adds, the kernel launches per factor and the path
    taken, the K entry's time and one factor's device time by kernel,
    and at CVXQP2_M the kernel's time over the library's;
12. polish, batched: the headline batch through ``solve_batch`` with
    polish off and on in one call: equal statuses and iterations, the
    share of status_polish == 1, every polished instance's residuals no
    larger than its ADMM residuals, K8 launched 4 + 16 times, polish ms;
    the same at B=512 with ``polish_dtype="float64"``; and the GPU
    against the CPU plain path in float64 at B=64, n=20, m=30;
13. polish, Solver: CVXQP2_S and CVXQP2_M with ``polish=True`` in both
    dtypes against the JAX package's results in
    ``tests/data/torch_goldens/solver_maros_polish.npz``: status,
    iterations, and at CVXQP2_S status_polish, x and y (float64 1e-6;
    float32 x 1e-3, y 1e-2); at CVXQP2_M, where the JAX package's polish
    is rejected and its x, y are the ADMM point, the objective to 1e-5
    and x to 1e-3; an accepted polish is also held to the optimum: its
    residuals recomputed in numpy float64, and x and the objective
    against the JAX package's float64 solve at eps 1e-10 (1e-7 in
    float64, 1e-5 in float32);
14. the kkt_lu backend: the headline data at B=1024 and CVXQP2_S
    through ``linsys_solver="kkt_lu"`` against the ``dense_inv`` run;
15. K5 (ell_ops) against its plain versions, bit for bit, on the sparse
    path's scaled operands of CVXQP2_L (B=1, float64 and float32) and of
    a scenario batch of CVXQP2_M (B=64, float64): every single product
    (A x, A'y, A'(rho y), the squared column sums, row and column norms,
    P's diagonal; one-job launches of the grouped kernel) and the final
    scaling, the grouped launches the path makes (P x with A x, a
    check's six products, a Ruiz sweep's three norms, the cg init's two)
    and eight products of every mode in one launch, and the fused CG
    start with and without its right-hand side; two launches
    bit-identical; A x, P x with A x and the fused start timed beside
    their plain versions, the library (``torch.sparse.mm`` on a CSR copy,
    the batch block-diagonal; for the start its product part, in two
    calls) and the bound, with host microseconds per call, and the
    scaling at CVXQP2_L; K5's launches in a sparse solve of the B=64
    batch;
16. K6 against its plain loop (summing in the kernel's order): one cg
    solve from a mid-solve ADMM state of CVXQP2_L (float64, ELL: the
    device loop, one launch) and of the headline data (dense, B=8192,
    float32, every fourth instance frozen: the step kernels): the same
    steps, x bit for bit, frozen instances bit-unchanged, two runs
    bit-identical; at CVXQP2_L the stepwise path on the same operator,
    bit for bit, and ms per CG step of both; the loop's plan (cluster
    size, width, what is resident, clusters in flight) and its device ms
    per CG step under the profiler beside the bound and its share; one
    step's vector work against the plain step and the bound;
17. the sparse path: ``solve_sparse`` (polish off) at CVXQP2_L in
    float64, LISWET1 in float64 and float32, and 8 copies of LISWET1
    with q scaled by 1 + 0.1 i, each held to the JAX package's results
    in ``tests/data/torch_goldens/sparse_maros.npz`` (float64: status and
    iterations equal, the objective within 1e-6, x and y within 1e-5 of
    the golden's largest entry, 1e-3 at CVXQP2_L; float32: status,
    iterations within 25),
    with launch counts (the CG on K6's device loop alone; K5's by kernel
    and per ADMM iteration), CG steps per ADMM iteration, setup and solve
    ms; at CVXQP2_L the same solve with the CG's start unfused (a
    measurement hook, unfused_start): x, y and iterations bit-identical,
    solve ms and K5 launches of both; at CVXQP2_L and the 8 copies the
    same solve on the stepwise path in the same call (a measurement hook,
    stepwise_everywhere): x, y and iterations bit-identical, solve ms, ms
    per CG step and launches of both, the loop's idle share under the
    profiler, its plan and device ms per CG step beside the bound;
    one more CVXQP2_L solve under the profiler for K5's and K6's device
    time and the idle share;
18. the cg backend on dense operands: ``solve_batch`` on the card against
    the CPU's plain path (float64, B=64, n=20, m=30), then the headline
    data at B=1024 in float32 beside the ``dense_inv`` run, with the step
    kernels' launches in that solve (the stepwise path's main user);
19. K7 (block_tridiag: bt_factor, bt_solve) against its plain versions:
    the warp path (b = 1, 5, 12, 16, 32) and the factor's cluster path (b
    = 40, 64) on random band matrices at B=200 in both dtypes, then on
    the reduced matrix of the MPC cell as the backend forms it
    (``bench.py``'s bench_mpc: B=1000, n=372, b=12, Nb=31, float32) and at
    B=64 in float64: factor and solve bit for bit, two launches
    bit-identical, the solve's backward error against M; kernel, plain
    and library (torch.linalg.cholesky of M, torch.cholesky_solve) times
    beside the bounds; then K7 above a warp (phase k7_device): the
    cluster path bit for bit at b = 33, 140 and 256 (float32) and 33, 99
    and 256 (float64) in every cluster size that fits, the device
    path at b = cluster_max_block + 1 (559 in float32, 362 in float64),
    at b = 849 in float64 (its band in device memory) and where named,
    factor and wide solve; the wide solve's quotient route against the
    division; stage-structured MPC batches at b = 140 (float32) and 99
    (float64) on the cluster path and at b = cluster_max_block + 1
    (float64) on the device path through solve_batch and the Solver
    against the CPU path (statuses and iterations equal, float64 x and y
    within 1e-6, the factor's path and the wide solve counted in both);
    the factor timed at the b = 140 and 99 batches by path and cluster
    size, and on the device path at the b = cluster_max_block + 1 batch,
    and the wide solve at the b = 140 and cluster_max_block + 1 batches,
    each beside the plain version, the library, the bound and the
    operations floor without fused multiply-adds;
    then the other dense backends' operators (phase dense_ops) against
    their ctypes launches, bit for bit: K7's factor (``bt_factor``) on
    the warp path at the MPC cell, the cluster path at b = 140 (f32) and
    the device path at b = 362 (f64, B = 1 to 4), its solve
    (``bt_solve``) in the warp and the wide layouts, K6's step
    (``cg_step``) on the cg backend's dense system at B=1024, three steps
    in turn, and the traced stepwise PCG (a ``while_loop`` of 8 operator
    steps, a ``cond`` for the tail) against the live stepwise path at a
    cap of 13; the operators' ms beside the launches';
20. the MPC cell through ``solve_batch`` with ``block_tridiag`` and with
    ``dense_inv`` (B=1000, float32, eps 1e-3, polish off): every
    instance solved, none at MAX_ITER, the same statuses in both legs,
    the first 16 scenarios against ``tests/data/torch_goldens/mpc.npz``,
    K7's launches (all on the warp path) and K1r's in the dense_inv leg
    (all on the resident path), the median of 5 timed solves per leg with QPs/s,
    set-up and ms per iteration, and one more solve per leg under the
    profiler (idle share, device time by kernel); then the ``Solver``
    with block_tridiag on scenario 0 in float64 against its golden, with
    K7's launches at B=1; then BatchedSolver (phases
    parametric_portfolio and parametric_mpc): bench.py's portfolio leg
    (B=256, n=550, float32; a cold solve, one untimed re-solve and 8
    timed re-solves with new q, each solved >= 0.99, the first 4
    instances against the CPU, re-solves per second, host reads per
    resolve, the set-up's time with the residual guard, which must send
    no instance to Cholesky and run no library inverse, device time by
    kernel)
    and the MPC cell as a 10-step receding horizon per backend (each
    step held to a fresh solve_batch, no refactor);
21. polish on the sparse path: polish's PCG on K6's device loop against
    the plain loop over the same products and against the stepwise path
    on LISWET1's polish system (PCG_CHECK_STEPS = 300 steps in each
    dtype): equal steps and x bit for bit, ms per CG step of both, the
    loop's plan and device ms per CG step beside the bound;
    then over K5's plain products for the record; ``solve_sparse`` with
    ``polish=True`` at LISWET1 (float64, float32), CVXQP2_L (float64) and
    2 copies of LISWET1 against ``sparse_polish.npz`` (status, iterations,
    status_polish, x and y), with the polished candidate's residuals, the
    ADMM point's, polish ms, the PCG steps of each solve and K6's
    launches in the polish; at LISWET1 (float64, float32) polish ms, ms
    per CG step, the loop's idle share and its device ms per CG step
    beside a polish step's bound, and in float32 the polish-on solve on
    the stepwise path in the same call, bit for bit; the ``SparseSolver`` on
    LISWET1: set-up, solve, update_lin_cost and a warm re-solve;
22. the Maros-Meszaros harness (phase maros): the native QPS parser
    (built from ``native/qps_parser.cpp``; its build time) against the
    Python parser on the 36 corpus files, equal problems, both times;
    ``maros.run_maros`` over the 36 rows on the card in float64 (eps
    1e-3, polish on): per row the route (dense bucket and its B, or
    sparse), status, iterations, status_polish, fallback, host_polish,
    the objective against MM_INDEX.json's published optimum, the port's
    kkt_check at the original data and the seconds, beside the JAX
    package's TPU float64 row (MAROS_r04_F64.json) and, for dense rows,
    its CPU float64 golden (maros_rows.npz); all 36 must pass (a final
    status and kkt_check ok), and the run must launch K1/K1r, K2, K3, K4,
    K8, K5 and K6's loop; the summary beside MAROS_r05.json's; the dense
    rows again in float32 with the float64 fallback, every row final;
    single mode (the Solver) on the rows with n <= 16;
23. the families suite (phase families): ``benchmarks.run_suite`` on the
    default ``generate_suite()`` (dims 10-250, 2 instances, ten families:
    100 instances) in float64 with polish on, each instance's status and
    pass equal to the JAX package's in
    ``tests/data/torch_goldens/families.npz``, iteration differences, the
    pass rate and the time per bucket chunk;
24. the differentiable layer (phase qp_layer): ``make_qp_layer`` at
    B=1024, n=100, m=200 in float64 (polish on, eps 1e-8) and at the
    headline batch in float32 (eps 1e-3, polish on): forward and backward
    of a weighted sum of x, the forward pass equal to ``solve_batch`` bit
    for bit, solved >= 0.99, the backward pass's launches (K8's blocks
    factor 1, its solve 4, K3 3) and no library LU under the profiler; in
    float64 the card's gradients on 4 polished instances against the CPU
    layer's and dq against central differences on 2; forward and
    backward ms, medians of 5;
25. instance compaction (phase compact): the headline batch with
    ``compact=True, min_compact_batch=256`` beside the plain solve: the
    sub-batch sizes, equal statuses, iterations equal where the bits
    agree, the instances that differ in some bit and x within 1e-4
    relative, wall ms of both, medians of 5;
26. the fixed-shape artifact (phase export), format 2: the headline
    shape in float32 with polish off and on and CVXQP2_M through
    ``Solver.export``; ``block_tridiag`` at the MPC cell and ``kkt_lu``,
    ``dense_chol`` and ``cg`` at the headline shape with B=1024 (each
    export split into trace, save and the operators' library, and held
    to the live unsegmented ``solve_batch``); LISWET1 in float64 with polish through
    ``SparseSolver.export`` and 8 LISWET1 copies through
    ``export_sparse_solver``; each loaded by a process that has torch
    alone and held to the live solve bit for bit, launching the card's
    kernels (K5's and K6's on the sparse blobs); the LISWET1 blob also
    against ``SparseSolver.solve`` (1e-6; 1e-5 after P's values x2
    through both), and so a format-1 LISWET1 blob (polish off), which
    ``load_sparse_solver`` still reads; blob sizes, export, load and call
    ms, host reads;
27. several devices (phase parallel), under a one-rank NCCL group that
    ``parallel.make_mesh`` starts: ``solve_batch_sharded`` at the
    headline, ``solve_single_sharded`` at dense QPs of n=1000, m=8000
    and m=2000 (float64, polish on), ``solve_single_sharded_sparse`` at
    CVXQP2_L (float64) and AUG3D (float64, polish on), each against its
    unsharded solve, every field bit for bit but the dense polished ones
    (the sharded polish solves the Schur complement, K8 the unsharded
    one: x, y and the residuals within 1e-6, the objective within 1e-9
    relative, and every bit of the unsharded solve whose polish takes the
    Schur branch), with its launch counts (the dense one must launch K3,
    K4's step entries, K6's cg_step and K2's leaf, no K8), its
    collectives by kind, its largest all-gather (at most B m), the wall
    ms of both, the dense polish's ms and peak memory beside K8's, K2's
    route on the polish's S beside its plain route, ``torch.linalg.inv``
    and the bound, AUG3D's PCG steps on K6's step kernels; both entries
    at a time limit of 1e-9 s, every field bit for bit with the unsharded
    solve at the same limit (status -6 at 200); K4's step entries on 4
    row blocks of the headline A and of CVXQP2_M's, the maxima merged as
    the collectives merge them, against ruiz bit for bit and timed; K3 on
    the same blocks with A'y's partials summed against K3 whole;
    ``allreduce_summary`` over ``run_maros(shard=(0, 1))`` of the HS rows.

Every time printed by phases 24-27 carries the card's name and power
limit.  Each phase ends with a line of its wall time, ``[name: s]``.
The timing legs of ``report_times`` after the warm one take at most
SIDE_REPS calls, which keeps the script under half its time limit.

The line before the last is a JSON object of the kernels (22 rows, K4's
step entries as ruiz_sweep; the
rows of K3 and K8 also give ``launches_backward``, the launches of one
backward pass of the float64 layer in phase 24;
K5's grouped products are ell_group, its fused CG start ell_cg_start and
its scaling ell_scale, K6's device loop is cg_loop, K1r's resident path
admm_iter_refined_resident, K7's cluster and device paths
block_tridiag_factor_cluster and block_tridiag_factor_device and its
wide solve block_tridiag_solve_wide, K2's leaf chol_inverse_leaf and its
cluster form chol_inverse_leaf_cluster); each row also names its
torch.library operator (``operator``, None for ruiz_sweep), and the rows
of K7 and K6's step give ``operator_ms`` from phase dense_ops; the last
line is the device JSON object.

``python3 chip_smoke.py --only k8,polish_solver`` runs the build and the
named phases alone (names: the ``phase_*`` functions' suffixes), for a
short look at one kernel on the card; it prints no result line and exits
with code 2, since a partial run proves nothing of the whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(B=8192, n=100, m=200)
SOLVE_KW = dict(dtype="float32", verbose=False, polish=False, eps_abs=1e-3, eps_rel=1e-3)
ROOT = os.path.dirname(os.path.abspath(__file__))
MAROS = os.path.join(ROOT, "tests", "data", "maros_mm")
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "solver_maros.npz")
POLISH_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "solver_maros_polish.npz")
SPARSE_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "sparse_maros.npz")
# Relative tolerances of a kernel against its plain version (largest
# difference over the largest plain value): order of summation differs.
RTOL = {"float64": 1e-12, "float32": 1e-5}
# Bound on the relative forward error of K1r's float32 solve at CVXQP2_M
# (cond(M) ~ 4.7e3): a float64 residual gives ~4e-8 there, a float32
# residual ~3e-7.
F64_RESIDUAL_BOUND = 1e-7
# Bound on the backward error |K x - b|max / (|K|inf |x|max) of K8's solve:
# a stable LU stays within a modest multiple of the unit roundoff.
BACKWARD_BOUND = {"float64": 1e-13, "float32": 1e-5}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def make_qps(B, n, m, seed=0, dtype=np.float32):
    """The benchmark's random strictly convex QPs (bench.py:31-42), made
    once for each set of arguments and shared, read-only, by the phases
    that ask for them again: the headline's take ~10 s of the host (numpy's
    einsum), and some fifteen phases use them."""
    return _make_qps(B, n, m, seed, np.dtype(dtype))


@functools.lru_cache(maxsize=None)
def _make_qps(B, n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n, dtype=dtype)
    q = rng.standard_normal((B, n)).astype(dtype)
    A = rng.standard_normal((B, m, n)).astype(dtype) / np.sqrt(n)
    xr = rng.standard_normal((B, n)).astype(dtype)
    Ax = np.einsum("bmn,bn->bm", A, xr)
    spread = np.abs(rng.standard_normal((B, m))).astype(dtype)
    l = Ax - spread - 0.1
    u = Ax + spread + 0.1
    for a in (P, q, A, l, u):
        a.setflags(write=False)
    return P, q, A, l, u


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# One H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and the peak rates
# outside the tensor cores, by type.  A bound is the larger of the bytes
# over the bandwidth and the operations over the peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
FLUSH_BYTES = 256 << 20  # written between calls to evict the 50 MB L2
# The kernels of K1 and K1r (csrc/admm_passes.cuh, admm_iter_refined.cu).
K1_KERNELS = ("colsum_kernel", "rowdot_kernel", "epilogue_kernel", "solve_finish_kernel")


def bound(nbytes, flops) -> tuple[float, str]:
    """(least ms, what bounds it): ``nbytes`` over the HBM rate against
    ``flops`` (a count per dtype name) over the peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms_flushed(fn, reps):
    """Mean milliseconds of ``fn()`` by CUDA events around each call, with
    the L2 cache flushed before each."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def profiled(fn, tries=3):
    """(fn's result, host ms, device events) of one call of ``fn`` under
    torch.profiler, ending in a synchronize.  Now and then the profiler
    hands back no device event at all for a window that ran kernels (K3's
    count of kernels a call read 0 so in one run on the H100); such a
    window is run again, up to ``tries`` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return out, wall, events


def kernel_label(name: str, width=90) -> str:
    """A kernel's name without its argument list, its return type and the
    anonymous namespace, template arguments kept: distinct instances of
    one template (update_kernel<float> and <double>, a panel kernel with
    and without its cluster) print apart."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def top_kernels(events, k=6) -> str:
    """The k kernels (by name, template arguments kept) with the most
    device time among ``events``, as "name ms (launches)"."""
    total, count = {}, {}
    for e in events:
        name = kernel_label(e.name)
        total[name] = total.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        count[name] = count.get(name, 0) + 1
    top = sorted(total, key=total.get, reverse=True)[:k]
    return "; ".join(f"{n} {total[n]:.3f} ms ({count[n]})" for n in top)


def event_ms(events, names=None) -> float:
    """Device milliseconds of the events whose name holds one of ``names``
    (all events when None)."""
    return sum(e.time_range.elapsed_us() for e in events if names is None or any(k in e.name for k in names)) / 1e3


# Calls a report_times leg other than the warm one takes at most (the
# flushed, profiled and plain legs), fewer than the warm leg's reps, to
# keep the script under half its time limit.
SIDE_REPS = 5


def report_times(label, fn, plain, reps, nbytes, flops):
    """Print and return a kernel's times: warm (back-to-back calls, ``reps``
    of them), with the L2 flushed before each call, and its device time
    per call from the profiler; its plain version's warm time; and its
    bound.  The legs after the warm one take min(reps, SIDE_REPS) calls."""
    import torch

    warm = cuda_ms(fn, reps)
    few = min(reps, SIDE_REPS)
    cold = cuda_ms_flushed(fn, few)
    fn()
    torch.cuda.synchronize()
    _, _, events = profiled(lambda: [fn() for _ in range(few)])
    dev_ms = event_ms(events) / few
    plain_ms = cuda_ms(plain, few, warmup=1)
    b, by = bound(nbytes, flops)
    device = f"{dev_ms:.4f} ms" if dev_ms > 0 else "not measured (no device events)"
    share = lambda t: f"{b / t:.3f}" if t > 0 else "not measured"
    print(f"{label}: kernel warm {warm:.4f} ms, L2-flushed {cold:.4f} ms, device time per call {device}; "
          f"plain {plain_ms:.4f} ms; bound {b:.4f} ms ({by}), share of bound warm {share(warm)}, "
          f"flushed {share(cold)}, device {share(dev_ms)}")
    return dict(ms=warm, plain_ms=plain_ms, bound_ms=b, bound_by=by)


def k1_cost(B, n, m, dtype):
    """(bytes, operations) of one K1 call: Minv, AMinvT and A read once, the
    vectors read and written once, a multiply-add per matrix value."""
    elt = 4 if dtype_name(dtype) == "float32" else 8
    nbytes = elt * B * (n * n + 2 * n * m + 5 * n + 10 * m) + B
    return nbytes, {dtype_name(dtype): 2 * B * (n * n + 2 * n * m)}


def k1r_cost(B, n, m, dtype):
    """(bytes, operations) of one K1r call: Minv, A and P read once, the
    vectors (and the float32 carry) read and written once; the products
    of 1 + ncorr passes over Minv, 2 over A and, per correction, the
    float64 residual's passes over A (two) and P."""
    f32 = dtype_name(dtype) == "float32"
    elt, ncorr = (4, 2) if f32 else (8, 1)
    nbytes = elt * B * (2 * n * n + m * n + 5 * n + (12 if f32 else 10) * m) + B
    flops = {dtype_name(dtype): 2 * B * ((1 + ncorr) * n * n + 2 * m * n)}
    f64 = 2 * B * ncorr * (2 * m * n + n * n)
    flops["float64"] = flops.get("float64", 0) + f64
    return nbytes, flops


def random_operands(B, n, m, dtype, dev, seed=5):
    """Operands of one ADMM step with random data: P = G G'/n + 0.1 I,
    A ~ N(0, 1/n), rho in [0.1, ...), Minv = (P + sigma I + A' rho A)^-1
    and AMinvT = Minv A', made in float64 on the card and cast; a random
    state, every instance active."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64, device=dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    G = r(B, n, n)
    P = G @ G.mT / n + 0.1 * eye
    A = r(B, m, n) / n**0.5
    rho = 0.1 + r(B, m).abs()
    sigma = 1e-6
    M = P + sigma * eye + A.mT @ (rho[:, :, None] * A)
    Minv = torch.cholesky_inverse(torch.linalg.cholesky(M))
    l = r(B, m) - 1.0
    ops = dict(Minv=Minv, AMinvT=Minv @ A.mT, A=A, P=P, q=r(B, n), l=l, u=l + 2.0, rho=rho, rho_inv=1.0 / rho,
               x=r(B, n), z=r(B, m), y=r(B, m), dx=r(B, n), dy=r(B, m))
    ops = {k: v.to(dtype).contiguous() for k, v in ops.items()}
    ops.update(sigma=sigma, alpha=1.6, active=torch.ones(B, dtype=torch.bool, device=dev))
    return ops


def k1_args(ops):
    return tuple(ops[k] for k in ("Minv", "AMinvT", "A", "q", "l", "u", "rho", "rho_inv", "sigma", "alpha", "active",
                                  "x", "z", "y", "dx", "dy"))


def k1r_args(ops, y_lo=None):
    return tuple(ops[k] for k in ("Minv", "A", "P", "q", "l", "u", "rho", "rho_inv", "sigma", "alpha", "active",
                                  "x", "z", "y", "dx", "dy")) + (y_lo,)


def on_device(arrays, dtype, dev):
    import torch

    return [torch.as_tensor(a, dtype=dtype, device=dev).contiguous() for a in arrays]


def rel_err(got, want) -> tuple[float, float]:
    """(largest |got - want|, that over the largest |want|)."""
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 1.0
    return diff, diff / (scale if scale > 0 else 1.0)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def maros_dense(name):
    """A Maros-Meszaros problem as dense (1, ...) arrays: full P, q, A, l, u."""
    from osqp_tpu_torch.io.qps import load_qps
    from osqp_tpu_torch.sparse import clamp_bounds, triu_to_full

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
    return (triu_to_full(qp.P)[None], qp.q[None], qp.A.toarray()[None], clamp_bounds(qp.l)[None],
            clamp_bounds(qp.u)[None])


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from osqp_tpu_torch.ops import admm_iter as k1, kkt_lu as k8, ruiz as k4, spd_inverse as k2, term_products as k3
    from osqp_tpu_torch.ops import block_tridiag as k7, cg as k6, ell as k5

    k1.launches = k1.refined_launches = k1.refined_launches_resident = k2.launches = k3.launches = k4.launches = k4.launches_resident = 0
    k4.launches_sweep = 0
    k2.launches_leaf = k2.launches_leaf_cluster = 0
    k8.launches_factor = k8.launches_solve = 0
    k5.launches = k5.launches_group = k5.launches_start = k5.launches_scale = 0
    k6.launches = k6.launches_loop = k6.launches_dense_loop = 0
    k7.launches_factor = k7.launches_solve = k7.launches_factor_warp = k7.launches_solve_warp = 0
    k7.launches_factor_cluster = k7.launches_factor_device = k7.launches_solve_wide = 0


def read_counts() -> dict:
    from osqp_tpu_torch.ops import admm_iter as k1, kkt_lu as k8, ruiz as k4, spd_inverse as k2, term_products as k3
    from osqp_tpu_torch.ops import block_tridiag as k7, cg as k6, ell as k5

    return {"admm_iter": k1.launches, "admm_iter_refined": k1.refined_launches,
            "admm_iter_refined_resident": k1.refined_launches_resident, "chol_inverse": k2.launches,
            "chol_inverse_leaf": k2.launches_leaf, "chol_inverse_leaf_cluster": k2.launches_leaf_cluster,
            "ruiz": k4.launches, "ruiz_resident": k4.launches_resident, "ruiz_sweep": k4.launches_sweep,
            "term_products": k3.launches,
            "kkt_lu_factor": k8.launches_factor, "kkt_lu_solve": k8.launches_solve, "ell_ops": k5.launches,
            "ell_group": k5.launches_group, "ell_cg_start": k5.launches_start, "ell_scale": k5.launches_scale,
            "cg_step": k6.launches, "cg_loop": k6.launches_loop, "cg_dense_loop": k6.launches_dense_loop,
            "bt_factor": k7.launches_factor,
            "bt_solve": k7.launches_solve, "bt_factor_warp": k7.launches_factor_warp,
            "bt_solve_warp": k7.launches_solve_warp, "bt_factor_cluster": k7.launches_factor_cluster,
            "bt_factor_device": k7.launches_factor_device, "bt_solve_wide": k7.launches_solve_wide}


def prepared(P, q, A, l, u):
    """Scaled data, rho state, dense_inv factor and settings of (B, ...)
    tensors, as the main path forms them."""
    import torch

    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.types import DynSettings

    (B, n), m, dtype = q.shape, l.shape[1], q.dtype
    s = solver.Settings(**{**SOLVE_KW, "dtype": dtype})
    cfg = solver.make_config(n, m, s, dtype)
    dyn = DynSettings.make(dtype)
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=q.device)
    scaled, _, rs, factor, _ = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
    return scaled, rs, factor, dyn


def path_operands(B, n, m, dtype, dev, seed=0):
    """prepared() of the benchmark's data."""
    return prepared(*on_device(make_qps(B, n, m, seed), dtype, dev))


def phase_k2(dev):
    import torch

    from osqp_tpu_torch.linsys import dense_inv
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.ops import spd_inverse as k2

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    # (B, dtype, bound on |I - M X|max for both paths, bound on |Xk - Xp|max / |Xp|max);
    # the last case is the main path's own shape and dtype.
    cases = ((512, torch.float64, 1e-10, 1e-10), (512, torch.float32, 1e-3, 1e-4), (B, torch.float32, 1e-3, 1e-4))
    for b, dtype, tol, rel_tol in cases:
        scaled, rs, factor, dyn = path_operands(b, n, m, dtype, dev)
        M = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
        Xk = k2.chol_inverse(M)
        Xp = k2.chol_inverse_plain(M)
        torch.cuda.synchronize()
        eye = torch.eye(n, dtype=dtype, device=dev)
        rk = float((eye - torch.bmm(M, Xk)).abs().max())
        rp = float((eye - torch.bmm(M, Xp)).abs().max())
        err = float((Xk - Xp).abs().max())
        rel = err / float(Xp.abs().max())
        print(f"K2 chol_inverse B={b} {dtype}: |I-MX|max kernel {rk:.3e} plain {rp:.3e}; "
              f"|Xk-Xp|max {err:.3e} relative {rel:.3e} (tol {tol:g}, relative {rel_tol:g})")
        require(rk <= tol and rp <= tol and rel <= rel_tol, f"K2 disagrees with its plain version at B={b} in {dtype}")

    # The headline's setup factor: the residual that dense_inv.init holds
    # against the refine gate, after Newton-Schulz and the guard, and how
    # many instances the guard sent to Cholesky.
    worst = float(dense_inv._inverse_residual(M, factor["Minv"]).max())
    gate = dense_inv._REFINE_TOL_F32
    flagged = int(factor["refine"].sum())
    guarded = int((dense_inv._inverse_residual(M, k2.spd_inverse(M)) > dense_inv._GUARD_TOL_F32).sum())
    print(f"K2 headline factor: |I-M Minv|max after Newton-Schulz {worst:.3e}, refine gate {gate:g} "
          f"({gate / worst:.2f}x above), refine flagged in {flagged} of {B} instances; residual guard sent "
          f"{guarded} of {B} to Cholesky")
    require(flagged == 0, f"the headline factor flags refine in {flagged} of {B} instances")

    # n from 1 to the shared-memory bound in both dtypes, on the test's
    # SPD matrices; two launches bit-identical.
    rng = np.random.default_rng(0)
    for dtype, rel_tol, sizes in ((torch.float32, 1e-4, (1, 7, 33, 100, 128, 239, 240)),
                                  (torch.float64, 1e-11, (1, 7, 33, 100, 128, 168, 169))):
        worst_n = 0.0
        for nn in sizes:
            G = rng.standard_normal((64, nn, nn))
            Mn = torch.as_tensor(G @ G.transpose(0, 2, 1) / nn + 0.1 * np.eye(nn), dtype=dtype, device=dev)
            Xa, Xb = k2.chol_inverse(Mn), k2.chol_inverse(Mn)
            torch.cuda.synchronize()
            require(torch.equal(Xa, Xb), f"K2's two launches differ at n={nn} in {dtype}")
            _, rel = rel_err(Xa, k2.chol_inverse_plain(Mn))
            require(rel <= rel_tol, f"K2 off by {rel:.3e} relative at n={nn} in {dtype}")
            worst_n = max(worst_n, rel)
        print(f"K2 chol_inverse B=64 {dtype_name(dtype)} n in {sizes}: worst relative difference {worst_n:.3e} "
              f"(tol {rel_tol:g}); two launches bit-identical")

    print(f"K2 chol_inverse n={n}: {k2.blocks_per_sm(n, torch.float32)} blocks per SM in float32, "
          f"{k2.blocks_per_sm(n, torch.float64)} in float64")
    ms = cuda_ms(lambda: k2.chol_inverse(M), reps=10)
    plain_ms = cuda_ms(lambda: k2.chol_inverse_plain(M), reps=10)
    library_ms = cuda_ms(lambda: torch.linalg.inv(M), reps=10)
    # M read and M^-1 written once; Cholesky, triangular inverse and T'T take
    # about n^3/3 operations each (n^3/6 multiply-adds), n^3 in all
    bound_ms, bound_by = bound(2 * 4 * B * n * n, {"float32": B * n**3})
    print(f"K2 chol_inverse B={B} n={n} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library torch.linalg.inv "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")

    # The Solver's shape: CVXQP2_S, B=1, n=100.
    for dtype, rel_tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        scaled, rs, _, dyn = prepared(*on_device(maros_dense("CVXQP2_S"), dtype, dev))
        Ms = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
        _, rel = rel_err(k2.chol_inverse(Ms), k2.chol_inverse_plain(Ms))
        require(rel <= rel_tol, f"K2 disagrees with its plain version at CVXQP2_S in {dtype}")
        ms_s = cuda_ms(lambda: k2.chol_inverse(Ms), reps=20)
        plain_s = cuda_ms(lambda: k2.chol_inverse_plain(Ms), reps=20)
        lib_s = cuda_ms(lambda: torch.linalg.inv(Ms), reps=20)  # library_ms only
        elt = Ms.element_size()
        bound_s, by_s = bound(2 * elt * 100 * 100, {dtype_name(dtype): 100**3})
        print(f"K2 chol_inverse CVXQP2_S B=1 n=100 {dtype_name(dtype)}: relative difference {rel:.3e}; "
              f"kernel {ms_s:.4f} ms, plain {plain_s:.4f} ms, library torch.linalg.inv {lib_s:.4f} ms; bound "
              f"{bound_s:.6f} ms ({by_s}), share of bound {bound_s / ms_s:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_k1(dev):
    import torch

    from osqp_tpu_torch.ops import admm_iter as k1

    n, m = HEADLINE["n"], HEADLINE["m"]

    def operands(B, dtype):
        scaled, rs, factor, dyn = path_operands(B, n, m, dtype, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype, device=dev)
        active = torch.arange(B, device=dev) % 2 == 0
        return (factor["Minv"], factor["AMinvT"], scaled.A, scaled.q, scaled.l, scaled.u,
                rs.rho_vec, rs.rho_inv_vec, float(dyn.sigma), float(dyn.alpha), active,
                rnd(B, n), rnd(B, m), rnd(B, m), rnd(B, n), rnd(B, m))

    def compare(args, rtol, label, ref64=False):
        """Kernel against plain on one step, and two launches against each
        other; returns the largest |k - p|.  With ref64 (an ill-conditioned
        float32 case, where the order of summation alone moves the result
        by about rtol), both are also held against the plain version in
        float64 on the same inputs, and the kernel must be within rtol of
        the plain version or no further from the float64 result than
        twice the plain version's distance."""
        outk = k1.admm_iter(*args)
        again = k1.admm_iter(*args)
        outp = k1.admm_iter_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(outk, again)), f"K1's two launches differ at {label}")
        active = args[10]
        worst = err = 0.0
        for name, ok_, op, before in zip(("x", "z", "y", "dx", "dy"), outk, outp, args[11:]):
            require(torch.equal(ok_[~active], before[~active]), f"K1 changed inactive {name} at {label}")
            diff, rel = rel_err(ok_, op)
            worst, err = max(worst, rel), max(err, diff)
        ok = worst <= rtol
        against = ""
        if ref64:
            wide = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
            out64 = k1.admm_iter_plain(*wide)
            err_k = max(rel_err(a.double(), b)[1] for a, b in zip(outk, out64))
            err_p = max(rel_err(a.double(), b)[1] for a, b in zip(outp, out64))
            ok = ok or err_k <= 2 * err_p
            against = f"; against float64 on the same inputs: kernel {err_k:.3e}, plain {err_p:.3e}"
        print(f"K1 admm_iter {label}: worst |k-p|max/|p|max over x,z,y,dx,dy {worst:.3e} (rtol {rtol:g}), "
              f"|k-p|max {err:.3e}{against}; inactive instances bit-identical; two launches bit-identical")
        require(ok, f"K1 disagrees with its plain version at {label}")
        return err

    compare(operands(512, torch.float64), 1e-12, "B=512 float64, half active")
    compare(operands(512, torch.float32), 1e-5, "B=512 float32, half active")
    B = HEADLINE["B"]
    half = operands(B, torch.float32)
    full = half[:10] + (torch.ones_like(half[10]),) + half[11:]
    err = max(compare(half, 1e-5, f"B={B} float32, half active"), compare(full, 1e-5, f"B={B} float32, all active"))

    ms = cuda_ms(lambda: k1.admm_iter(*half), reps=50)
    plain_ms = cuda_ms(lambda: k1.admm_iter_plain(*half), reps=50)
    print(f"K1 admm_iter B={B} n={n} m={m} f32 (half active): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    stats = report_times(f"K1 admm_iter B={B} n={n} m={m} float32 all active", lambda: k1.admm_iter(*full),
                         lambda: k1.admm_iter_plain(*full), 50, *k1_cost(B, n, m, torch.float32))

    # The Solver's shape: CVXQP2_M, B=1, n=1000, m=1250, in both dtypes.
    for dtype in (torch.float64, torch.float32):
        P, q, A, l, u = on_device(maros_dense("CVXQP2_M"), dtype, dev)
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        x, z, dx, y = _random_state(1, P.shape[1], A.shape[1], dtype, dev)
        one = (factor["Minv"], factor["AMinvT"], scaled.A, scaled.q, scaled.l, scaled.u, rs.rho_vec,
               rs.rho_inv_vec, float(dyn.sigma), float(dyn.alpha), torch.ones(1, dtype=torch.bool, device=dev),
               x, z, y, dx, torch.randn_like(z))
        label = f"CVXQP2_M B=1 n=1000 m=1250 {dtype_name(dtype)}"
        # the Solver runs K1r here in float32 (cond(M) ~ 4.7e3): held against float64 too
        compare(one, RTOL[dtype_name(dtype)], label, ref64=dtype == torch.float32)
        report_times(f"K1 admm_iter {label}", lambda: k1.admm_iter(*one), lambda: k1.admm_iter_plain(*one), 20,
                     *k1_cost(1, 1000, 1250, dtype))

    # Above what one block per instance could hold in shared memory.
    compare(k1_args(random_operands(1, 2, 6000, torch.float64, dev)), 1e-12, "B=1 n=2 m=6000 float64")
    return dict(max_abs_err=err, library_ms=None, **stats)


def phase_k4(dev):
    import torch

    from osqp_tpu_torch.ops import ruiz as k4

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    headline = make_qps(B, n, m)
    cvxqp = maros_dense("CVXQP2_M")
    # the headline on the resident path in float32 and, with a larger
    # cluster, in float64; CVXQP2_M on the split path in both dtypes
    cases = ((f"B={B} n={n} m={m} float32", headline, torch.float32),
             (f"B={B} n={n} m={m} float64", headline, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float64", cvxqp, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float32", cvxqp, torch.float32))
    stats = {}
    for label, arrays, dtype in cases:
        args = on_device(arrays, dtype, dev)
        B_, n_, m_ = args[2].shape[0], args[2].shape[2], args[2].shape[1]
        k = k4.cluster_size(n_, m_, dtype)
        path = f"resident, clusters of {k}" if k else "split"
        before = k4.launches_resident
        outk = k4.ruiz(*args, 10)
        again = k4.ruiz(*args, 10)
        outp = k4.ruiz_plain(*args, 10)
        torch.cuda.synchronize()
        require((k4.launches_resident - before == 2) == (k > 0), f"K4 took the wrong path at {label}")
        require(all(torch.equal(a, b) for a, b in zip(outk, again)), f"K4's two launches differ at {label}")
        tol = {"float64": 1e-12, "float32": 1e-6}[dtype_name(dtype)]
        for name, gk, gp in zip(("D", "E"), outk[1:3], outp[1:3]):
            require(torch.equal(gk, gp), f"K4 {name} differs from the plain version's at {label}")
        worst = err = 0.0
        for name, gk, gp in zip(("c", "P", "q", "A", "l", "u"), outk[:1] + outk[3:], outp[:1] + outp[3:]):
            diff, rel = rel_err(gk, gp)
            require(rel <= tol, f"K4 {name} off by {rel:.3e} relative at {label}")
            worst, err = max(worst, rel), max(err, diff)
        ms = cuda_ms(lambda: k4.ruiz(*args, 10), reps=10)
        plain_ms = cuda_ms(lambda: k4.ruiz_plain(*args, 10), reps=10)
        elt = args[0].element_size()
        # P, q, A, l, u read and written scaled once, D, E, c written; about three operations per matrix
        # value in each of 10 sweeps and two in the final scaling
        bound_ms, bound_by = bound(elt * B_ * (2 * (n_ * n_ + m_ * n_ + n_ + 2 * m_) + n_ + m_ + 1),
                                   {dtype_name(dtype): 32 * B_ * (n_ * n_ + m_ * n_)})
        print(f"K4 ruiz {label}: {path}; D, E bit-identical; two launches bit-identical; worst relative difference "
              f"over c, P, q, A, l, u {worst:.3e} (tol {tol:g}), |k-p|max {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
        if k and B_ == B:
            # every cluster size that fits this shape, for the choice of k
            sizes = [c for c in (1, 2, 4, 8) if k4.fits(n_, m_, c, dtype)]
            times = {c: cuda_ms(lambda: k4.launch(*args, 10, c), reps=10) for c in sizes}
            print(f"K4 ruiz {label}, resident path by cluster size: "
                  + ", ".join(f"k={c} {t:.4f} ms ({k4.resident_clusters(n_, m_, c, dtype)} clusters resident)"
                              for c, t in times.items()) + f" (chosen k={k})")
        stats[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
    return stats[cases[0][0]]


def _random_state(B, n, m, dtype, dev, seed=1):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, generator=g, dtype=dtype, device=dev) for s in ((B, n), (B, m), (B, n), (B, m))]


def k3_kernels_per_call(call, calls=3) -> float:
    """Device kernels per call of ``call`` (K3), by the profiler over
    ``calls`` calls.  The profiler may lose the records of the first or
    last kernels of a short window, so the calls sit between small
    kernels of another name, and the count holds only if every kernel
    recorded is K3's products_kernel or one of those."""
    import torch

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    padding = lambda: [pad.add_(1) for _ in range(8)]
    _, _, events = profiled(lambda: (padding(), [call() for _ in range(calls)], padding()))
    names = [kernel_label(e.name) for e in events]
    k3_count = sum("products_kernel" in name for name in names)
    others = [name for name in names if "products_kernel" not in name]
    require(all("elementwise" in name for name in others), f"K3's calls launched other kernels: {set(others)}")
    return k3_count / calls


def phase_k3(dev):
    import torch

    from osqp_tpu_torch.ops import ruiz as k4
    from osqp_tpu_torch.ops import term_products as k3

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    headline = make_qps(B, n, m)
    cvxqp = maros_dense("CVXQP2_M")
    cases = ((f"B={B} n={n} m={m} float32", headline, torch.float32),
             ("CVXQP2_M B=1 n=1000 m=1250 float64", cvxqp, torch.float64),
             ("CVXQP2_M B=1 n=1000 m=1250 float32", cvxqp, torch.float32))
    stats = {}
    for label, arrays, dtype in cases:
        _, _, _, P, _, A, _, _ = k4.ruiz(*on_device(arrays, dtype, dev), 10)  # the scaled data of the path
        x, y, dx, dy = _random_state(P.shape[0], P.shape[1], A.shape[1], dtype, dev)
        tol = RTOL[dtype_name(dtype)]
        err = worst = 0.0
        for cert in (False, True):
            extra = (dx, dy) if cert else ()
            outk = k3.term_products(P, A, x, y, *extra)
            outp = k3.term_products_plain(P, A, x, y, *extra)
            torch.cuda.synchronize()
            for name, gk, gp in zip(outk._fields, outk, outp):
                if gp is None:
                    require(gk is None, f"K3 returned {name} without certificates")
                    continue
                diff, rel = rel_err(gk, gp)
                require(rel <= tol, f"K3 {name} off by {rel:.3e} relative at {label}")
                worst, err = max(worst, rel), max(err, diff)
        # one kernel launch a call, with and without certificates, and fresh outputs every call
        B_, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        per_call = []
        for extra in ((), (dx, dy)):
            launched = k3_kernels_per_call(lambda: k3.term_products(P, A, x, y, *extra))
            per_call.append(launched)
            require(launched == k3.launches_per_call(B_, n_, m_, bool(extra)) == 1,
                    f"K3 took {launched} kernel launches a call at {label}")
        first, second = k3.term_products(P, A, x, y, dx, dy), k3.term_products(P, A, x, y, dx, dy)
        ptrs = {t.data_ptr() for t in first} & {t.data_ptr() for t in second}
        require(not ptrs and all(torch.equal(a, b) for a, b in zip(first, second)),
                f"K3: two calls share an output or differ at {label}")
        ms = cuda_ms(lambda: k3.term_products(P, A, x, y), reps=20)
        plain_ms = cuda_ms(lambda: k3.term_products_plain(P, A, x, y), reps=20)
        # with certificates: P, A, x, y, dx, dy read once, six products written; A x, A dx, A'y, A'dy and
        # P x, P dx take a multiply-add per matrix value each
        timed = report_times(f"K3 term_products {label} with certificates",
                             lambda: k3.term_products(P, A, x, y, dx, dy),
                             lambda: k3.term_products_plain(P, A, x, y, dx, dy), 20,
                             P.element_size() * B_ * (n_ * n_ + m_ * n_ + 6 * n_ + 4 * m_),
                             {dtype_name(dtype): B_ * (8 * m_ * n_ + 4 * n_ * n_)})
        ms_cert, plain_cert, bound_ms, bound_by = timed["ms"], timed["plain_ms"], timed["bound_ms"], timed["bound_by"]
        print(f"K3 term_products {label}: kernel launches per call {per_call[0]:g}, with certificates {per_call[1]:g} "
              f"(profiler); "
              f"two calls bit-identical, no output shared; worst relative difference {worst:.3e} (tol {tol:g}), "
              f"|k-p|max {err:.3e}; "
              f"Ax, Px, A'y: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; with certificates: kernel {ms_cert:.4f} ms, "
              f"plain {plain_cert:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), share of bound "
              f"{bound_ms / ms_cert:.3f}")
        stats[label] = dict(max_abs_err=err, ms=ms_cert, plain_ms=plain_cert, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
    return stats[cases[0][0]]


def phase_k1r(dev):
    import torch

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.ops import admm_iter as k1

    n, m = HEADLINE["n"], HEADLINE["m"]
    sms = _build.sm_count(dev)

    def operands(arrays, dtype, half=True):
        P, q, A, l, u = on_device(arrays, dtype, dev)
        B, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        x, z, dx, y = _random_state(B, n_, m_, dtype, dev, seed=2)
        dy = torch.randn_like(z)
        y_lo = 1e-7 * torch.randn_like(z) if dtype == torch.float32 else None
        active = torch.arange(B, device=dev) % 2 == 0 if half else torch.ones(B, dtype=torch.bool, device=dev)
        return (factor["Minv"], scaled.A, factor["P"], scaled.q, scaled.l, scaled.u, rs.rho_vec, rs.rho_inv_vec,
                float(dyn.sigma), float(dyn.alpha), active, x, z, y, dx, dy, y_lo)

    def path_of(args):
        """The plan's path for these operands, as "resident, clusters of k"
        or "split"."""
        B, n_, m_ = args[11].shape[0], args[11].shape[1], args[12].shape[1]
        kind, k = k1.refined_plan(B, n_, m_, args[11].dtype, sms)
        return kind, k

    def compare(args, label, ref64=False):
        """Kernel against plain on one step, two launches against each
        other, the carry against TwoSum; the path taken must be the plan's.
        With ref64 (the MPC cell's float32 data: equality rows with rho
        boosted 1e3 make M ill-conditioned, and the order of summation
        alone moves the step by about rtol), both are also held against
        the plain version in float64 on the same inputs, as K1's phase
        does: the kernel must be within rtol of the plain version or no
        further from the float64 result than twice the plain version's
        distance.  Returns the largest |k - p|."""
        kind, k = path_of(args)
        before = (k1.refined_launches, k1.refined_launches_resident)
        outk = k1.admm_iter_refined(*args)
        again = k1.admm_iter_refined(*args)
        took = (k1.refined_launches - before[0], k1.refined_launches_resident - before[1])
        outp = k1.admm_iter_refined_plain(*args)
        torch.cuda.synchronize()
        require(took == ((2, 2) if kind == "resident" else (2, 0)), f"K1r took another path than the plan's at {label}")
        require(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(outk, again)),
                f"K1r's two launches differ at {label}")
        active = args[10]
        tol = RTOL[dtype_name(args[11].dtype)]
        worst = err = 0.0
        for name, gk, gp, before in zip(("x", "z", "y", "dx", "dy", "y_lo"), outk, outp, args[11:]):
            if before is None:
                require(gk is None and gp is None, "K1r returned a carry it was not given")
                continue
            require(torch.equal(gk[~active], before[~active]), f"K1r changed inactive {name} at {label}")
            if name != "y_lo":  # the carry is held to TwoSum below
                diff, rel = rel_err(gk, gp)
                worst, err = max(worst, rel), max(err, diff)
        carry = ""
        if args[16] is not None:
            # (y', y_lo') must be exactly TwoSum(y, dy' + y_lo) on every active entry
            y, y_lo = args[13][active], args[16][active]
            bad_k = k1.twosum_violations(y, outk[4][active], y_lo, outk[2][active], outk[5][active])
            bad_p = k1.twosum_violations(y, outp[4][active], y_lo, outp[2][active], outp[5][active])
            carry = f"; TwoSum carry violated at {bad_k} (plain {bad_p}) of {y.numel()} active entries"
            require(bad_k == 0 and bad_p == 0, f"K1r's dual update is not TwoSum(y, dy + y_lo) at {label}")
        ok = worst <= tol
        against = ""
        if ref64:
            wide = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args[:16]]
            out64 = k1.admm_iter_refined_plain(*wide)
            err_k = max(rel_err(a.double(), b)[1] for a, b in zip(outk[:5], out64[:5]))
            err_p = max(rel_err(a.double(), b)[1] for a, b in zip(outp[:5], out64[:5]))
            ok = ok or err_k <= 2 * err_p
            against = f"; against float64 on the same inputs: kernel {err_k:.3e}, plain {err_p:.3e}"
        path = f"resident, clusters of {k}" if kind == "resident" else "split"
        print(f"K1r admm_iter_refined {label} ({path}): worst |k-p|max/|p|max over x,z,y,dx,dy {worst:.3e} "
              f"(rtol {tol:g}), |k-p|max {err:.3e}{against}; inactive instances bit-identical; two launches "
              f"bit-identical{carry}")
        require(ok, f"K1r disagrees with its plain version at {label}")
        return err

    def residual_check(name):
        """The float64 residual of the float32 solve.  With x = z = y = 0
        and alpha = 1, x' is the solve x~ of M x~ = -q exactly; a random q
        makes it a generic right-hand side.  Against M's float64 solve, the
        kernel must land within F64_RESIDUAL_BOUND, and the same two
        corrections with a float32 residual must not."""
        P, q, A, l, u = on_device(maros_dense(name), torch.float32, dev)
        scaled, rs, factor, dyn = prepared(P, q, A, l, u)
        B, n_, m_ = P.shape[0], P.shape[1], A.shape[1]
        rhs = torch.randn(B, n_, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        zn, zm = torch.zeros(B, n_, device=dev), torch.zeros(B, m_, device=dev)
        sigma = float(dyn.sigma)
        before = k1.refined_launches_resident
        x_k = k1.admm_iter_refined(factor["Minv"], scaled.A, factor["P"], rhs, scaled.l, scaled.u, rs.rho_vec,
                                   rs.rho_inv_vec, sigma, 1.0, torch.ones(B, dtype=torch.bool, device=dev),
                                   zn, zm, zm, zn, zm, zm)[0]
        require(k1.refined_launches_resident == before, f"K1r at {name} B=1 left the split path")
        A64, rho64 = scaled.A.double(), rs.rho_vec.double()
        M64 = (factor["P"].double() + sigma * torch.eye(n_, dtype=torch.float64, device=dev)
               + A64.transpose(1, 2) @ (rho64[:, :, None] * A64))
        truth = torch.linalg.solve(M64, -rhs.double())
        x32 = _solve_f32_residual(factor["Minv"], factor["P"], scaled.A, rs.rho_vec, dyn.sigma, -rhs)
        _, err_k = rel_err(x_k.double(), truth)
        _, err_32 = rel_err(x32.double(), truth)
        print(f"K1r float64 residual, {name} B=1 float32 (split): |x~ - x*|max/|x*|max kernel {err_k:.3e}, "
              f"with a float32 residual {err_32:.3e} (bound {F64_RESIDUAL_BOUND:g})")
        require(err_k <= F64_RESIDUAL_BOUND, f"K1r's solve at {name} is off by {err_k:.3e}: no float64 residual?")
        require(err_32 > F64_RESIDUAL_BOUND, f"the float64-residual check at {name} does not tell the residuals apart")

    def paths_timed(args, label):
        """Every resident variant that fits (clusters of k, P resident or
        read from device memory) and the split path, warm and L2-flushed,
        in one call: how the plan was fixed.  refined_bytes, by which the
        plan sizes a CTA's share, is held to the kernel's own layout."""
        B, n_, m_, dtype = args[11].shape[0], args[11].shape[1], args[12].shape[1], args[11].dtype
        rows = []
        lib = _build.library()
        for k in k1.CLUSTERS:
            for p_res in (True, False):
                nbytes = k1.refined_bytes(n_, m_, k, dtype, p_res)
                smem = lib.osqp_admm_iter_refined_resident_smem(_build.dtype_code(dtype), n_, m_, k, int(p_res))
                require(nbytes == smem, f"K1r: refined_bytes gives {nbytes} bytes, the kernel's layout {smem}")
                clusters = k1.resident_clusters(n_, m_, k, dtype, p_res, dev)
                if nbytes > _build.SMEM_BYTES or clusters <= 0:
                    continue
                fn = lambda: k1.launch_refined(*args, cluster=k, p_res=p_res)
                rows.append(f"k={k}{' P' if p_res else ''} {cuda_ms(fn, 10):.4f}/{cuda_ms_flushed(fn, 5):.4f} "
                            f"({clusters} clusters)")
        split = lambda: k1.launch_refined(*args, cluster=0)
        rows.append(f"split {cuda_ms(split, 10):.4f}/{cuda_ms_flushed(split, 5):.4f}")
        print(f"K1r paths at {label}, ms warm/flushed: " + "; ".join(rows))

    small = make_qps(512, n, m, seed=0, dtype=np.float64)
    compare(operands(small, torch.float64), "B=512 float64, half active")
    compare(operands(small, torch.float32), "B=512 float32, half active")
    B = HEADLINE["B"]
    head = operands(make_qps(B, n, m), torch.float32, half=False)
    err = compare(head, f"B={B} float32, all active")
    require(path_of(head)[0] == "resident", "K1r at the headline shape is not on the resident path")
    report_times(f"K1r admm_iter_refined B={B} n={n} m={m} float32 all active", lambda: k1.admm_iter_refined(*head),
                 lambda: k1.admm_iter_refined_plain(*head), 20, *k1r_cost(B, n, m, torch.float32))
    paths_timed(head, f"B={B} n={n} m={m} float32")
    del head
    head64 = operands(make_qps(B, n, m, dtype=np.float64), torch.float64)
    err = max(err, compare(head64, f"B={B} float64, half active"))
    require(path_of(head64)[0] == "resident", "K1r at the headline shape in float64 is not on the resident path")
    report_times(f"K1r admm_iter_refined B={B} n={n} m={m} float64 half active",
                 lambda: k1.admm_iter_refined(*head64), lambda: k1.admm_iter_refined_plain(*head64), 10,
                 *k1r_cost(B // 2, n, m, torch.float64))
    del head64
    # the MPC cell's shape, its dense_inv factor: where K1r runs on batches
    mpc = mpc_scenarios()[1:]
    B_mpc, n_mpc, m_mpc = mpc[0].shape[0], mpc[0].shape[1], mpc[2].shape[1]
    mpc_half = operands(mpc, torch.float32)
    compare(mpc_half, f"MPC B={B_mpc} n={n_mpc} m={m_mpc} float32, half active", ref64=True)
    mpc_all = mpc_half[:10] + (torch.ones_like(mpc_half[10]),) + mpc_half[11:]
    err_mpc = compare(mpc_all, f"MPC B={B_mpc} n={n_mpc} m={m_mpc} float32, all active", ref64=True)
    split_mpc = k1.launch_refined(*mpc_all, cluster=0)
    print(f"  the split path at the same MPC operands against plain: worst relative "
          f"{max(rel_err(a, b)[1] for a, b in zip(split_mpc[:5], k1.admm_iter_refined_plain(*mpc_all)[:5])):.3e}")
    del split_mpc
    require(path_of(mpc_all)[0] == "resident", "K1r at the MPC shape is not on the resident path")
    mpc_stats = report_times(f"K1r admm_iter_refined MPC B={B_mpc} n={n_mpc} m={m_mpc} float32 all active",
                             lambda: k1.admm_iter_refined(*mpc_all), lambda: k1.admm_iter_refined_plain(*mpc_all),
                             10, *k1r_cost(B_mpc, n_mpc, m_mpc, torch.float32))
    paths_timed(mpc_all, f"MPC B={B_mpc} float32")
    del mpc_half, mpc_all
    # the crossover in B at the headline's n and m
    big = operands(make_qps(sms * 2, n, m), torch.float32, half=False)
    rows = []
    for Bc in (1, 16, sms // 2, sms, 2 * sms):
        sub = tuple(a[:Bc].contiguous() if torch.is_tensor(a) else a for a in big)
        res = lambda: k1.launch_refined(*sub, cluster=1)
        spl = lambda: k1.launch_refined(*sub, cluster=0)
        rows.append(f"B={Bc} {cuda_ms(res, 20):.4f}/{cuda_ms(spl, 20):.4f} (plan {path_of(sub)[0]})")
    print(f"K1r n={n} m={m} float32, resident k=1 / split ms warm by B: " + "; ".join(rows))
    cvxqp = maros_dense("CVXQP2_M")
    for dtype in (torch.float64, torch.float32):
        args = operands(cvxqp, dtype, half=False)
        label = f"CVXQP2_M B=1 n=1000 m=1250 {dtype_name(dtype)}"
        require(path_of(args)[0] == "split", f"K1r at {label} is not on the split path")
        err = max(err, compare(args, label))
        stats = report_times(f"K1r admm_iter_refined {label}", lambda: k1.admm_iter_refined(*args),
                             lambda: k1.admm_iter_refined_plain(*args), 10, *k1r_cost(1, 1000, 1250, dtype))
    # Above what one block per instance could hold in shared memory.
    compare(k1r_args(random_operands(1, 2, 6000, torch.float64, dev)), "B=1 n=2 m=6000 float64")
    big = random_operands(1, 3000, 3000, torch.float32, dev)
    compare(k1r_args(big, 1e-7 * torch.randn_like(big["y"])), "B=1 n=3000 m=3000 float32")
    residual_check("CVXQP2_M")
    # stats: CVXQP2_M in float32, the shape and body of the Solver's K1r
    # launches (split); mpc_stats: the MPC shape (resident)
    return (dict(max_abs_err=err, library_ms=None, **stats),
            dict(max_abs_err=err_mpc, library_ms=None, **mpc_stats))


def _solve_f32_residual(Minv, P, A, rho, sigma, t):
    """The refined float32 solve with its two residuals taken in float32:
    what K1r would give if it skipped the float64 residual."""
    from osqp_tpu_torch.linalg import mat_tvec, mat_vec

    apply_inv = lambda v: mat_tvec(Minv, v)
    x = apply_inv(t)
    for _ in range(2):
        x = x + apply_inv(t - (mat_vec(P, x) + sigma * x + mat_tvec(A, rho * mat_vec(A, x))))
    return x



def phase_parity(dev):
    import torch

    import osqp_tpu_torch as ot

    P, q, A, l, u = make_qps(64, 20, 30, seed=3, dtype=np.float64)
    kw = dict(dtype="float64", verbose=False)
    rg = ot.solve_batch(P, q, A, l, u, device=dev, **kw)
    rc = ot.solve_batch(P, q, A, l, u, device="cpu", **kw)
    same_status = torch.equal(rg.status_val.cpu(), rc.status_val)
    same_iter = torch.equal(rg.iter.cpu(), rc.iter)
    dx = float((rg.x.cpu() - rc.x).abs().max())
    dy = float((rg.y.cpu() - rc.y).abs().max())
    print(f"slice GPU vs CPU, f64 B=64 n=20 m=30: statuses equal {same_status}, iterations equal {same_iter}, "
          f"|dx|max {dx:.3e}, |dy|max {dy:.3e}")
    require(same_status and same_iter and dx <= 1e-6 and dy <= 1e-6, "GPU slice disagrees with the CPU slice")


def phase_headline(dev):
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.types import DynSettings

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    P, q, A, l, u = on_device(make_qps(B, n, m), torch.float32, dev)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res = ot.solve_batch(P, q, A, l, u, **SOLVE_KW)
    status = res.status_val.cpu().numpy()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    iters = res.iter.cpu().numpy()
    solved = float(np.mean(status == ot.OSQP_SOLVED))
    x = res.x.cpu().numpy()
    print(f"headline B={B} n={n} m={m} f32: first solve {first_s:.3f} s, solved {solved:.4f}, "
          f"iterations mean {iters.mean():.2f} max {iters.max()}, launches {launches}")
    require(solved >= 0.99, f"solved fraction {solved} < 0.99")
    require(not np.any(status == ot.OSQP_MAX_ITER_REACHED), "an instance hit MAX_ITER_REACHED")
    require(np.isfinite(x[status == ot.OSQP_SOLVED]).all(), "non-finite x in a solved instance")
    require(x.shape == (B, n) and res.y.shape == (B, m), "result shapes")
    for name in ("admm_iter", "chol_inverse", "ruiz", "term_products"):
        require(launches[name] > 0, f"{name}, a kernel of the batched path, never launched")
    require(launches["ruiz_resident"] == launches["ruiz"], "the headline's K4 did not take the resident path")
    require(launches["kkt_lu_factor"] == launches["kkt_lu_solve"] == 0, "K8 launched with polish off")
    require(launches["ell_ops"] == launches["cg_step"] == launches["cg_dense_loop"] == 0,
            "K5 or K6 launched on the dense_inv path")
    require(launches["chol_inverse_leaf_cluster"] == 0, "a K2 leaf took the cluster form at the headline")

    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ot.solve_batch(P, q, A, l, u, **SOLVE_KW)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))

    s = solver.Settings(**SOLVE_KW)
    cfg = solver.make_config(n, m, s, torch.float32)
    dyn = DynSettings.make(torch.float32)
    rho0 = torch.full((B,), s.rho, dtype=torch.float32, device=dev)
    setup_ms = cuda_ms(lambda: batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None), reps=3, warmup=1)

    med = statistics.median(times)
    loop_iters = int(iters.max())
    per_iter = (med - setup_ms) / loop_iters
    print(f"headline timed solves (ms, CUDA events, data on device): {[round(t, 3) for t in times]}")
    print(f"headline median {med:.3f} ms, spread {min(times):.3f}..{max(times):.3f} ms, "
          f"{B / (med / 1e3):.1f} QPs/s (median), {B / (min(times) / 1e3):.1f}..{B / (max(times) / 1e3):.1f} QPs/s")
    print(f"headline setup (scale + rho + factor) {setup_ms:.3f} ms; loop {med - setup_ms:.3f} ms over "
          f"{loop_iters} iterations = {per_iter:.4f} ms/iteration (incl. checks and rho updates)")
    return launches


def phase_solver(dev):
    """The stateful Solver path.  Counts are set to 0 before the phase and
    read after it; each solve also prints its own."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.io.qps import load_qps

    gold = np.load(GOLDENS)
    reset_counts()
    total = dict.fromkeys(read_counts(), 0)

    def run(label, make, cpu_make=None):
        before = read_counts()
        s = make(dev)
        r = s.solve()
        after = read_counts()
        delta = {k: after[k] - before[k] for k in after}
        for k in total:
            total[k] += delta[k]
        body = "+".join(b for b, k in (("plain K1", "admm_iter"), ("refined K1r", "admm_iter_refined")) if delta[k])
        it = max(r.info.iter, 1)
        print(f"Solver {label}: {r.info.status}, {r.info.iter} iterations, {r.info.rho_updates} rho updates, "
              f"obj {r.info.obj_val!r}; body {body or 'none'}; setup {s.info.setup_time * 1e3:.3f} ms, "
              f"solve {r.info.solve_time * 1e3:.3f} ms, {r.info.solve_time * 1e3 / it:.4f} ms/iteration; "
              f"launches {delta}")
        require(np.isfinite(r.x).all() and r.x.shape == (s.n,) and r.y.shape == (s.m,), f"Solver {label}: x, y")
        return s, r, delta

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    quick = (P, np.array([1.0, 1.0]), A, np.array([1.0, 0.0, 0.0]), np.array([1.0, 0.7, 0.7]))
    for dtype in ("float64", "float32"):
        _, r, _ = run(f"quick start {dtype}", lambda d: ot.Solver(*quick, device=d, dtype=dtype, verbose=False))
        require(r.info.status_val == ot.OSQP_SOLVED and np.abs(r.x - [0.3, 0.7]).max() < 1e-2,
                f"quick start {dtype}: x = {r.x}")

    for name in ("CVXQP2_S", "CVXQP2_M"):
        qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
        data = (qp.P, qp.q, qp.A, qp.l, qp.u)
        for dtype in ("float64", "float32"):
            g = lambda f: gold[f"{name}/{dtype}/{f}"]
            label = f"{name} n={qp.n} m={qp.m} {dtype}"
            s, r, delta = run(label, lambda d: ot.Solver(*data, device=d, dtype=dtype, polish=False, verbose=False))
            require(r.info.status_val == int(g("status_val")), f"{label}: status {r.info.status}")
            if dtype == "float64":
                same = (r.info.iter, r.info.rho_updates) == (int(g("iter")), int(g("rho_updates")))
                obj_rel = abs(r.info.obj_val - float(g("obj_val"))) / abs(float(g("obj_val")))
                print(f"  against the JAX package (CPU, goldens): iterations {r.info.iter} / {int(g('iter'))}, "
                      f"rho updates {r.info.rho_updates} / {int(g('rho_updates'))}, obj relative {obj_rel:.3e}, "
                      f"|dx|max {np.abs(r.x - g('x')).max():.3e}, |dy|max {np.abs(r.y - g('y')).max():.3e}")
                require(same and obj_rel <= 1e-6, f"{label} disagrees with the JAX package's run")
            else:
                print(f"  against the JAX package (CPU, goldens): iterations {r.info.iter} / {int(g('iter'))}")
                require(abs(r.info.iter - int(g("iter"))) <= 25, f"{label}: iterations {r.info.iter}")
                if name == "CVXQP2_M":
                    require(delta["admm_iter_refined"] > 0, f"{label}: the refined body (K1r) did not run")
            if name == "CVXQP2_S":
                require(delta["chol_inverse"] > 0, f"{label}: K2 did not factor")

    # Where a CVXQP2_M solve's time goes: one more solve in each dtype,
    # under the profiler (outside the counts above).
    qp = load_qps(os.path.join(MAROS, "CVXQP2_M.qps"))
    for dtype in ("float64", "float32"):
        s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype=dtype, polish=False, verbose=False)
        r, wall, events = profiled(s.solve)
        it = max(r.info.iter, 1)
        k1_ms, busy = event_ms(events, K1_KERNELS), event_ms(events)
        print(f"Solver CVXQP2_M {dtype} under the profiler: wall {wall:.3f} ms over {r.info.iter} iterations = "
              f"{wall / it:.4f} ms/iteration; K1/K1r device time {k1_ms:.3f} ms = {k1_ms / it:.4f} ms/iteration "
              f"({k1_ms / wall:.3f} of the wall); device busy {busy:.3f} ms, idle share {1.0 - busy / wall:.3f}")

    # a warm re-solve after update_lin_cost, against the same sequence on the CPU
    qp = load_qps(os.path.join(MAROS, "CVXQP2_S.qps"))
    q2 = qp.q * 1.1 + 1.0
    results = []
    for d in (dev, torch.device("cpu")):
        s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=d, dtype="float64", verbose=False)
        s.solve()
        if d == dev:
            before = read_counts()
        s.update_lin_cost(q2)
        r = s.solve()
        if d == dev:
            after = read_counts()
            for k in total:
                total[k] += after[k] - before[k]
        results.append(r)
    rg, rc = results
    print(f"Solver warm re-solve after update_lin_cost, CVXQP2_S float64: GPU {rg.info.status}, {rg.info.iter} "
          f"iterations, solve {rg.info.solve_time * 1e3:.3f} ms; CPU {rc.info.status}, {rc.info.iter} iterations; "
          f"|dx|max {np.abs(rg.x - rc.x).max():.3e}, |dy|max {np.abs(rg.y - rc.y).max():.3e}")
    require(rg.info.status_val == rc.info.status_val == ot.OSQP_SOLVED and rg.info.iter == rc.info.iter
            and np.abs(rg.x - rc.x).max() <= 1e-6 and np.abs(rg.y - rc.y).max() <= 1e-6,
            "warm re-solve on the GPU disagrees with the CPU")

    print(f"Solver path launches: {total}")
    for name, n_launch in total.items():
        if name.startswith("kkt_lu"):  # polish is off here: K8 must stay out of it
            require(n_launch == 0, f"{name} launched on the Solver path with polish off")
        elif name in ("ell_ops", "ell_group", "ell_cg_start", "ell_scale", "cg_step", "cg_loop", "cg_dense_loop",
                      "bt_factor",
                      "bt_solve", "bt_factor_warp",
                      "bt_solve_warp", "bt_factor_cluster", "bt_factor_device",
                      "bt_solve_wide", "ruiz_sweep"):  # other backends' kernels, the row-sharded path's K4 steps
            require(n_launch == 0, f"{name} launched on the dense_inv Solver path")
        elif name == "admm_iter_refined_resident":  # B = 1: K1r's split path spreads the instance over the card
            require(n_launch == 0, "K1r took the resident path on the Solver path (B = 1)")
        else:
            require(n_launch > 0, f"{name} never launched on the Solver path")
    return total


def polish_blocks(args, dtype, delta=1e-6):
    """The blocks of the K_delta that polish's first pass factors for the
    problems ``args`` (P, q, A, l, u on the card): they are solved with
    polish off, the active set is guessed at the ADMM point as polish
    guesses it (lower where z - l < -y, upper where u - z < y), and the
    other rows of the scaled A are zeroed.  Returns (P, M A, delta, d) of
    the scaled data, as polish hands them to kkt_lu_factor_blocks, and the
    active rows per instance."""
    import torch

    import osqp_tpu_torch as ot

    P, q, A, l, u = args
    res = ot.solve_batch(*args, **{**SOLVE_KW, "dtype": dtype_name(dtype)})
    z = torch.minimum(torch.maximum(torch.bmm(A, res.x[:, :, None])[:, :, 0], l), u)
    mask = ((z - l < -res.y) | (u - z < res.y)).to(dtype)
    del res
    scaled, _, _, _ = prepared(*args)
    dvec = torch.full(mask.shape, delta, dtype=dtype, device=A.device)
    return (scaled.P, mask[:, :, None] * scaled.A, delta, dvec), mask.sum(-1)


def polish_kkt(args, dtype, delta=1e-6):
    """K_delta itself (polish_blocks's, formed) and the active rows per
    instance."""
    blocks, rows = polish_blocks(args, dtype, delta)
    return blocks_kkt(blocks), rows


def random_blocks(B, n, m, dtype, dev, seed, masked):
    """Blocks of a KKT matrix from random data made in float64: polish's
    form (shift = d = 1e-6, about half the rows of A zeroed) or the ADMM
    form (shift 1e-6, d = 1/rho)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64, device=dev)
    G = r(B, n, n)
    P = G @ G.mT / n + 0.1 * torch.eye(n, dtype=torch.float64, device=dev)
    A = r(B, m, n) / n**0.5
    if masked:
        A, d = A * (r(B, m) > 0)[:, :, None], torch.full((B, m), 1e-6, dtype=torch.float64, device=dev)
    else:
        d = 1.0 / (0.1 + r(B, m).abs())
    T = lambda t: t.to(dtype).contiguous()
    return T(P), T(A), 1e-6, T(d)


def blocks_kkt(blocks):
    """form_kkt's K of kkt_lu_factor_blocks's arguments."""
    from osqp_tpu_torch.ops.kkt_lu import form_kkt

    return form_kkt(*blocks).contiguous()


def k8_cost(B, N, dtype, n=None):
    """((bytes, operations) of the factor, of the solve): K (or, given n,
    its blocks P, A and d) read and lu written once and (2/3) N^3
    operations an instance; lu, perm and b read and x written once and
    2 N^2 operations."""
    name = dtype_name(dtype)
    elt = 4 if name == "float32" else 8
    read = N * N if n is None else n * n + (N - n) * (n + 1)
    factor = (B * (elt * (read + N * N) + 4 * N), {name: 2 * B * N**3 // 3})
    solve = (B * (elt * N * N + 4 * N + 2 * elt * N), {name: 2 * B * N * N})
    return factor, solve


def phase_k8(dev):
    import torch

    from osqp_tpu_torch.ops import kkt_lu as k8

    def compare(K, label, blocks=None):
        """Factor (through the K entry and, given ``blocks``, the blocks
        entry) and solve against the plain versions; returns the
        largest |lu_k - lu_p| and the largest |x_k - x_p|.  The right-hand
        side is K x_true for a standard normal x_true, so that the solution
        is known and O(1) in every component: under a random b the masked
        rows of K_delta give |x| ~ b / delta, and a tolerance relative to
        that largest entry could not fail a wrong solve."""
        name = dtype_name(K.dtype)
        lu, perm = k8.kkt_lu_factor(K)
        lu2, perm2 = k8.kkt_lu_factor(K)
        lp, pp = k8.kkt_lu_factor_plain(K)
        require(torch.equal(lu, lu2) and torch.equal(perm, perm2), f"K8's two factor launches differ at {label}")
        del lu2, perm2
        same_perm, same_lu = torch.equal(perm, pp), torch.equal(lu, lp)
        err, rel = rel_err(lu, lp)
        if blocks is not None:
            lb, pb = k8.kkt_lu_factor_blocks(*blocks)
            lb2, pb2 = k8.kkt_lu_factor_blocks(*blocks)
            require(torch.equal(lb, lb2) and torch.equal(pb, pb2), f"K8's two blocks-entry launches differ at {label}")
            same_blocks = torch.equal(lb, lp) and torch.equal(pb, pp)
            print(f"K8 kkt_lu_factor_blocks {label}: lu and perm bit-identical to plain {same_blocks}; two launches "
                  f"bit-identical")
            require(same_blocks, f"K8's blocks entry disagrees with its plain version at {label}")
            del lb, lb2, pb, pb2
        # A small batch is solved for 64 right-hand sides, each on a copy of
        # the factors, so that the forward errors below have a distribution
        # at B=1 too: one sample of a forward error says little.
        copies = max(1, 64 // K.shape[0])
        if copies > 1:
            K, lu, perm, lp, pp = (t.repeat(copies, *[1] * (t.dim() - 1)) for t in (K, lu, perm, lp, pp))
        K64 = K.double()
        x_true = torch.randn(K.shape[:2], generator=torch.Generator(device=dev).manual_seed(7), dtype=torch.float64,
                             device=dev)
        b64 = torch.bmm(K64, x_true[:, :, None])[:, :, 0]
        b = b64.to(K.dtype)
        x, x2 = k8.kkt_lu_solve(lu, perm, b), k8.kkt_lu_solve(lu, perm, b)
        xp = k8.kkt_lu_solve_plain(lp, pp, b)
        torch.cuda.synchronize()
        require(torch.equal(x, x2), f"K8's two solve launches differ at {label}")
        require(bool(torch.isfinite(lu).all()) and bool(torch.isfinite(x).all()), f"K8 is not finite at {label}")
        err_x, rel_x = rel_err(x, xp)
        x64, xp64, scale = x.double(), xp.double(), x_true.abs().amax(-1)
        resid = (torch.bmm(K64, x64[:, :, None])[:, :, 0] - b.double()).abs().amax(-1)
        backward = float((resid / (K64.abs().sum(-1).amax(-1) * x64.abs().amax(-1))).max())
        del K64
        # The substitutions alone, whatever cond(K) is: against the factors
        # they read, both triangular solves are backward stable row by row,
        # |L U x - b[perm]| <= c N eps (|L| |U| |x| + |b[perm]|); held to the
        # probabilistic form of that bound, 8 sqrt(N) eps.
        lu64 = lu.double()
        U, L = torch.triu(lu64), torch.tril(lu64, -1)
        del lu64
        L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
        pb = torch.gather(b.double(), 1, perm.long())

        def through(v):
            return torch.bmm(L, torch.bmm(U, v[:, :, None]))[:, :, 0]

        r_k, r_p = (through(x64) - pb).abs(), (through(xp64) - pb).abs()
        L.abs_(), U.abs_()
        rowwise_k = float((r_k / (through(x64.abs()) + pb.abs())).max())
        rowwise_p = float((r_p / (through(xp64.abs()) + pb.abs())).max())
        del L, U
        rowwise_bound = 8 * K.shape[1] ** 0.5 * torch.finfo(K.dtype).eps
        # Against the plain solve: the two read the same factors and differ
        # in the order of their sums (the kernel takes dot products by rows,
        # the plain version updates by columns), so each lies within its own
        # forward error of x_true, which cond(K) sets.  The kernel's forward
        # errors over the batch are held, quantile by quantile, to RTOL plus
        # three times the plain solve's.
        forward_k = (x64 - x_true).abs().amax(-1) / scale
        forward_p = (xp64 - x_true).abs().amax(-1) / scale
        qs = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=dev)
        fk, fp = torch.quantile(forward_k, qs), torch.quantile(forward_p, qs)
        print(f"K8 kkt_lu {label}: perm equal {same_perm}, lu bit-identical to plain {same_lu}, "
              f"|lu_k-lu_p|max/|lu_p|max {rel:.3e} (rtol {RTOL[name]:g}); two launches bit-identical")
        print(f"  solve of b = K x_true, {K.shape[0]} right-hand sides: |x_k-x_p|max {err_x:.3e}, over |x_p|max {rel_x:.3e}; forward error "
              f"|x-x_true|max/|x_true|max by instance, quantiles 0.5, 0.9, 0.99, 1: kernel "
              f"{', '.join(f'{v:.3e}' for v in fk.tolist())}; plain {', '.join(f'{v:.3e}' for v in fp.tolist())}; "
              f"row-wise backward error against the factors: kernel {rowwise_k:.3e}, plain {rowwise_p:.3e} (bound "
              f"8 sqrt(N) eps = {rowwise_bound:.3e}); backward error against K {backward:.3e} (bound "
              f"{BACKWARD_BOUND[name]:g})")
        require(same_perm and same_lu, f"K8's factor disagrees with its plain version at {label}")
        require(backward <= BACKWARD_BOUND[name], f"K8's solve has backward error {backward:.3e} at {label}")
        require(rowwise_k <= rowwise_bound,
                f"K8's solve has row-wise backward error {rowwise_k:.3e} against its factors at {label}")
        require(bool((fk <= RTOL[name] + 3 * fp).all()),
                f"K8's solve is less accurate than its plain version at {label}")
        return err, err_x

    def times(K, blocks, label, reps):
        """Kernel, plain and library times of the factor through the blocks
        entry, which polish and the kkt_lu backend call (the K entry's time
        beside it), and of the solve."""
        B, N, _ = K.shape
        lu, perm = k8.kkt_lu_factor_blocks(*blocks)
        kernels, width, cluster = k8.factor_info
        path = f"clusters of {cluster} CTAs" if cluster else "one block per instance"
        print(f"K8 kkt_lu_factor_blocks {label}: {kernels} kernel launches per factor, panels {width} columns wide, "
              f"{path}")
        b = torch.randn(B, N, dtype=K.dtype, device=dev)
        (fb, ff), (sb, sf) = k8_cost(B, N, K.dtype, n=blocks[0].shape[-1])
        LU, pivots = torch.linalg.lu_factor(K)  # library_ms only: the port calls no library LU
        out = {}
        for what, fn, plain, lib, nbytes, flops in (
            ("factor", lambda: k8.kkt_lu_factor_blocks(*blocks), lambda: k8.kkt_lu_factor_blocks_plain(*blocks),
             lambda: torch.linalg.lu_factor(K), fb, ff),
            ("solve", lambda: k8.kkt_lu_solve(lu, perm, b), lambda: k8.kkt_lu_solve_plain(lu, perm, b),
             lambda: torch.linalg.lu_solve(LU, pivots, b[:, :, None]), sb, sf),
        ):
            ms = cuda_ms(fn, reps)
            plain_ms = cuda_ms(plain, 1, warmup=1)
            library_ms = cuda_ms(lib, reps)
            bound_ms, bound_by = bound(nbytes, flops)
            print(f"K8 kkt_lu_{what} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"torch.linalg.lu_{what} {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), share of bound "
                  f"{bound_ms / ms:.3f}")
            out[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        out["factor"]["kernels_per_factor"] = kernels
        # every product and difference rounded on its own: the operations
        # take twice the time of a bound that assumes fused multiply-adds
        no_fma = 2 * sum(f / PEAK_FLOPS[d] for d, f in ff.items()) * 1e3
        out["factor"]["bound_no_fma_ms"] = no_fma
        print(f"K8 kkt_lu_factor {label}: operations without fused multiply-add {no_fma:.4f} ms, share "
              f"{no_fma / out['factor']['ms']:.3f}")
        k_entry_ms = cuda_ms(lambda: k8.kkt_lu_factor(K), reps)
        out["factor"]["k_entry_ms"] = k_entry_ms
        torch.cuda.synchronize()
        _, _, events = profiled(lambda: k8.kkt_lu_factor_blocks(*blocks))
        print(f"K8 kkt_lu_factor {label}: the K entry {k_entry_ms:.4f} ms (the blocks entry "
              f"{out['factor']['ms']:.4f}); one blocks-entry factor's device time by kernel: "
              f"{top_kernels(events, k=8)}")
        return out

    for dtype in (torch.float64, torch.float32):
        scaled, rs, _, dyn = path_operands(512, 25, 50, dtype, dev)
        blocks = (scaled.P, scaled.A, dyn.sigma, rs.rho_inv_vec)
        compare(blocks_kkt(blocks), f"ADMM form B=512 N=75 {dtype_name(dtype)}", blocks)

    # the batched path at ragged N, a batch of the SM count
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float64, torch.float32):
        launches = {}
        for N in (1, 31, 33, 63, 65, 75, 300):
            n = max(1, N // 3)
            blocks = random_blocks(sms, n, N - n, dtype, dev, seed=N, masked=N % 2 == 1)
            K = blocks_kkt(blocks)
            lp, pp = k8.kkt_lu_factor_plain(K)
            runs = [k8.kkt_lu_factor(K), k8.kkt_lu_factor(K), k8.kkt_lu_factor_blocks(*blocks),
                    k8.kkt_lu_factor_blocks(*blocks)]
            launches[N] = k8.factor_info[0]
            torch.cuda.synchronize()
            require(k8.factor_info[2] == 0, f"K8 at B={sms} N={N} did not take the batched path")
            require(all(torch.equal(lu, lp) and torch.equal(perm, pp) for lu, perm in runs),
                    f"K8's batched factor disagrees with its plain version at B={sms} N={N} {dtype_name(dtype)}")
        print(f"K8 batched path B={sms} {dtype_name(dtype)}, N in {list(launches)}: lu and perm bit-identical to "
              f"plain through both entry points, two launches each bit-identical True; launches per factor "
              f"{launches}")

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    blocks, rows = polish_blocks(on_device(make_qps(B, n, m), torch.float32, dev), torch.float32)
    K = blocks_kkt(blocks)
    label = f"K_delta B={B} N={n + m} float32"
    print(f"K8 {label}: active rows of A by instance, of {m}: mean {float(rows.mean()):.1f}, least {int(rows.min())}, "
          f"most {int(rows.max())}")
    err, err_x = compare(K, label, blocks)
    stats = times(K, blocks, label, reps=5)
    del K, blocks
    torch.cuda.empty_cache()

    # B = 1, where the batch cannot fill the card: the cluster factor and
    # the strip solve, each timed beside the library at CVXQP2_M
    small = {}
    for name in ("CVXQP2_S", "CVXQP2_M"):
        for dtype in (torch.float64, torch.float32):
            blocks, rows = polish_blocks(on_device(maros_dense(name), dtype, dev), dtype)
            K = blocks_kkt(blocks)
            label = f"K_delta {name} B=1 N={K.shape[1]} {dtype_name(dtype)}"
            print(f"K8 {label}: {int(rows[0])} active rows of A")
            compare(K, label, blocks)
            t = times(K, blocks, label, reps=5)
            if name == "CVXQP2_M":
                small[dtype_name(dtype)] = t
                for what in ("factor", "solve"):
                    print(f"K8 kkt_lu_{what} {label}: kernel over library {t[what]['ms'] / t[what]['library_ms']:.3f}")
    b1 = lambda what: {d: {k: v for k, v in small[d][what].items() if k != "plain_ms"} for d in small}
    return ({**stats["factor"], "max_abs_err": err, "cvxqp2_m_b1": b1("factor")},
            {**stats["solve"], "max_abs_err": err_x, "cvxqp2_m_b1": b1("solve")})


def phase_polish_batched(dev):
    """Counts are set to 0 just before the headline's polish-on solve and
    read just after it."""
    import torch

    import osqp_tpu_torch as ot

    def on_against_off(label, args, kw, launches_wanted=True):
        off = ot.solve_batch(*args, **{**kw, "polish": False})
        reset_counts()
        on = ot.solve_batch(*args, **{**kw, "polish": True})
        torch.cuda.synchronize()
        launches = read_counts()
        same = torch.equal(on.status_val, off.status_val) and torch.equal(on.iter, off.iter)
        sp = on.status_polish
        ok = sp == 1
        B = sp.numel()
        solved = float((on.status_val == ot.OSQP_SOLVED).float().mean())
        iters = on.iter.float()
        worse = int(((on.pri_res > off.pri_res) | (on.dua_res > off.dua_res))[ok].sum())
        print(f"polish {label}: statuses and iterations equal to the polish-off solve {same}; solved {solved:.4f}, "
              f"iterations mean {float(iters.mean()):.2f} max {int(iters.max())}; status_polish 1 in {int(ok.sum())} "
              f"of {B} ({float(ok.float().mean()):.4f}), -1 in {int((sp == -1).sum())}, 0 in {int((sp == 0).sum())}; "
              f"polished instances with a residual above its ADMM residual: {worse}; residuals of the polished: "
              f"pri max {float(on.pri_res[ok].max()):.3e}, dua max {float(on.dua_res[ok].max()):.3e} (ADMM: "
              f"{float(off.pri_res[ok].max()):.3e}, {float(off.dua_res[ok].max()):.3e}); launches {launches}")
        require(same, f"polish changed statuses or iterations at {label}")
        require(int(ok.sum()) > 0 and worse == 0, f"a polished instance is worse than its ADMM point at {label}")
        require(bool(torch.isfinite(on.x[ok]).all()) and bool(torch.isfinite(on.y[ok]).all()), "polished x, y not finite")
        require((launches["kkt_lu_factor"], launches["kkt_lu_solve"]) == (4, 16),
                f"K8 launched {launches['kkt_lu_factor']} + {launches['kkt_lu_solve']} times, not 4 + 16, at {label}")
        t_off = statistics.median(cuda_ms(lambda: ot.solve_batch(*args, **{**kw, "polish": False}), 1, warmup=0)
                                  for _ in range(3))
        t_on = statistics.median(cuda_ms(lambda: ot.solve_batch(*args, **{**kw, "polish": True}), 1, warmup=0)
                                 for _ in range(3))
        print(f"polish {label}: solve with polish off {t_off:.3f} ms, on {t_on:.3f} ms (medians of 3): polish "
              f"{t_on - t_off:.3f} ms, {(t_on - t_off) / t_on:.3f} of the polish-on solve")
        return launches

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    args = on_device(make_qps(B, n, m), torch.float32, dev)
    launches = on_against_off(f"headline B={B} n={n} m={m} f32", args, SOLVE_KW)
    del args
    torch.cuda.empty_cache()
    on_against_off(f"B=512 n={n} m={m} f32 with polish_dtype=float64", on_device(make_qps(512, n, m), torch.float32, dev),
                   {**SOLVE_KW, "polish_dtype": "float64"})

    P, q, A, l, u = make_qps(64, 20, 30, seed=3, dtype=np.float64)
    kw = dict(dtype="float64", verbose=False, polish=True)
    rg = ot.solve_batch(P, q, A, l, u, device=dev, **kw)
    rc = ot.solve_batch(P, q, A, l, u, device="cpu", **kw)
    same = (torch.equal(rg.status_val.cpu(), rc.status_val) and torch.equal(rg.iter.cpu(), rc.iter)
            and torch.equal(rg.status_polish.cpu(), rc.status_polish))
    dx, dy = float((rg.x.cpu() - rc.x).abs().max()), float((rg.y.cpu() - rc.y).abs().max())
    print(f"polish GPU vs CPU, f64 B=64 n=20 m=30: statuses, iterations and status_polish equal {same} "
          f"(status_polish 1 in {int((rc.status_polish == 1).sum())} of 64), |dx|max {dx:.3e}, |dy|max {dy:.3e}")
    require(same and dx <= 1e-6 and dy <= 1e-6, "the polished GPU slice disagrees with the CPU slice")
    return launches


def phase_polish_solver(dev):
    import scipy.sparse as sp

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.io.qps import load_qps

    gold = np.load(POLISH_GOLDENS)
    for name in ("CVXQP2_S", "CVXQP2_M"):
        qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
        P_full = qp.P + qp.P.T - sp.diags(qp.P.diagonal())  # qp.P is the upper triangle
        for dtype in ("float64", "float32"):
            g = lambda f: gold[f"{name}/{dtype}/{f}"]
            label = f"{name} n={qp.n} m={qp.m} {dtype} polish on"
            before = read_counts()
            s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype=dtype, polish=True, verbose=False)
            r = s.solve()
            after = read_counts()
            k8_launches = (after["kkt_lu_factor"] - before["kkt_lu_factor"], after["kkt_lu_solve"] - before["kkt_lu_solve"])
            i = r.info
            obj_rel = abs(i.obj_val - float(g("obj_val"))) / abs(float(g("obj_val")))
            xs, ys = max(1.0, np.abs(g("x")).max()), max(1.0, np.abs(g("y")).max())
            dx, dy = np.abs(r.x - g("x")).max() / xs, np.abs(r.y - g("y")).max() / ys
            print(f"Solver {label}: {i.status}, {i.iter} iterations, status_polish {i.status_polish}, obj {i.obj_val!r}, "
                  f"pri_res {i.pri_res:.3e}, dua_res {i.dua_res:.3e}; solve {i.solve_time * 1e3:.3f} ms, polish "
                  f"{i.polish_time * 1e3:.3f} ms; K8 launches {k8_launches}")
            print(f"  against the JAX package (CPU, goldens): iterations {i.iter} / {int(g('iter'))}, status_polish "
                  f"{i.status_polish} / {int(g('status_polish'))}, pri_res {i.pri_res:.3e} / {float(g('pri_res')):.3e}, "
                  f"dua_res {i.dua_res:.3e} / {float(g('dua_res')):.3e}, obj relative {obj_rel:.3e}, |dx|max/|x|max "
                  f"{dx:.3e}, |dy|max/|y|max {dy:.3e}")
            require(i.status_val == int(g("status_val")) == ot.OSQP_SOLVED, f"{label}: status {i.status}")
            require(np.isfinite(r.x).all() and np.isfinite(r.y).all(), f"{label}: x, y not finite")
            require(k8_launches == (4, 16), f"{label}: K8 launched {k8_launches}, not (4, 16)")
            if dtype == "float64":
                require(i.iter == int(g("iter")), f"{label}: iterations {i.iter}")
            else:
                require(abs(i.iter - int(g("iter"))) <= 25, f"{label}: iterations {i.iter}")
            # the residuals of the returned point, from the problem's own
            # matrices in numpy float64
            Ax = qp.A @ r.x
            pri_np = float(np.abs(Ax - np.clip(Ax, qp.l, qp.u)).max())
            dua_np = float(np.abs(P_full @ r.x + qp.q + qp.A.T @ r.y).max())
            ref_obj, ref_x = float(gold[f"{name}/reference/obj_val"]), gold[f"{name}/reference/x"]
            ref_obj_rel = abs(i.obj_val - ref_obj) / abs(ref_obj)
            ref_dx = np.abs(r.x - ref_x).max() / max(1.0, np.abs(ref_x).max())
            print(f"  residuals in numpy float64: pri {pri_np:.3e}, dua {dua_np:.3e}; against the JAX package's "
                  f"float64 solve at eps 1e-10: obj relative {ref_obj_rel:.3e}, |dx|max/|x|max {ref_dx:.3e}")
            f64 = dtype == "float64"
            if name == "CVXQP2_S":
                # both packages factor K_delta by LU at delta 1e-6 here
                require(i.status_polish == int(g("status_polish")) == 1, f"{label}: status_polish {i.status_polish}")
                # float32: the two packages' polished points agree to what
                # float32 keeps of y on this problem (|y| ~ 1e3, K_delta's
                # condition number ~1e7): 1e-2 of its largest entry
                tol_x, tol_y = (1e-6, 1e-6) if f64 else (1e-3, 1e-2)
                require(obj_rel <= tol_x and dx <= tol_x and dy <= tol_y,
                        f"{label} disagrees with the JAX package's run")
            else:
                # The JAX package's polish is rejected here (status_polish
                # -1, through its Schur route at delta 1e-4, and through its
                # LU branch too from its own ADMM point: ROADMAP queue 3),
                # so the golden's x and y are the ADMM point, accurate to
                # eps = 1e-3, and its y has the dual residual printed above.
                # LU at delta 1e-6 from this run's ADMM point may be
                # accepted.  Either way x and the objective lie within the
                # ADMM accuracy of the golden.
                require(obj_rel <= 1e-5 and dx <= 1e-3, f"{label} is far from the JAX package's run")
            if i.status_polish == 1:
                # An accepted polish is held to the optimum itself: the
                # residuals recomputed here confirm the reported ones, and
                # x and the objective agree with the solve at eps 1e-10 (y
                # is not compared: the duals of these problems are not unique).
                if name == "CVXQP2_M":  # the golden's residuals are the ADMM point's
                    require(i.pri_res <= float(g("pri_res")) and i.dua_res <= float(g("dua_res")),
                            f"{label}: polished residuals above the ADMM residuals")
                scale = max(1.0, float(np.abs(r.y).max()))
                tol_res, tol_ref = (1e-9, 1e-7) if f64 else (1e-3, 1e-5)
                require(pri_np <= tol_res and dua_np <= tol_res * scale,
                        f"{label}: the polished point's residuals are {pri_np:.3e}, {dua_np:.3e}")
                require(ref_obj_rel <= tol_ref and ref_dx <= tol_ref, f"{label} is not at the optimum")


def phase_kkt_lu_backend(dev):
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.io.qps import load_qps

    n, m = HEADLINE["n"], HEADLINE["m"]
    args = on_device(make_qps(1024, n, m), torch.float32, dev)
    ref = ot.solve_batch(*args, **SOLVE_KW)
    reset_counts()
    t0 = time.perf_counter()
    res = ot.solve_batch(*args, **{**SOLVE_KW, "linsys_solver": "kkt_lu"})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    same = torch.equal(res.status_val, ref.status_val) and torch.equal(res.iter, ref.iter)
    differ = int((res.iter != ref.iter).sum())
    dx = float((res.x - ref.x).abs().max())
    print(f"kkt_lu backend B=1024 n={n} m={m} f32: statuses and iterations equal to the dense_inv run {same} "
          f"({differ} iteration counts differ), |dx|max {dx:.3e}; solved "
          f"{float((res.status_val == ot.OSQP_SOLVED).float().mean()):.4f}, iterations max {int(res.iter.max())}; "
          f"{wall:.3f} ms; launches {launches}")
    require(torch.equal(res.status_val, ref.status_val), "the kkt_lu backend's statuses differ from dense_inv's")
    # float32: the generic body carries the TwoSum low bits that the fused
    # K1 body drops, so an instance at the edge of a check may move by one
    # check interval
    require(differ <= 0.01 * 1024 and int((res.iter.int() - ref.iter.int()).abs().max()) <= 25,
            f"the kkt_lu backend's iteration counts differ from dense_inv's in {differ} of 1024 instances")
    require(launches["kkt_lu_factor"] >= 1 and launches["kkt_lu_solve"] == int(res.iter.max()),
            "the kkt_lu backend did not run one K8 solve per iteration")
    require(launches["admm_iter"] == launches["chol_inverse"] == 0, "the kkt_lu backend ran K1 or K2")

    qp = load_qps(os.path.join(MAROS, "CVXQP2_S.qps"))
    for dtype in ("float64", "float32"):
        rd = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype=dtype, verbose=False).solve()
        before = read_counts()
        rk = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype=dtype, linsys_solver="kkt_lu",
                       verbose=False).solve()
        after = read_counts()
        k8_launches = (after["kkt_lu_factor"] - before["kkt_lu_factor"], after["kkt_lu_solve"] - before["kkt_lu_solve"])
        print(f"kkt_lu backend Solver CVXQP2_S {dtype}: {rk.info.status}, {rk.info.iter} iterations (dense_inv "
              f"{rd.info.iter}), {rk.info.rho_updates} rho updates, |dx|max {np.abs(rk.x - rd.x).max():.3e}, solve "
              f"{rk.info.solve_time * 1e3:.3f} ms (dense_inv {rd.info.solve_time * 1e3:.3f} ms); K8 launches {k8_launches}")
        require(rk.info.status_val == rd.info.status_val == ot.OSQP_SOLVED, "kkt_lu backend Solver: status")
        require(rk.info.iter == rd.info.iter if dtype == "float64" else abs(rk.info.iter - rd.info.iter) <= 25,
                f"kkt_lu backend Solver {dtype}: {rk.info.iter} iterations against {rd.info.iter}")
        require(k8_launches == (1 + rk.info.rho_updates, rk.info.iter), f"kkt_lu backend Solver: K8 launches {k8_launches}")
    return launches


# The sparse path's cases, as tools/make_torch_goldens.py writes them:
# case -> (problem, dtype, instances).
SPARSE_CASES = {
    "CVXQP2_L/float64": ("CVXQP2_L", "float64", 1),
    "LISWET1/float64": ("LISWET1", "float64", 1),
    "LISWET1/float32": ("LISWET1", "float32", 1),
    "LISWET1_B8/float64": ("LISWET1", "float64", 8),
}
# The kernels of K5 and K6 (csrc/ell_ops.cu, csrc/cg.cu), by name in the profiler.
K5_KERNELS = tuple(f"namespace)::{k}<" for k in ("group_kernel", "cg_start_kernel", "scale_kernel"))
# K5's launch counts in read_counts: all, and by kernel.
K5_COUNTS = ("ell_ops", "ell_group", "ell_cg_start", "ell_scale")
K6_KERNELS = ("dot_kernel", "update_kernel", "direction_kernel", "cluster_loop_kernel")


def scenario(name, B=1):
    """A Maros-Meszaros problem as scipy P, A and (B, ·) q, l, u: B
    instances sharing P and A, with q scaled by 1 + 0.1 i."""
    from osqp_tpu_torch.io.qps import load_qps

    qp = load_qps(os.path.join(MAROS, f"{name}.qps"))
    q = np.stack([qp.q * (1.0 + 0.1 * i) for i in range(B)])
    return qp.P, q, qp.A, np.tile(qp.l, (B, 1)), np.tile(qp.u, (B, 1))


def sparse_prepared(name, dtype, dev, B=1, **settings):
    """The sparse path's set-up of a problem on the card: config,
    settings, scaled ELL data, scaling, rho state, cg factor, iterates."""
    import torch

    from osqp_tpu_torch import batch, large

    P, q, A, l, u = scenario(name, B)
    s, dt, cfg, dyn, P_ell, A_ell, q, l, u = large.prepare_sparse(
        P, q, A, l, u, {"dtype": dtype, "verbose": False, **settings}, dev)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    rho0 = torch.full((B,), s.rho, dtype=dt, device=dev)
    return (cfg, dyn) + batch._prepare(cfg, s.scaling, P_ell, t(q), A_ell, t(l), t(u), rho0, dyn, None, None)


def ell_bytes(val, idx, B):
    """Bytes of one ELL copy read once: B instances' values (padding
    included) and the shared pattern."""
    return val.element_size() * B * idx.numel() + 4 * idx.numel()


def ell_nnz(val, B):
    """Stored nonzeros of B instances (instance 0's count: the batch shares
    its pattern)."""
    return B * int((val[0] != 0).sum())


def k5_cost(E, mode, B):
    """(bytes, operations) of one K5 reduction over the operand E (A's rows
    for matvec, the transpose's for the others): the ELL values and
    pattern and the gathered vector(s) read once, the output written once;
    per stored nonzero a multiply-add (two multiplies and an add with a
    weight)."""
    val, idx, G = (E.val, E.idx, E.shape[1]) if mode == "matvec" else (E.t_val, E.t_idx, E.shape[0])
    elt = val.element_size()
    R = idx.shape[0]
    vectors = 2 if mode == "tmatvec_weighted" else 1
    nbytes = ell_bytes(val, idx, B) + elt * B * (vectors * G + R)
    return nbytes, {dtype_name(val.dtype): (3 if vectors == 2 else 2) * ell_nnz(val, B)}


def k5_pair_cost(P, A, B):
    """(bytes, operations) of P x and A x in one launch: both operands read
    once, x read once, both outputs written once."""
    m, n = A.shape
    elt = A.val.element_size()
    nbytes = ell_bytes(P.val, P.idx, B) + ell_bytes(A.val, A.idx, B) + elt * B * (2 * n + m)
    return nbytes, {dtype_name(A.dtype): 2 * (ell_nnz(P.val, B) + ell_nnz(A.val, B))}


def k5_start_cost(P, A, B, with_rhs=True):
    """(bytes, operations) of ell_cg_start (P x0 and A x0, then the start
    kernel) as one function: P, A and A's transpose read once; x0, rhs_x,
    dinv (B, n) and rhs_z, rho (B, m; w is rho) read once; b, r, z written
    once (r, z without rhs_z); per stored nonzero a multiply-add in P x0 and
    A x0 and three operations in each weighted transpose; six operations a
    column besides."""
    m, n = A.shape
    elt = A.val.element_size()
    nbytes = (ell_bytes(P.val, P.idx, B) + ell_bytes(A.val, A.idx, B) + ell_bytes(A.t_val, A.t_idx, B)
              + elt * B * (3 * n + (2 * m if with_rhs else m) + (3 if with_rhs else 2) * n))
    flops = (2 * (ell_nnz(P.val, B) + ell_nnz(A.val, B)) + (2 if with_rhs else 1) * 3 * ell_nnz(A.t_val, B)
             + 6 * B * n)
    return nbytes, {dtype_name(A.dtype): flops}


def k5_scale_cost(A, B, with_c):
    """(bytes, operations) of ell_scale: both copies of the values and
    their patterns read once, the row and column scales and c read once,
    both copies written once; two or three multiplies a slot."""
    m, n = A.shape
    elt = A.val.element_size()
    slots = A.idx.numel() + A.t_idx.numel()
    nbytes = 2 * elt * B * slots + 4 * slots + elt * B * (m + n + 1)
    return nbytes, {dtype_name(A.dtype): (3 if with_c else 2) * B * slots}


def library_operand(parts, B, G):
    """ELL copies ``parts`` ((values (B, R, k), pattern (R, k)), ...; all
    gathering one vector of G entries) stacked by rows, the B instances as
    the blocks of a block-diagonal CSR matrix, for one torch.sparse.mm
    (library_ms only: the port never calls it)."""
    import torch

    Rs = sum(idx.shape[0] for _, idx in parts)
    rs, cs, vs, off = [], [], [], 0
    for val, idx in parts:
        R, k = idx.shape
        dev = val.device
        keep = (val != 0).flatten()
        b = torch.arange(B, device=dev).repeat_interleave(R * k)
        rs.append(((torch.arange(R, device=dev).repeat_interleave(k) + off).repeat(B) + b * Rs)[keep])
        cs.append((idx.flatten().long().repeat(B) + b * G)[keep])
        vs.append(val.flatten()[keep])
        off += R
    r, c, v = (torch.cat(t) for t in (rs, cs, vs))
    return torch.sparse_coo_tensor(torch.stack([r, c]), v, (B * Rs, B * G)).coalesce().to_sparse_csr()


def library_product(S, x):
    """S x for library_operand's S: (B, G) -> (B, rows), or (B, G, c) ->
    (B, rows, c): one torch.sparse.mm."""
    import torch

    B = x.shape[0]
    return torch.sparse.mm(S, x.reshape((B * x.shape[1], -1))).reshape((B, -1) + tuple(x.shape[2:]))


def host_us(fn, calls=1000):
    """Microseconds of host time per call of ``fn``: ``calls`` calls back to
    back, synchronized once at the end (the device's work per call is a
    few microseconds, below the host's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_k5(dev):
    """K5 (ell_ops) against its plain versions, bit for bit, on CVXQP2_L's
    scaled operands (B=1, float64 and float32) and on a scenario batch of
    CVXQP2_M (B=64, float64): every single product (one-job launches of the
    grouped kernel) and the scaling, the grouped launches the path makes
    (P x with A x, a check's six products, a Ruiz sweep's three norms, the
    cg init's two) and eight jobs of every mode in one launch, and the
    fused CG start with and without its right-hand side; two launches
    bit-identical.  At CVXQP2_L float64 and CVXQP2_M B=64: A x, P x with A
    x and the fused start timed beside their plain versions, the library
    and the bound, with host microseconds per call; the scaling at
    CVXQP2_L.  Returns the stats of the grouped kernel, the start and the
    scaling."""
    import torch

    from osqp_tpu_torch.ops import ell as k5

    stats, err = {}, [0.0]
    for name, dtype, B in (("CVXQP2_L", "float64", 1), ("CVXQP2_L", "float32", 1), ("CVXQP2_M", "float64", 64)):
        _, _, scaled, scl, rs, fac, _ = sparse_prepared(name, dtype, dev, B)
        A, P = scaled.A, scaled.P
        m, n = A.shape
        g = torch.Generator(device=dev).manual_seed(11)
        r = lambda *sh: torch.randn(*sh, generator=g, dtype=A.dtype, device=dev)
        x, y, x2, y2, x0, rhs_x, rhs_z = r(B, n), r(B, m), r(B, n), r(B, m), r(B, n), r(B, n), r(B, m)
        rho, dinv, sigma = rs.rho_vec, fac["dinv"], fac["sigma"]
        label = (f"{name} B={B} n={n} m={m} {dtype} (k = {A.idx.shape[1]}, kt = {A.t_idx.shape[1]}, "
                 f"P k = {P.idx.shape[1]})")
        singles = {
            "matvec": (k5.ell_matvec, A, x), "tmatvec": (k5.ell_tmatvec, A, y),
            "tmatvec_weighted": (k5.ell_tmatvec, A, y, rho), "sq_colsums": (k5.ell_sq_colsums, A, rho),
            "row_norms": (k5.ell_row_norms, A, scl.D), "col_norms": (k5.ell_col_norms, A, scl.E),
            "P_col_norms": (k5.ell_col_norms, P, scl.D), "diagonal": (k5.ell_diagonal, P),
        }
        plain = lambda f, *args: getattr(k5, f"{f.__name__}_plain")(*args)

        def same(got, again, want, what):
            """Both launches the plain bits; the largest difference kept."""
            diff = rel_err(got, want)[0]
            err[0] = max(err[0], diff)
            require(torch.equal(got, again), f"K5 {what}: two launches differ at {label}")
            require(torch.equal(got, want), f"K5 {what} differs from its plain version by {diff:.3e} at {label}")

        for mode, (f, *args) in singles.items():
            got, again, want = f(*args), f(*args), plain(f, *args)
            torch.cuda.synchronize()
            same(got, again, want, mode)
        for c in (scl.c, None):
            got, again, want = (f(A, scl.E, scl.D, c) for f in (k5.ell_scale, k5.ell_scale, k5.ell_scale_plain))
            torch.cuda.synchronize()
            for fld in ("val", "t_val"):
                same(getattr(got, fld), getattr(again, fld), getattr(want, fld), f"scale {fld}")
        groups = {
            "P x with A x": [(k5.ell_matvec, P, x), (k5.ell_matvec, A, x)],
            "a check's six": [(k5.ell_matvec, A, x), (k5.ell_matvec, P, x), (k5.ell_tmatvec, A, y),
                              (k5.ell_tmatvec, A, y2), (k5.ell_matvec, P, x2), (k5.ell_matvec, A, x2)],
            "a Ruiz sweep's three": [(k5.ell_col_norms, P, scl.D), (k5.ell_col_norms, A, scl.E),
                                     (k5.ell_row_norms, A, scl.D)],
            "the cg init's two": [(k5.ell_diagonal, P), (k5.ell_sq_colsums, A, rho)],
            "eight of every mode": list(singles.values()),
        }
        for gname, calls in groups.items():
            before = k5.launches_group
            outs, again = k5.ell_products(*calls), k5.ell_products(*calls)
            torch.cuda.synchronize()
            require(k5.launches_group - before == 2, f"K5 {gname}: {k5.launches_group - before} launches for two calls")
            for (f, *args), o, o2 in zip(calls, outs, again):
                same(o, o2, plain(f, *args), f"{gname}: {f.__name__}")
        for with_rhs in (True, False):
            args = (P, A, rho, x0, dinv, sigma, rhs_x) + ((rhs_z, rho) if with_rhs else ())
            before = (k5.launches_group, k5.launches_start)
            got, again, want = k5.ell_cg_start(*args), k5.ell_cg_start(*args), k5.ell_cg_start_plain(*args)
            torch.cuda.synchronize()
            require((k5.launches_group - before[0], k5.launches_start - before[1]) == (2, 2),
                    "K5 ell_cg_start: not one grouped and one start launch a call")
            for fld, o, o2, w in zip("brz", got, again, want):
                same(o, o2, w, f"cg start {fld}")
        p = k5.plan((n, m), B, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"K5 ell_ops {label}: bit for bit with plain: every single product and the scaling, the grouped "
              f"launches ({', '.join(groups)}) and the fused start with and without its right-hand side; two "
              f"launches bit-identical; P x with A x planned as {p.ctas} CTAs of {p.rows} rows x {p.ipar} "
              f"instances, runs of {p.run}")
        if dtype == "float32":
            continue

        key = "B1" if B == 1 else f"B{B}"
        # A x alone, a one-job launch
        t = report_times(f"K5 matvec {label}", lambda: k5.ell_matvec(A, x), lambda: k5.ell_matvec_plain(A, x), 50,
                         *k5_cost(A, "matvec", B))
        S = library_operand([(A.val, A.idx)], B, n)
        lib_ms = cuda_ms(lambda: library_product(S, x), 50)
        us = host_us(lambda: k5.ell_matvec(A, x))
        print(f"  library torch.sparse.mm (CSR{', the batch block-diagonal' if B > 1 else ''}) {lib_ms:.4f} ms, "
              f"relative difference to the kernel {rel_err(library_product(S, x), k5.ell_matvec(A, x))[1]:.3e}; host "
              f"{us:.2f} us per call")
        stats[f"matvec_{key}"] = dict(t, library_ms=lib_ms, host_us=us)
        # P x with A x, one launch (the CG's start on the path)
        pair = [(k5.ell_matvec, P, x), (k5.ell_matvec, A, x)]
        t = report_times(f"K5 group P x with A x {label}", lambda: k5.ell_products(*pair),
                         lambda: (k5.ell_matvec_plain(P, x), k5.ell_matvec_plain(A, x)), 50, *k5_pair_cost(P, A, B))
        S = library_operand([(P.val, P.idx), (A.val, A.idx)], B, n)
        lib_ms = cuda_ms(lambda: library_product(S, x), 50)
        us = host_us(lambda: k5.ell_products(*pair))
        print(f"  library: one product with [P; A] {lib_ms:.4f} ms; host {us:.2f} us per call")
        stats[f"group_{key}"] = dict(t, library_ms=lib_ms, host_us=us)
        # the fused start: P x0 with A x0, then the start kernel
        args = (P, A, rho, x0, dinv, sigma, rhs_x, rhs_z, rho)
        t = report_times(f"K5 cg start {label}", lambda: k5.ell_cg_start(*args), lambda: k5.ell_cg_start_plain(*args),
                         50, *k5_start_cost(P, A, B))
        St = library_operand([(A.t_val, A.t_idx)], B, m)
        Y = torch.stack([rho * rhs_z, rho * k5.ell_matvec(A, x0)], -1)
        lib_ms = cuda_ms(lambda: (library_product(S, x0), library_product(St, Y)), 50)
        us = host_us(lambda: k5.ell_cg_start(*args))
        print(f"  library, the product part alone ([P; A] x0, then A' on two columns): {lib_ms:.4f} ms in two calls; "
              f"host {us:.2f} us per call")
        stats[f"start_{key}"] = dict(t, library_ms=None, library_products_ms=lib_ms, host_us=us)
        if B == 1:
            t = report_times(f"K5 scale {label}", lambda: k5.ell_scale(A, scl.E, scl.D, scl.c),
                             lambda: k5.ell_scale_plain(A, scl.E, scl.D, scl.c), 50, *k5_scale_cost(A, B, True))
            stats["scale"] = dict(t, library_ms=None, host_us=host_us(lambda: k5.ell_scale(A, scl.E, scl.D, scl.c)))

    # K5's launches in a sparse solve of the B=64 scenario batch of CVXQP2_M
    import osqp_tpu_torch as ot

    before = read_counts()
    res = ot.solve_sparse(*scenario("CVXQP2_M", 64), dtype="float64", verbose=False)
    solved = int((res.status_val == ot.OSQP_SOLVED).sum())
    after = read_counts()
    print(f"K5 in solve_sparse, CVXQP2_M scenario batch B=64 float64: "
          f"{dict((k, after[k] - before[k]) for k in K5_COUNTS)} K5 launches, {after['cg_loop'] - before['cg_loop']} "
          f"K6 loops; solved {solved} of 64, iterations max {int(res.iter.max())}")
    # the rows: CVXQP2_L float64's times, the others' beside them by name
    group = dict(stats["group_B1"], max_abs_err=err[0], group_B64=stats["group_B64"],
                 matvec_B1=stats["matvec_B1"], matvec_B64=stats["matvec_B64"])
    start = dict(stats["start_B1"], max_abs_err=err[0], start_B64=stats["start_B64"])
    return group, start, dict(stats["scale"], max_abs_err=err[0])


def loop_cost(op, B, n, steps):
    """(bytes, operations) of ``steps`` CG steps of the device loop on the
    ELL operator ``op``: per step the operands (the values and patterns of
    P, A and A's transpose) read once, and some twelve (B, n) and two
    (B, m) vectors read or written once; per stored nonzero of the
    products a multiply-add, and 16 operations per entry of the step's
    vector work."""
    elt = op.P.val.element_size()
    m = op.A.shape[0]
    nnz = lambda v: int((v != 0).sum())
    operands = sum(elt * t.numel() + 4 * i.numel() for t, i in ((op.P.val, op.P.idx), (op.A.val, op.A.idx),
                                                                  (op.A.t_val, op.A.t_idx)))
    nbytes = operands + elt * B * (12 * n + 2 * m)
    flops = 2 * (nnz(op.P.val) + nnz(op.A.val) + nnz(op.A.t_val)) + 16 * B * n
    return steps * nbytes, {dtype_name(op.P.dtype): steps * flops}


K6_LOOP = ("cluster_loop_kernel",)


def plan_text(plan) -> str:
    """K6's device loop plan (ops.cg.LoopPlan) in words."""
    return (f"clusters of {plan.cluster} CTAs x {plan.threads} threads, {plan.smem} B of shared memory a CTA, "
            f"operands {'resident' if plan.resident else 'read from device memory'}, vectors "
            f"{'resident' if plan.vectors else 'in device memory'}, {plan.clusters} clusters in flight")


def loop_step_line(label, plan, device_ms, steps, bound_ms) -> str:
    """The loop's plan and its device ms per CG step beside the bound."""
    per = device_ms / max(steps, 1)
    return (f"  {label}: plan {plan_text(plan)}; {per:.6f} ms per CG step on the device ({steps} steps, "
            f"{device_ms:.3f} ms) against a bound of {bound_ms:.6f} ms, share {bound_ms / per if per else 0:.3f}")


def stepwise_everywhere():
    """A measurement hook: while it is in force pcg_solve takes the stepwise
    path on ELL and dense operators too, so that one call times both
    paths (and the row-sharded entries' unsharded reference takes their
    path)."""
    import contextlib

    from osqp_tpu_torch.ops import cg as k6

    @contextlib.contextmanager
    def hook():
        loop, dense = k6.pcg_solve_loop, k6.pcg_solve_dense_loop
        k6.pcg_solve_loop = k6.pcg_solve_dense_loop = k6.pcg_solve_stepwise
        try:
            yield
        finally:
            k6.pcg_solve_loop, k6.pcg_solve_dense_loop = loop, dense

    return hook()


def unfused_start():
    """A measurement hook: while it is in force the CG's start runs as the
    composition of single K5 launches that the fused start replaced (the
    right-hand side's weighted transpose, P x0, A x0 and A'(w A x0), each a
    one-job launch, and the vector work in PyTorch), so that one call holds
    the fused start to it bit for bit."""
    import contextlib

    from osqp_tpu_torch.ops import ell as k5

    def composed(P, A, w, x0, dinv, sigma, rhs_x, rhs_z=None, rho=None):
        b = rhs_x if rhs_z is None else rhs_x + k5.ell_tmatvec(A, rhs_z, rho)
        Mx = k5.ell_matvec(P, x0) + sigma * x0
        Mx = Mx + k5.ell_tmatvec(A, k5.ell_matvec(A, x0), w)
        r = b - Mx
        return b, r, dinv * r

    @contextlib.contextmanager
    def hook():
        fused = k5.ell_cg_start
        k5.ell_cg_start = composed
        try:
            yield
        finally:
            k5.ell_cg_start = fused

    return hook()


def dense_loop_cost(B, n, m, itemsize, steps, starts):
    """(bytes, operations) of the dense loop's solves of B instances: the
    operands (P, A) read once and b, dinv, x0 and w read and x written
    once; per CG step and per start from x0 (``steps`` and ``starts`` over
    the batch) the products' n^2 + 2 m n multiply-adds, two operations
    each, and some 18 n + m operations of the vector work.  The loop
    rounds every multiply and every add on its own, so each takes the slot
    of an FMA: its operations floor is twice this operations figure
    (k7_no_fma_ms)."""
    nbytes = itemsize * B * (n * n + m * n + 4 * n + m)
    ops = (steps + starts) * (2 * (n * n + 2 * m * n) + 18 * n + m)
    return nbytes, {"float32" if itemsize == 4 else "float64": ops}


K6_DENSE_LOOP = ("dense_loop_kernel",)


def phase_k6(dev):
    """K6 against its plain loop: one cg solve from a mid-solve ADMM state
    of CVXQP2_L (float64, ELL operands: the device loop; iteration 100)
    and of dense data (the dense loop): the headline (B=8192, float32 and
    float64; iteration 25, every fourth instance frozen by a huge
    tolerance), its first 1024 instances, and one streamed B=1 QP (n=1000,
    m=1250, float64: its operands beyond any cluster).  Steps equal, x bit
    for bit, frozen instances bit-unchanged, two runs bit-identical, one
    loop launch and no step launch; the dense loop against its plain twin
    (pcg_solve_plain over DenseOperator.ordered, both sums in the kernel's
    order).  At CVXQP2_L and at every dense case the stepwise path on the
    same operator in the same call (stepwise_everywhere: ELL bit for bit,
    dense its own products' order) and the ms per CG step of both, the
    loop's device ms per step beside its bound (FMA-rated, and without
    FMA); one step's vector work held bit for bit to cg_step_plain and
    timed against it and the bound at B=1, n=1000, float64 (the row-sharded
    dense solve's step shape), at the headline and at B=1024.  Returns the step's stats, the ELL loop's and the dense loop's
    (the headline float32's, the others under their labels)."""
    import torch

    from osqp_tpu_torch import admm, _build, batch, solver
    from osqp_tpu_torch.linalg import mat_tvec
    from osqp_tpu_torch.ops import cg as k6, ell as k5
    from osqp_tpu_torch.types import DynSettings

    def mid_solve(cfg, dyn, scaled, scl, rs, fac, it, iters):
        c = admm.run_segment(cfg, scaled, scl, dyn, admm.init_carry(cfg, scaled, rs, fac, it), iters)
        rs, fac = c.rho_state, c.factor
        rhs_z = c.it.z - rs.rho_inv_vec * c.it.y
        at = k5.ell_tmatvec(scaled.A, rhs_z, rs.rho_vec) if hasattr(scaled.A, "t_idx") else mat_tvec(
            scaled.A, rs.rho_vec * rhs_z)
        b = (dyn.sigma * c.it.x - scaled.q) + at
        return [fac["P"], scaled.A, fac["sigma"], rs.rho_vec, fac["dinv"], b, c.it.x, fac["tol_rel"],
                int(fac["max_iter"])]

    def dense_state(B, n, m, dtype, frozen=True, seed=0):
        s = solver.Settings(**{**SOLVE_KW, "dtype": dtype_name(dtype), "linsys_solver": "cg"})
        cfg = solver.make_config(n, m, s, dtype)
        dyn = DynSettings.make(dtype, eps_abs=s.eps_abs, eps_rel=s.eps_rel)
        P, q, A, l, u = on_device(make_qps(B, n, m, seed=seed), dtype, dev)
        rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
        args = mid_solve(cfg, dyn, *batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None), 25)
        args[7] = args[7].clone()
        if frozen:
            args[7][::4] = 1e9
        return args

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def first(args, B):
        return [a[:B].contiguous() if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] > B else a
                for a in args]

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    head32 = dense_state(B, n, m, torch.float32)
    head64 = dense_state(B, n, m, torch.float64)
    cases = (("CVXQP2_L B=1 n=10000 m=12500 float64, ELL", mid_solve(*sparse_prepared("CVXQP2_L", "float64", dev), 100)),
             (f"headline B={B} n={n} m={m} float32, dense", head32),
             (f"headline B={B} n={n} m={m} float64, dense", head64),
             (f"headline's first B=1024 float32, dense", first(head32, 1024)),
             (f"headline's first B=1024 float64, dense", first(head64, 1024)),
             ("B=1 n=1000 m=1250 float64, dense, streamed", dense_state(1, 1000, 1250, torch.float64, frozen=False,
                                                                          seed=3)))
    loop_stats = None
    step_stats, dense_stats = {}, {}
    for label, args in cases:
        Pm, Am, sigma, rho, dinv, b, x0, tol_rel, max_iter = args
        ell = label.endswith("ELL")
        op = k6._operator(Pm, Am, rho, plain=False)
        xk2, sk2 = k6.cg_solve(*args)
        before = read_counts()
        (xk, sk), solve_ms = timed(lambda: k6.cg_solve(*args))
        counted = {k: v - before[k] for k, v in read_counts().items()}
        if ell:
            plain = lambda: k6.cg_solve_plain(*args, dot=k6.kernel_dot)  # noqa: E731
        else:
            plain = lambda: k6.pcg_solve_plain(op.ordered, sigma, dinv, b, tol_rel, max_iter, x0,  # noqa: E731
                                               dot=k6.kernel_dot, start_dot=k6.kernel_dot)
        (xp, sp), plain_ms = timed(plain)
        diff, rel = rel_err(xk, xp)
        tol = RTOL[dtype_name(xk.dtype)]
        frozen = sk == 0
        steps = int(sk.max())
        total_steps = int(sk.sum())
        path = "cg_loop" if ell else "cg_dense_loop"
        print(f"K6 cg {label}: {'device loop' if ell else 'dense loop'}, steps max {steps} (plain {int(sp.max())}), "
              f"steps equal {torch.equal(sk, sp)}, launched {counted[path]} loop, {counted['cg_step']} steps; x "
              f"relative difference {rel:.3e} (tol {tol:g}), |k-p|max {diff:.3e}; {int(frozen.sum())} frozen "
              f"instances bit-unchanged {torch.equal(xk[frozen], x0[frozen])}; two runs bit-identical "
              f"{torch.equal(xk, xk2) and torch.equal(sk, sk2)}; one solve {solve_ms:.3f} ms, "
              f"{solve_ms / max(steps, 1):.4f} ms per CG step (with the operator's products)")
        require(counted[path] == 1 and counted["cg_step"] == 0 and counted["cg_loop" if not ell else "cg_dense_loop"] == 0,
                f"K6 took the wrong path at {label}: {nonzero(counted)}")
        require(torch.equal(sk, sp), f"K6 took other steps than its plain loop at {label}")
        require(rel <= tol and same_bits(xk, xp), f"K6's x off by {rel:.3e} relative at {label}")
        require(torch.equal(xk[frozen], x0[frozen]), f"K6 moved a frozen instance at {label}")
        require(torch.equal(xk, xk2) and torch.equal(sk, sk2), f"K6: two runs differ at {label}")

        # the stepwise path on the same operator, in the same call
        before = k6.launches
        with stepwise_everywhere():
            (xs, ss), step_ms = timed(lambda: k6.cg_solve(*args))
        stepped = k6.launches - before
        same = torch.equal(xs, xk) and torch.equal(ss, sk)
        print(f"  stepwise path on the same operator: x bit-identical {same}, steps equal {torch.equal(ss, sk)} "
              f"(max {int(ss.max())}), x max |diff| {float((xs - xk).abs().max()):.3e}; {step_ms:.3f} ms, "
              f"{step_ms / max(int(ss.max()), 1):.4f} ms per CG step, {stepped} step launches; the loop "
              f"{solve_ms / step_ms:.4f} of its time; the plain loop {plain_ms / max(steps, 1):.4f} ms per step")
        require(stepped > 0, f"K6's stepwise path launched no step at {label}")
        if ell:
            require(same, f"K6's loop and stepwise path differ at {label}")
            nbytes, flops = loop_cost(op, b.shape[0], b.shape[1], steps)
            names = K6_LOOP
        else:
            nbytes, flops = dense_loop_cost(b.shape[0], b.shape[1], Am.shape[1], b.element_size(), total_steps,
                                            int((sk >= 0).sum()))
            names = K6_DENSE_LOOP
        bound_ms, bound_by = bound(nbytes, flops)
        plan = k6.last_plan if ell else k6.last_dense_plan
        _, _, events = profiled(lambda: k6.cg_solve(*args))
        device_ms = event_ms(events, names)
        stats = dict(ms=device_ms / steps, plain_ms=plain_ms / steps, bound_ms=bound_ms / steps, bound_by=bound_by,
                     library_ms=None, max_abs_err=diff, stepwise_ms=step_ms / max(int(ss.max()), 1),
                     wall_ms=solve_ms / steps, steps=steps, solve_device_ms=device_ms, solve_bound_ms=bound_ms,
                     plan=dataclasses.asdict(plan))
        print(loop_step_line("loop" if ell else "dense loop", plan, device_ms, steps, bound_ms / steps)
              + f" ({bound_by}); the solve {device_ms:.4f} device ms against its bound {bound_ms:.4f}; one solve's "
              f"wall {solve_ms / steps:.4f} ms per step with the start")
        if not ell:
            # the bound with every rounded operation in an FMA's slot, beside
            # the FMA-rated one, as the K7 and K8 rows have it
            no_fma = max(nbytes / HBM_BYTES_PER_S * 1e3, k7_no_fma_ms(flops))
            stats["bound_no_fma_ms"] = no_fma / steps
            print(f"  without fused multiply-add: bound {no_fma / steps:.6f} ms per CG step, share "
                  f"{no_fma / device_ms if device_ms else 0:.3f}")
        if ell:
            loop_stats = stats
            require(plan.cluster > 1 and plan.vectors, f"K6's loop did not spread {label} over a cluster")
            continue
        dense_stats[label] = stats
        require(plan.resident != label.endswith("streamed"), f"K6's dense loop took the wrong mode at {label}")

        # One step's vector work alone, from the solve's start: at the
        # headline and its first 1024 instances (secondary keys), and at
        # the streamed B=1 n=1000 float64 case, the shape of the row-sharded
        # dense solve that runs the step kernels (the row's numbers).
        at = ((b.shape[0], 1024) if label.startswith("headline B=") else
              (1,) if label.endswith("streamed") else ())
        for Bn in at:
            bb, dd, xx, tt = b[:Bn].contiguous(), dinv[:Bn].contiguous(), x0[:Bn].contiguous(), tol_rel[:Bn]
            products = k6.DenseOperator(Pm[:Bn].contiguous(), Am[:Bn].contiguous(), rho[:Bn].contiguous())
            x, r, z, p, rz, rr, tol2 = k6._start(products, sigma, dd, bb, xx, tt.contiguous())
            u, v = products(p)
            nn = bb.shape[1]
            pairs = torch.stack([rz, rz]), torch.stack([rr, rr])
            Mp = torch.empty_like(bb)
            parts = torch.empty((3, Bn, _build.library().osqp_cg_parts(nn)), dtype=bb.dtype, device=dev)
            steps_t = torch.zeros(Bn, dtype=torch.int32, device=dev)
            # the step against cg_step_plain, its sums in the kernel's order,
            # on copies: the same bits of x, r, z, p, rz and r'r
            xc, rc, zc, pc = x.clone(), r.clone(), z.clone(), p.clone()
            k6.cg_step(pc, u, v, float(sigma), dd, tol2, *pairs, 0, Mp, xc, rc, zc, parts, steps_t)
            want = k6.cg_step_plain(p, u, v, sigma, dd, x, r, rz, rr, tol2, dot=k6.kernel_dot)
            got = (xc, rc, zc, pc, pairs[0][1], pairs[1][1])
            step_diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
            step_same = all(same_bits(g, w) for g, w in zip(got, want))
            where = f"{label.split(',')[0]} at B={Bn}"
            print(f"K6 cg_step {where}: one step against cg_step_plain (kernel_dot) bit-identical {step_same}, "
                  f"max |diff| {step_diff:.3e}")
            require(step_same, f"K6's step differs from cg_step_plain at {where}")
            kernel = lambda: k6.cg_step(p, u, v, float(sigma), dd, tol2, *pairs, 0, Mp, x, r, z, parts, steps_t)  # noqa: E731
            plain = lambda: k6.cg_step_plain(p, u, v, sigma, dd, x, r, rz, rr, tol2)  # noqa: E731
            elt = bb.element_size()
            # p, u, v, dinv, x, r read and x, r, z, p written once; 16 operations per element
            t = report_times(f"K6 cg_step {where}", kernel, plain, 50,
                             elt * Bn * nn * 10 + 3 * elt * Bn, {dtype_name(bb.dtype): 16 * Bn * nn})
            t["max_abs_err"] = step_diff
            if Bn == 1:
                step_stats = dict(t, library_ms=None, at=f"B=1 n={nn} {dtype_name(bb.dtype)}", **step_stats)
            elif b.dtype == torch.float32:
                step_stats[f"B{Bn}"] = t
    return step_stats, loop_stats, dense_stats


def cg_step_spy():
    """A measurement hook: the CG steps of every pcg_solve call (their
    tensors, read only at the end), for ms per CG step."""
    import contextlib

    from osqp_tpu_torch.ops import cg as k6

    seen = []

    @contextlib.contextmanager
    def hook():
        real = {name: getattr(k6, name) for name in ("pcg_solve_loop", "pcg_solve_stepwise")}

        def spy(fn):
            def call(*args, **kw):
                x, steps = fn(*args, **kw)
                seen.append(steps)
                return x, steps

            return call

        for name, fn in real.items():
            setattr(k6, name, spy(fn))
        try:
            yield seen
        finally:
            for name, fn in real.items():
                setattr(k6, name, fn)

    return hook()


def phase_sparse(dev):
    """solve_sparse with polish off against the JAX package's results in
    tests/data/torch_goldens/sparse_maros.npz, the CG on K6's device loop.
    Counts are set to 0 just before the CVXQP2_L solve and read just after
    it.  At CVXQP2_L and at the 8 copies of LISWET1 the same solve with the
    stepwise path (stepwise_everywhere) in the same call: the same bits,
    and both paths' solve ms, ms per CG step and launches, and the loop's
    idle share (the stepwise path's ~1e5 kernel events are not traced:
    processing them held most of the phase's time)."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.ops import cg as k6, ell as k5

    gold = np.load(SPARSE_GOLDENS)
    launches = None
    paths = {}
    # x and y against the golden, relative to its largest entry.  CVXQP2_L
    # is held to its eps (1e-3): its ADMM path is sensitive to the inexact
    # CG solves themselves, so that the JAX package's own run goes from 450
    # to 425 iterations when its inner tolerance cap moves by 1% (ROADMAP
    # queue 3), and two right runs end apart by more than 1e-5.
    xy_tol = {"CVXQP2_L/float64": 1e-3}
    for case, (name, dtype, B) in SPARSE_CASES.items():
        P, q, A, l, u = scenario(name, B)
        g = lambda f: gold[f"{case}/{f}"]
        main_path = case == "CVXQP2_L/float64"
        if main_path:
            reset_counts()
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cg_step_spy() as seen:
            res = ot.solve_sparse(P, q, A, l, u, dtype=dtype, verbose=False)
            status = res.status_val.cpu().numpy()
        wall = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        if main_path:
            launches = after
        delta = {k: after[k] - before[k] for k in K5_COUNTS + ("cg_step", "cg_loop", "term_products", "ruiz")}
        cg_steps = int(sum(int(k.max()) for k in seen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse_prepared(name, dtype, dev, B)
        torch.cuda.synchronize()
        setup = (time.perf_counter() - t0) * 1e3
        iters = res.iter.cpu().numpy()
        it = int(iters.max())
        x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
        obj_rel = float(np.max(np.abs(res.obj_val.cpu().numpy() - g("obj_val")) / np.abs(g("obj_val"))))
        dx = float(np.abs(x - g("x")).max() / np.abs(g("x")).max())
        dy = float(np.abs(y - g("y")).max() / np.abs(g("y")).max())
        print(f"sparse {case} B={B} n={x.shape[1]} m={y.shape[1]}: status {status.tolist()} (golden "
              f"{g('status_val').tolist()}), iterations {iters.tolist()} (golden {g('iter').tolist()}), obj relative "
              f"{obj_rel:.3e}, x and y within {dx:.3e} and {dy:.3e} of the golden's largest entry; launches {delta}, "
              f"{cg_steps} CG steps in {len(seen)} CG solves, {cg_steps / max(it, 1):.2f} per ADMM iteration; setup "
              f"{setup:.3f} ms, solve {wall:.3f} ms, {(wall - setup) / max(it, 1):.4f} ms per iteration")
        require(np.array_equal(status, g("status_val")), f"sparse {case}: status {status.tolist()}")
        require(np.isfinite(x).all() and np.isfinite(y).all(), f"sparse {case}: non-finite x or y")
        if dtype == "float64":
            tol = xy_tol.get(case, 1e-5)
            require(np.array_equal(iters, g("iter")) and obj_rel <= 1e-6 and dx <= tol and dy <= tol,
                    f"sparse {case} disagrees with the JAX package's run")
        else:
            require(np.abs(iters - g("iter")).max() <= 25, f"sparse {case}: iterations {iters.tolist()}")
        require(delta["ell_ops"] > 0 and delta["cg_loop"] == len(seen) > 0 and delta["cg_step"] == 0,
                f"sparse {case}: the CG did not run on K6's device loop alone")
        require(delta["term_products"] == delta["ruiz"] == 0, f"sparse {case}: a dense kernel launched")
        require(delta["ell_cg_start"] > 0, f"sparse {case}: the CG's start did not run fused")
        print(f"  K5 launches per solve {delta['ell_ops']} (grouped {delta['ell_group']}, start "
              f"{delta['ell_cg_start']}, scale {delta['ell_scale']}), {delta['ell_ops'] / max(it, 1):.3f} per ADMM "
              f"iteration")

        if main_path:
            # the same solve with the unfused start, then with the fused one
            # again (the first solve above paid for warming up), in turns
            def timed_solve():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = ot.solve_sparse(P, q, A, l, u, dtype=dtype, verbose=False)
                torch.cuda.synchronize()
                return r, (time.perf_counter() - t0) * 1e3

            before = read_counts()
            with unfused_start():
                res_u, wall_u = timed_solve()
            after = read_counts()
            _, wall_f = timed_solve()
            same = torch.equal(res_u.x, res.x) and torch.equal(res_u.y, res.y) and torch.equal(res_u.iter, res.iter)
            print(f"  {case} with the unfused start in the same call: x, y and iterations bit-identical {same}; "
                  f"solve {wall_u:.3f} ms, then the fused start's {wall_f:.3f}; K5 launches "
                  f"{after['ell_ops'] - before['ell_ops']} against {delta['ell_ops']}")
            require(same, f"sparse {case}: the fused and the unfused start differ")

        if case in ("CVXQP2_L/float64", "LISWET1_B8/float64"):
            # the same solve on the stepwise path, and both under the profiler
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with stepwise_everywhere(), cg_step_spy() as seen_s:
                res_s = ot.solve_sparse(P, q, A, l, u, dtype=dtype, verbose=False)
                torch.cuda.synchronize()
            wall_s = (time.perf_counter() - t0) * 1e3
            after = read_counts()
            steps_s = int(sum(int(k.max()) for k in seen_s))
            same = (torch.equal(res_s.x, res.x) and torch.equal(res_s.y, res.y)
                    and torch.equal(res_s.iter, res.iter) and steps_s == cg_steps)
            run = lambda: ot.solve_sparse(P, q, A, l, u, dtype=dtype, verbose=False)
            _, pwall, events = profiled(run)
            busy = event_ms(events)
            # the loop's device ms per CG step beside the bound of a step on this operator
            _, _, scaled_, _, rs_, fac_, _ = sparse_prepared(name, dtype, dev, B)
            nbytes, flops = loop_cost(k6._operator(fac_["P"], scaled_.A, rs_.rho_vec, plain=False), B, x.shape[1], 1)
            step_bound = bound(nbytes, flops)[0]
            loop_dev = event_ms(events, K6_LOOP)
            print(loop_step_line(f"{case} K6's loop in the solve", k6.last_plan, loop_dev, cg_steps, step_bound))
            paths[case] = dict(loop_ms=wall, stepwise_ms=wall_s, steps=cg_steps, loop_ms_per_step=wall / cg_steps,
                               stepwise_ms_per_step=wall_s / cg_steps, idle_loop=1 - busy / pwall,
                               idle_stepwise="not measured", loop_device_ms_per_step=loop_dev / cg_steps,
                               bound_ms_per_step=step_bound, plan=dataclasses.asdict(k6.last_plan))
            print(f"  {case} on the stepwise path in the same call: x, y and iterations bit-identical {same}; "
                  f"solve {wall_s:.3f} ms against the loop's {wall:.3f}; ms per CG step {wall_s / cg_steps:.4f} "
                  f"against {wall / cg_steps:.4f} ({wall / wall_s:.4f} of it); launches per solve: K6 "
                  f"{after['cg_step'] - before['cg_step']} steps and K5 {after['ell_ops'] - before['ell_ops']} "
                  f"against {delta['cg_loop']} loops and K5 {delta['ell_ops']}; under the profiler the loop's idle "
                  f"share {1 - busy / pwall:.3f} (wall {pwall:.3f} ms); loop run: {top_kernels(events, 4)}")
            require(same, f"sparse {case}: the stepwise path and the device loop differ")

    # Where a CVXQP2_L solve's time goes: one more solve under the profiler.
    P, q, A, l, u = scenario("CVXQP2_L")
    res, wall, events = profiled(lambda: ot.solve_sparse(P, q, A, l, u, dtype="float64", verbose=False))
    it = int(res.iter.max())
    k5_ms, k6_ms, busy = event_ms(events, K5_KERNELS), event_ms(events, K6_KERNELS), event_ms(events)
    print(f"sparse CVXQP2_L float64 under the profiler: wall {wall:.3f} ms over {it} iterations = {wall / it:.4f} "
          f"ms/iteration; K5 device time {k5_ms:.3f} ms ({k5_ms / wall:.3f} of the wall), K6 {k6_ms:.3f} ms "
          f"({k6_ms / wall:.3f}), all device work {busy:.3f} ms, idle share {1.0 - busy / wall:.3f}; "
          f"{top_kernels(events)}")
    return launches, paths


def phase_cg_dense(dev):
    """The cg backend on dense operands: solve_batch on the card against
    the CPU's plain path (float64, B=64, n=20, m=30), then the headline
    data at B=1024 in float32 beside the dense_inv run and beside the same
    cg solve on the step kernels (stepwise_everywhere) in the same call:
    wall ms, host reads and K6 launches of each; the dense loop's run must
    launch the dense loop once a CG solve and no step kernel, solve 0.99,
    give dense_inv's statuses and iterations within one check interval of
    the stepwise path's."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import linalg

    P, q, A, l, u = make_qps(64, 20, 30, seed=3, dtype=np.float64)
    kw = dict(dtype="float64", verbose=False, linsys_solver="cg")
    rg = ot.solve_batch(P, q, A, l, u, device=dev, **kw)
    rc = ot.solve_batch(P, q, A, l, u, device="cpu", **kw)
    same_status = torch.equal(rg.status_val.cpu(), rc.status_val)
    same_iter = torch.equal(rg.iter.cpu(), rc.iter)
    dx = float((rg.x.cpu() - rc.x).abs().max())
    dy = float((rg.y.cpu() - rc.y).abs().max())
    print(f"cg backend GPU vs CPU, f64 B=64 n=20 m=30: statuses equal {same_status}, iterations equal {same_iter}, "
          f"|dx|max {dx:.3e}, |dy|max {dy:.3e}")
    require(same_status and same_iter and dx <= 1e-6 and dy <= 1e-6, "the cg backend on the GPU disagrees with the CPU")

    n, m = HEADLINE["n"], HEADLINE["m"]
    args = on_device(make_qps(1024, n, m), torch.float32, dev)
    out, walls, counts = {}, {}, {}
    launches = None
    for leg in ("dense_inv", "cg", "cg stepwise"):
        backend = leg.split()[0]
        hook = stepwise_everywhere() if leg.endswith("stepwise") else contextlib.nullcontext()
        with hook:
            ot.solve_batch(*args, **{**SOLVE_KW, "linsys_solver": backend, "max_iter": 25})  # warm-up
            reset_counts()
            reads = linalg.host_reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ot.solve_batch(*args, **{**SOLVE_KW, "linsys_solver": backend})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            reads = linalg.host_reads - reads
            after = read_counts()
        if leg == "cg":
            launches = after
            require(after["cg_dense_loop"] > 0 and after["cg_step"] == 0 and after["cg_loop"] == 0,
                    "the cg backend on dense operands left the dense loop")
        iters = res.iter.float()
        solved = float((res.status_val == ot.OSQP_SOLVED).float().mean())
        out[leg], walls[leg], counts[leg] = res, wall, after
        print(f"{leg} backend headline B=1024 n={n} m={m} f32 [{CARD}]: solved {solved:.4f}, iterations mean "
              f"{float(iters.mean()):.2f} max {int(iters.max())}; {wall:.3f} ms; host reads {reads}; K6 dense loop "
              f"launches {after['cg_dense_loop']}, step launches {after['cg_step']}")
        require(solved >= 0.99, f"{leg} backend at the headline: solved {solved}")
    agree = int((out["cg"].status_val == out["dense_inv"].status_val).sum())
    spread = int((out["cg"].iter - out["cg stepwise"].iter).abs().max())
    interval = ot.Settings().check_termination
    print(f"cg backend headline: statuses equal to dense_inv's in {agree} of 1024 instances; iterations within "
          f"{spread} of the stepwise path's (one check interval: {interval}); wall {walls['cg']:.3f} ms against "
          f"dense_inv's {walls['dense_inv']:.3f} and the stepwise path's {walls['cg stepwise']:.3f} "
          f"({walls['cg stepwise'] / walls['cg']:.2f}x); 365.746 before the dense loop")
    require(agree == 1024, f"the cg backend's statuses differ from dense_inv's in {1024 - agree} instances")
    require(spread <= interval, f"the dense loop's iterations {spread} from the stepwise path's")
    return dict(launches, wall_ms=walls["cg"], stepwise_wall_ms=walls["cg stepwise"],
                dense_inv_wall_ms=walls["dense_inv"], stepwise_steps=counts["cg stepwise"]["cg_step"])


# The MPC cell: bench.py's bench_mpc (nx = 8, nu = 4, horizon 30: n = 372,
# m = 612, stages of b = 12), as tools/make_torch_goldens.py builds it.
MPC = dict(B=1000, nx=8, nu=4, horizon=30)
MPC_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "mpc.npz")
MPC_KW = dict(eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False)
# The kernels of K7 (csrc/block_tridiag.cu), by name in the profiler; the
# MPC solve launches no other kernel of these names (K8's lu_solve_kernel
# runs with polish only).
K7_KERNELS = ("factor_kernel", "solve_kernel")
SPARSE_POLISH_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "sparse_polish.npz")
# Steps of the polish PCG's bit check against its plain loop (phase
# sparse_polish), short of convergence (1997 steps in float32): the plain
# step summing in the kernels' order takes ~4 ms on the card.
PCG_CHECK_STEPS = 300


def mpc_scenarios(B=None, seed=0):
    """bench_mpc's scenario batch (bench.py:165-183): one random stable
    system, B initial states (MPC["B"] when None).  Returns (base
    problem, P, q, A, l, u)."""
    from osqp_tpu_torch.models import build_mpc_qp

    B = MPC["B"] if B is None else B
    nx, nu, horizon = MPC["nx"], MPC["nu"], MPC["horizon"]
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    xinits = rng.standard_normal((B, nx))
    l = np.tile(base.l, (B, 1))
    u = np.tile(base.u, (B, 1))
    l[:, :nx] = xinits
    u[:, :nx] = xinits
    stack = lambda a: np.broadcast_to(a, (B,) + a.shape)
    return base, stack(base.P), stack(base.q), stack(base.A), l, u


def mpc_prepared(B, dtype, dev):
    """The block_tridiag backend's set-up of the MPC batch on the card:
    config, scaled data, rho state and the reduced matrix M."""
    import torch

    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.types import DynSettings

    base, *arrays = mpc_scenarios(B)
    P, q, A, l, u = on_device(arrays, dtype, dev)
    n, m = base.P.shape[0], base.A.shape[0]
    s = solver.Settings(**MPC_KW, dtype=dtype, linsys_solver="block_tridiag", block_size=base.block_size)
    cfg = solver.make_config(n, m, s, dtype)
    dyn = DynSettings.make(dtype)
    rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
    scaled, _, rs, _, _ = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
    return base, scaled, rs, form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec).contiguous()


def k7_cost(B, Nb, b, dtype):
    """(bytes, operations) of K7's factor and of its solve, a multiply-
    subtract counted as two operations.  Factor: the band blocks of M (D
    and O) read once, C and G written once; the Cholesky of every stage
    ((b^3 - b) / 6 multiply-subtracts) and, on the Nb - 1 stages after
    the first, the row solve for G (b^2 (b - 1) / 2) and D - G G' on the
    lower triangle (b^2 (b + 1) / 2).  Solve: the lower triangles of C
    (b (b + 1) / 2 values a stage), G and r read once, x written once;
    the two triangular solves of every stage (2 b^2 operations) and, on
    the Nb - 1 stages after the first, the products with G_i and G_i'
    (4 b^2).  Every product and difference of K7 is rounded on its own
    (no FMA), so its operations floor is twice this operations figure
    (k7_no_fma_ms)."""
    elt = 4 if dtype_name(dtype) == "float32" else 8
    factor = (elt * B * 2 * (2 * Nb - 1) * b * b,
              {dtype_name(dtype): B * (Nb * (b**3 - b) // 3 + (Nb - 1) * 2 * b**3)})
    solve = (elt * B * ((Nb - 1) * b * b + Nb * b * (b + 1) // 2 + 2 * Nb * b),
             {dtype_name(dtype): B * (Nb * 2 * b * b + (Nb - 1) * 4 * b * b)})
    return factor, solve


def k7_no_fma_ms(flops):
    """K7's operations floor in ms: its products and differences each
    rounded on its own take twice the time of a bound that assumes fused
    multiply-adds."""
    return 2 * sum(f / PEAK_FLOPS[d] for d, f in flops.items()) * 1e3


def band_schur(B, Nb, b, dtype, dev, seed=None):
    """The reduced matrix M = P + sigma I + A' diag(rho) A of a random
    block-tridiagonal problem (block-diagonal P, rows of A on two adjacent
    stages) with Nb stages of b, and a random right-hand side, on the card."""
    import torch

    from osqp_tpu_torch.linsys.dense_chol import form_schur

    rng = np.random.default_rng(b if seed is None else seed)
    n = Nb * b
    P = np.zeros((B, n, n))
    for i in range(Nb):
        W = rng.standard_normal((B, b, b))
        P[:, i * b:(i + 1) * b, i * b:(i + 1) * b] = W @ W.transpose(0, 2, 1) / b + 0.5 * np.eye(b)
    A = np.zeros((B, (Nb - 1) * b, n))
    for i in range(Nb - 1):
        A[:, i * b:(i + 1) * b, i * b:(i + 2) * b] = rng.standard_normal((B, b, 2 * b))
    rho = np.abs(rng.standard_normal((B, A.shape[1]))) + 0.1
    P, A, rho = on_device((P, A, rho), dtype, dev)
    r = torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype, device=dev)
    return form_schur(P, A, 1e-6, rho).contiguous(), r


def phase_k7(dev):
    """K7 (block_tridiag) against its plain versions: both paths (b = 1, 5,
    12, 16, 32 on the warp path, 40 and 64 on the factor's cluster path
    and the wide solve) on random band matrices, B=200, in both dtypes;
    then on the reduced matrix
    of the MPC cell as the block_tridiag backend forms it (B=1000, b=12,
    Nb=31, float32) and at B=64 in float64: factor and solve bit for bit,
    two launches bit-identical; kernel, plain and library (the dense route:
    torch.linalg.cholesky of M, torch.cholesky_solve) times beside the
    bound."""
    import torch

    from osqp_tpu_torch.ops import block_tridiag as k7

    # both paths by block size: the warp path up to 32, the cluster path above
    for dtype in (torch.float64, torch.float32):
        paths = {}
        for b in (1, 5, 12, 16, 32, 40, 64):
            B, Nb = 200, 8
            M, r = band_schur(B, Nb, b, dtype, dev)
            before = (k7.launches_factor_warp, k7.launches_solve_warp, k7.launches_factor_cluster)
            C, G = k7.bt_factor(M, b)
            C2, G2 = k7.bt_factor(M, b)
            x, x2 = k7.bt_solve(C, G, r), k7.bt_solve(C, G, r)
            warp = (k7.launches_factor_warp - before[0], k7.launches_solve_warp - before[1]) == (2, 2)
            cluster = k7.launches_factor_cluster - before[2] == 2
            Cp, Gp = k7.bt_factor_plain(M, b)
            xp = k7.bt_solve_plain(Cp, Gp, r)
            torch.cuda.synchronize()
            require(warp == (b <= k7.WARP_MAX) and cluster == (not warp), f"K7 at b={b} took the wrong path")
            require(torch.equal(C, C2) and torch.equal(G, G2) and torch.equal(x, x2), f"K7: two launches differ at b={b}")
            require(torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp),
                    f"K7 differs from its plain version at b={b} {dtype_name(dtype)}")
            paths[b] = "warp" if warp else "cluster"
        print(f"K7 block_tridiag B=200 Nb=8 {dtype_name(dtype)}, paths by b {paths}: factor and solve bit-identical "
              f"to plain True, two launches bit-identical True")

    stats = None
    for B, dtype in ((MPC["B"], torch.float32), (64, torch.float64)):
        base, _, _, M = mpc_prepared(B, dtype, dev)
        b = base.block_size
        Nb = M.shape[-1] // b
        label = f"MPC B={B} n={M.shape[-1]} b={b} Nb={Nb} {dtype_name(dtype)}"
        g = torch.Generator(device=dev).manual_seed(7)
        r = torch.randn(B, Nb * b, generator=g, dtype=dtype, device=dev)
        C, G = k7.bt_factor(M, b)
        C2, G2 = k7.bt_factor(M, b)
        Cp, Gp = k7.bt_factor_plain(M, b)
        x, x2, xp = k7.bt_solve(C, G, r), k7.bt_solve(C, G, r), k7.bt_solve_plain(Cp, Gp, r)
        torch.cuda.synchronize()
        same = torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
        err = max(float((C - Cp).abs().max()), float((G - Gp).abs().max()), float((x - xp).abs().max()))
        # the solve against M itself: backward error |M x - r| / (|M| |x|)
        resid = float((torch.bmm(M, x[:, :, None])[:, :, 0] - r).abs().max())
        scale = float(M.abs().sum(-1).max()) * float(x.abs().max())
        print(f"K7 block_tridiag {label}: factor and solve bit-identical to plain {same}, |k-p|max {err:.3e}; two "
              f"launches bit-identical {torch.equal(C, C2) and torch.equal(G, G2) and torch.equal(x, x2)}; "
              f"backward error of the solve {resid / scale:.3e}")
        require(same, f"K7 differs from its plain version at {label}")
        require(torch.equal(C, C2) and torch.equal(G, G2) and torch.equal(x, x2), f"K7: two launches differ at {label}")
        require(bool(torch.isfinite(x).all()) and resid <= BACKWARD_BOUND[dtype_name(dtype)] * scale,
                f"K7's solve does not solve M x = r at {label}")
        (fb, ff), (sb, sf) = k7_cost(B, Nb, b, dtype)
        reps = 20 if B > 100 else 50
        tf = report_times(f"K7 bt_factor {label}", lambda: k7.bt_factor(M, b), lambda: k7.bt_factor_plain(M, b),
                          reps, fb, ff)
        ts = report_times(f"K7 bt_solve {label}", lambda: k7.bt_solve(C, G, r), lambda: k7.bt_solve_plain(C, G, r),
                          reps, sb, sf)
        # library_ms only: the dense route to the same x, which the port never takes
        L = torch.linalg.cholesky(M)
        lib_f = cuda_ms(lambda: torch.linalg.cholesky(M), reps)
        lib_s = cuda_ms(lambda: torch.cholesky_solve(r[:, :, None], L), reps)
        print(f"  library: torch.linalg.cholesky(M) {lib_f:.4f} ms, torch.cholesky_solve {lib_s:.4f} ms")
        if stats is None:
            stats = (dict(tf, max_abs_err=err, library_ms=lib_f), dict(ts, max_abs_err=err, library_ms=lib_s))
    return stats


def phase_mpc(dev):
    """The MPC cell through solve_batch: block_tridiag and dense_inv on
    bench_mpc's data (B=1000, float32, eps 1e-3, polish off): the same
    statuses, all solved, none at MAX_ITER; the first 16 scenarios against
    mpc.npz; median of 5 timed solves per leg.  Counts are set to 0 just
    before each leg's first solve and read just after it: the
    block_tridiag leg is K7's main path, the dense_inv leg K1r's resident
    path's (its refined loop body).  Then the Solver with block_tridiag on
    scenario 0 in float64."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import batch, solver
    from osqp_tpu_torch.linsys import dense_inv
    from osqp_tpu_torch.types import DynSettings

    gold = np.load(MPC_GOLDENS)
    base, *arrays = mpc_scenarios()
    B, b = MPC["B"], base.block_size
    n, m = base.P.shape[0], base.A.shape[0]
    P, q, A, l, u = on_device(arrays, torch.float32, dev)
    torch.cuda.synchronize()
    legs = {"block_tridiag": dict(block_size=b), "dense_inv": {}}
    out, launches = {}, {}
    for backend, extra in legs.items():
        kw = dict(MPC_KW, dtype="float32", linsys_solver=backend, **extra)
        main_path = backend == "block_tridiag"
        rescued0 = dense_inv.guard_rescued
        reset_counts()
        before = read_counts()
        t0 = time.perf_counter()
        res = ot.solve_batch(P, q, A, l, u, **kw)
        status = res.status_val.cpu().numpy()
        first_s = time.perf_counter() - t0
        after = read_counts()
        launches[backend] = after
        delta = {k: after[k] - before[k] for k in after}
        iters = res.iter.cpu().numpy()
        x = res.x.cpu().numpy()
        solved = float(np.mean(status == ot.OSQP_SOLVED))
        times = []
        for _ in range(5):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ot.solve_batch(P, q, A, l, u, **kw)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        s = solver.Settings(**kw)
        cfg = solver.make_config(n, m, s, torch.float32)
        dyn = DynSettings.make(torch.float32)
        rho0 = torch.full((B,), s.rho, dtype=torch.float32, device=dev)
        setup_ms = cuda_ms(lambda: batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None), reps=3,
                           warmup=1)
        med = statistics.median(times)
        print(f"mpc {backend} B={B} n={n} m={m} b={b} f32: first solve {first_s:.3f} s, solved {solved:.4f}, "
              f"iterations mean {iters.mean():.2f} max {iters.max()}; launches {delta}; the residual guard sent "
              f"{dense_inv.guard_rescued - rescued0} instances to Cholesky")
        print(f"mpc {backend} timed solves (ms, CUDA events, data on the card): {[round(t, 3) for t in times]}; "
              f"median {med:.3f} ms, spread {min(times):.3f}..{max(times):.3f}, {B / (med / 1e3):.1f} QPs/s; setup "
              f"{setup_ms:.3f} ms; {(med - setup_ms) / int(iters.max()):.4f} ms per iteration")
        require(solved == 1.0, f"mpc {backend}: solved {solved}")
        require(not np.any(status == ot.OSQP_MAX_ITER_REACHED), f"mpc {backend}: an instance hit MAX_ITER_REACHED")
        require(np.isfinite(x).all() and x.shape == (B, n) and res.y.shape == (B, m), f"mpc {backend}: x")
        k = 16
        g_status, g_iter = gold["MPC16/float32/status_val"], gold["MPC16/float32/iter"]
        print(f"  first {k} against the JAX package's float32 run: statuses equal "
              f"{np.array_equal(status[:k], g_status)}, iterations {iters[:k].tolist()} (golden {g_iter.tolist()})")
        require(np.array_equal(status[:k], g_status), f"mpc {backend}: statuses of the first {k} differ")
        require(np.abs(iters[:k] - g_iter).max() <= 25, f"mpc {backend}: iterations of the first {k} differ")
        if main_path:
            require(delta["bt_factor"] >= 1 and delta["bt_solve"] == int(iters.max()),
                    f"mpc block_tridiag: K7 launched {delta['bt_factor']} / {delta['bt_solve']} times")
            require((delta["bt_factor_warp"], delta["bt_solve_warp"]) == (delta["bt_factor"], delta["bt_solve"]),
                    "mpc block_tridiag: K7 did not take the warp path at b = 12")
            require(delta["admm_iter"] == delta["chol_inverse"] == delta["kkt_lu_factor"] == 0,
                    "mpc block_tridiag: a dense_inv or K8 kernel launched")
        else:
            require(delta["bt_factor"] == delta["bt_solve"] == 0, "mpc dense_inv: K7 launched")
            require(delta["chol_inverse_leaf"] > 0 and delta["chol_inverse"] == 0,
                    "mpc dense_inv: the factor did not take K2's route above max_n")
            require(delta["chol_inverse_leaf_cluster"] == 0,
                    "mpc dense_inv: a K2 leaf took the cluster form at B = 1000")
            require(delta["admm_iter_refined"] > 0, "mpc dense_inv: K1r never launched")
            require(delta["admm_iter_refined_resident"] == delta["admm_iter_refined"],
                    f"mpc dense_inv: K1r left the resident path ({delta['admm_iter_refined_resident']} of "
                    f"{delta['admm_iter_refined']} resident)")
        # where one solve's time goes: once more under the profiler
        _, wall, events = profiled(lambda: ot.solve_batch(P, q, A, l, u, **kw))
        busy = event_ms(events)
        k1r_ms = event_ms(events, ("refined_resident_kernel",))
        print(f"mpc {backend} under the profiler: wall {wall:.3f} ms, all device work {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall:.3f}; K7 {event_ms(events, K7_KERNELS):.3f} ms; K1r resident {k1r_ms:.3f} ms; "
              f"by kernel: {top_kernels(events)}")
        out[backend] = (status, iters)
    same = np.array_equal(out["block_tridiag"][0], out["dense_inv"][0])
    print(f"mpc: statuses of block_tridiag equal to dense_inv's {same}; iterations equal in "
          f"{int((out['block_tridiag'][1] == out['dense_inv'][1]).sum())} of {B}")
    require(same, "mpc: block_tridiag and dense_inv statuses differ")

    g = lambda f: gold[f"MPC1/float64/{f}"]
    before = read_counts()
    r = ot.Solver(base.P, base.q, base.A, arrays[3][0], arrays[4][0], device=dev, dtype="float64",
                  linsys_solver="block_tridiag", block_size=b, **MPC_KW).solve()
    after = read_counts()
    print(f"mpc Solver block_tridiag scenario 0 float64 (B=1): K7 launches, setup and solve: factor "
          f"{after['bt_factor'] - before['bt_factor']}, solve {after['bt_solve'] - before['bt_solve']}")
    dx, dy = float(np.abs(r.x - g("x")[0]).max()), float(np.abs(r.y - g("y")[0]).max())
    print(f"mpc Solver block_tridiag scenario 0 float64: {r.info.status}, {r.info.iter} iterations (golden "
          f"{int(g('iter')[0])}), |dx|max {dx:.3e}, |dy|max {dy:.3e}; setup {r.info.setup_time * 1e3:.3f} ms, solve "
          f"{r.info.solve_time * 1e3:.3f} ms")
    require(r.info.status_val == int(g("status_val")[0]) and r.info.iter == int(g("iter")[0]) and dx <= 1e-6
            and dy <= 1e-6, "mpc Solver disagrees with the JAX package's run")
    return launches


def large_stage_mpc(b, B=4, horizon=2, seed=0):
    """A stage-structured MPC batch with stages of b = nx + nu variables
    (nx = 2 b / 3, horizon 2: three stages), B scenarios by their initial
    state.  Returns (base problem, P, q, A, l, u)."""
    from osqp_tpu_torch.models import build_mpc_qp

    nx = 2 * b // 3
    nu = b - nx
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=horizon, xmin=np.full(nx, -10.0),
                        xmax=np.full(nx, 10.0), umin=np.full(nu, -1.0), umax=np.full(nu, 1.0))
    l, u = np.tile(base.l, (B, 1)), np.tile(base.u, (B, 1))
    l[:, :nx] = u[:, :nx] = rng.standard_normal((B, nx))
    stack = lambda a: np.broadcast_to(a, (B,) + a.shape)
    return base, stack(base.P), stack(base.q), stack(base.A), l, u


def k7_bits(M, r, b, label, expect, **kw):
    """K7's factor on the path ``expect`` (counted) against the plain
    version at M, with the wide solve (counted): bit for bit, two launches
    bit-identical, the solve's backward error against M.  Returns
    |kernel - plain|max (0 when bit for bit)."""
    import torch

    from osqp_tpu_torch.ops import block_tridiag as k7

    count = lambda: (getattr(k7, f"launches_factor_{expect}"), k7.launches_solve_wide)
    before = count()
    C, G = k7.bt_factor(M, b, **kw)
    C2, G2 = k7.bt_factor(M, b, **kw)
    x, x2 = k7.bt_solve(C, G, r), k7.bt_solve(C, G, r)
    Cp, Gp = k7.bt_factor_plain(M, b)
    xp = k7.bt_solve_plain(Cp, Gp, r)
    torch.cuda.synchronize()
    require(tuple(a - b_ for a, b_ in zip(count(), before)) == (2, 2),
            f"K7 at {label} did not take the {expect} path and the wide solve")
    require(torch.equal(C, C2) and torch.equal(G, G2) and torch.equal(x, x2), f"K7: two launches differ at {label}")
    same = torch.equal(C, Cp) and torch.equal(G, Gp) and torch.equal(x, xp)
    err = max(float((C - Cp).abs().max()), float((G - Gp).abs().max()), float((x - xp).abs().max()))
    resid = float((torch.bmm(M, x[:, :, None])[:, :, 0] - r).abs().max())
    scale = float(M.abs().sum(-1).max()) * float(x.abs().max())
    print(f"K7 {expect} path {label}: factor and solve bit-identical to plain {same}, |k-p|max {err:.3e}; two "
          f"launches bit-identical True; backward error of the solve {resid / scale:.3e}")
    require(same, f"K7's {expect} path differs from its plain version at {label}")
    require(bool(torch.isfinite(x).all()) and resid <= BACKWARD_BOUND[dtype_name(M.dtype)] * scale,
            f"K7's solve does not solve M x = r at {label}")
    return err


def phase_k7_device(dev):
    """K7 above a warp (b > 32): the factor's cluster path (each instance
    over a thread-block cluster, its strips in shared memory, up to
    cluster_max_block) bit for bit against the plain versions at b = 33,
    140 and 256 in float32 and 33, 99 and 256 in float64, in clusters of
    cluster_plan's size and of every other size that fits; the device
    path (the same steps with the strips in C's and G's slots) above
    cluster_max_block, at b = 849 in float64 (band and panel in device
    memory) and where named at each of those b; each with the wide solve
    (one CTA an instance, by panels), two launches bit-identical; the
    wide solve's quotient route against the division on random and
    edge-case pairs.  Then stage-structured MPC batches at b = 140
    (float32), 99 (float64) and cluster_max_block + 1 (float64, the
    device path) through solve_batch and the Solver with block_tridiag
    against the CPU path (statuses and iterations equal, float64 x and y
    within 1e-6), the counts set to 0 just before each solve_batch and
    each Solver solve and read just after, the factor's path and the
    wide solve counted in both.  Then, at the batches' reduced matrices,
    the factor timed on the cluster path (every cluster size that fits)
    beside the device path named there, and on the device path at the
    b = cluster_max_block + 1 batch's; and the wide solve at the b = 140
    and cluster_max_block + 1 batches' factors; each beside the plain
    version, the library (torch.linalg.cholesky, torch.cholesky_solve),
    the bound and the operations floor without fused multiply-adds, in
    one call."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import _build, batch, solver
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.ops import block_tridiag as k7
    from osqp_tpu_torch.types import DynSettings

    sms = _build.sm_count(dev)
    worst = {"cluster": 0.0, "device": 0.0}
    for dtype, sizes in ((torch.float32, (33, 140, 256)), (torch.float64, (33, 99, 256))):
        for b in sizes:
            B, Nb = 8, 3
            M, r = band_schur(B, Nb, b, dtype, dev)
            plan = k7.cluster_plan(b, B, dtype, sms)
            require(k7.factor_path(b, dtype) == "cluster", f"K7 at b={b} {dtype_name(dtype)}: not the cluster path")
            for k in (None,) + tuple(c for c in k7.CLUSTERS if c != plan and k7.cluster_fits(b, c, dtype)):
                kw = {} if k is None else dict(path="cluster", cluster=k)
                label = f"b={b} B={B} Nb={Nb} {dtype_name(dtype)}, clusters of {plan if k is None else k}"
                worst["cluster"] = max(worst["cluster"], k7_bits(M, r, b, label, "cluster", **kw))
            label = f"b={b} B={B} Nb={Nb} {dtype_name(dtype)}, named"
            worst["device"] = max(worst["device"], k7_bits(M, r, b, label, "device", path="device"))
        b = k7.cluster_max_block(dtype) + 1
        M, r = band_schur(2, 3, b, dtype, dev)
        require(k7.factor_path(b, dtype) == "device", f"K7 at b={b}: not the device path")
        worst["device"] = max(worst["device"], k7_bits(M, r, b, f"b={b} B=2 Nb=3 {dtype_name(dtype)}", "device"))
    # the device path with its band and panel in device memory
    b = 849
    require(k7.device_scratch(b, torch.float64) > 0 and k7.device_scratch(b - 1, torch.float64) == 0,
            "K7's device path keeps its band in shared memory at b = 849 in float64")
    M, r = band_schur(1, 3, b, torch.float64, dev)
    worst["device"] = max(worst["device"], k7_bits(M, r, b, f"b={b} B=1 Nb=3 float64, band in device memory",
                                                   "device"))
    # the wide solve's quotient route: the division's bits
    for dtype in (torch.float32, torch.float64):
        g = torch.Generator(device=dev).manual_seed(11)
        nq = 1 << 22
        scale = lambda: torch.exp2(torch.randint(-60, 60, (nq,), generator=g, device=dev).to(dtype))
        a = torch.randn(nq, generator=g, dtype=dtype, device=dev) * scale()
        d = torch.randn(nq, generator=g, dtype=dtype, device=dev) * scale()
        a[:64], a[64:128], d[128:192], a[192:256], d[256:320] = 0.0, -0.0, float("nan"), float("inf"), 0.0
        q, ref = k7.route_quotient(a, d), a / d
        ints = torch.int32 if dtype == torch.float32 else torch.int64
        num = ~torch.isnan(ref)
        differ = int((q.view(ints)[num] != ref.view(ints)[num]).sum()) + int((torch.isnan(q) != ~num).sum())
        print(f"K7 wide solve's quotient route {dtype_name(dtype)}: {nq} pairs (exponents -60..60 on both sides, "
              f"zeros, infinities, NaNs), {differ} differ from the division's bits")
        require(differ == 0, f"K7's quotient route differs from the division in {dtype_name(dtype)}")

    launches = {}
    for dtype, b in (("float32", 140), ("float64", 99), ("float64", k7.cluster_max_block(torch.float64) + 1)):
        path = k7.factor_path(b, getattr(torch, dtype))
        base, *arrays = large_stage_mpc(b)
        n, m, B = base.P.shape[0], base.A.shape[0], arrays[0].shape[0]
        kw = dict(MPC_KW, dtype=dtype, linsys_solver="block_tridiag", block_size=b)
        args = on_device(arrays, getattr(torch, dtype), dev)
        torch.cuda.synchronize()
        reset_counts()
        rg = ot.solve_batch(*args, **kw)
        status = rg.status_val.cpu().numpy()
        counts = read_counts()
        launches.setdefault(path, counts)
        rc = ot.solve_batch(*arrays, device="cpu", **kw)
        torch.cuda.synchronize()
        reset_counts()
        sg = ot.Solver(base.P, base.q, base.A, arrays[3][0], arrays[4][0], device=dev, **kw).solve()
        scounts = read_counts()
        sc = ot.Solver(base.P, base.q, base.A, arrays[3][0], arrays[4][0], device="cpu", **kw).solve()
        dx = float((rg.x.cpu() - rc.x).abs().max())
        dy = float((rg.y.cpu() - rc.y).abs().max())
        sdx, sdy = float(np.abs(sg.x - sc.x).max()), float(np.abs(sg.y - sc.y).max())
        label = f"b={b} (nx {2 * b // 3}, nu {b - 2 * b // 3}, 3 stages) B={B} n={n} m={m} {dtype}"
        k7_counts = lambda c: dict((k, c[k]) for k in c if k.startswith("bt"))
        print(f"block_tridiag {label}, {path} path: solve_batch statuses {status.tolist()} (CPU "
              f"{rc.status_val.tolist()}), iterations {rg.iter.tolist()} (CPU {rc.iter.tolist()}), |dx|max {dx:.3e}, "
              f"|dy|max {dy:.3e}; Solver scenario 0: {sg.info.status}, {sg.info.iter} iterations (CPU "
              f"{sc.info.status}, {sc.info.iter}), |dx|max {sdx:.3e}, |dy|max {sdy:.3e}; K7 launches "
              f"{k7_counts(counts)}, in the Solver's solve {k7_counts(scounts)}")
        for where, c in (("solve_batch", counts), ("the Solver", scounts)):
            require(c[f"bt_factor_{path}"] == c["bt_factor"] >= 1,
                    f"block_tridiag {label}: K7's {path} path did not run in {where}")
            require(c["bt_solve_wide"] == c["bt_solve"] >= 1,
                    f"block_tridiag {label}: K7's wide solve did not run in {where}")
        require(np.array_equal(status, rc.status_val.numpy()) and torch.equal(rg.iter.cpu(), rc.iter),
                f"block_tridiag {label}: solve_batch on the card disagrees with the CPU path")
        require(sg.info.status_val == sc.info.status_val and sg.info.iter == sc.info.iter,
                f"block_tridiag {label}: the Solver on the card disagrees with the CPU path")
        require((status == ot.OSQP_SOLVED).all(), f"block_tridiag {label}: not every instance solved")
        if dtype == "float64":
            require(max(dx, dy, sdx, sdy) <= 1e-6, f"block_tridiag {label}: x or y off the CPU path's by more than 1e-6")

    # the factor and the wide solve at the batches' reduced matrices, each
    # path where the main path takes it, in one call: the cluster path at
    # b = 140 (float32) and 99 (float64) in every cluster size that fits,
    # beside the device path named there; the device path at b =
    # cluster_max_block + 1 (float64); the wide solve at b = 140 (float32)
    # and cluster_max_block + 1 (float64); each beside its plain version,
    # the library (torch.linalg.cholesky, torch.cholesky_solve) and the
    # bound
    stats, solve_stats = {}, {}
    for dtype, b in ((torch.float32, 140), (torch.float64, 99),
                     (torch.float64, k7.cluster_max_block(torch.float64) + 1)):
        base, *arrays = large_stage_mpc(b)
        P, q, A, l, u = on_device(arrays, dtype, dev)
        B, n, m = P.shape[0], P.shape[1], A.shape[1]
        s = solver.Settings(**MPC_KW, dtype=dtype, linsys_solver="block_tridiag", block_size=b)
        cfg = solver.make_config(n, m, s, dtype)
        dyn = DynSettings.make(dtype)
        rho0 = torch.full((B,), s.rho, dtype=dtype, device=dev)
        scaled, _, rs, _, _ = batch._prepare(cfg, s.scaling, P, q, A, l, u, rho0, dyn, None, None)
        M = form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec).contiguous()
        Nb = n // b
        path = k7.factor_path(b, dtype)
        (fb, ff), (sb, sf) = k7_cost(B, Nb, b, dtype)
        no_fma = k7_no_fma_ms(ff)
        label = f"b={b} B={B} Nb={Nb} {dtype_name(dtype)}"
        if path == "cluster":
            plan = k7.cluster_plan(b, B, dtype, sms)
            st = report_times(f"K7 bt_factor cluster path {label}, clusters of {plan}", lambda: k7.bt_factor(M, b),
                              lambda: k7.bt_factor_plain(M, b), 5, fb, ff)
            sizes = {}
            for k in k7.CLUSTERS:
                if k7.cluster_fits(b, k, dtype):
                    sizes[k] = cuda_ms(lambda: k7.bt_factor(M, b, path="cluster", cluster=k), 20)
            dv = cuda_ms(lambda: k7.bt_factor(M, b, path="device"), 20)
            again = cuda_ms(lambda: k7.bt_factor(M, b), 20)
            # library_ms only: the dense route, which the port never takes
            lib = cuda_ms(lambda: torch.linalg.cholesky(M), 20)
            print(f"  cluster path by CTAs a cluster (ms): {({k: round(v, 4) for k, v in sizes.items()})}; planned "
                  f"({plan}) again {again:.4f} ms; device path named {dv:.4f} ms; library torch.linalg.cholesky(M) "
                  f"{lib:.4f} ms; cluster over library {again / lib:.3f}, device over cluster {dv / again:.2f}; "
                  f"operations without fused multiply-add {no_fma:.4f} ms, share {no_fma / again:.3f}")
            st.update(library_ms=lib, device_named_ms=dv, by_cluster=sizes, cluster=plan, bound_no_fma_ms=no_fma)
        else:
            require(path == "device", f"K7 at b={b} {dtype_name(dtype)}: not the device path")
            plan = k7.device_plan(B, sms)
            st = report_times(f"K7 bt_factor device path {label}, clusters of {plan}", lambda: k7.bt_factor(M, b),
                              lambda: k7.bt_factor_plain(M, b), 5, fb, ff)
            sizes = {k: cuda_ms(lambda: k7.bt_factor(M, b, path="device", cluster=k), 10) for k in k7.CLUSTERS}
            lib = cuda_ms(lambda: torch.linalg.cholesky(M), 20)
            print(f"  device path by CTAs a cluster (ms): {({k: round(v, 4) for k, v in sizes.items()})}; library "
                  f"torch.linalg.cholesky(M) {lib:.4f} ms; device over library {st['ms'] / lib:.3f}; operations "
                  f"without fused multiply-add {no_fma:.4f} ms, share {no_fma / st['ms']:.3f}")
            st.update(library_ms=lib, by_cluster=sizes, cluster=plan, bound_no_fma_ms=no_fma, at=label)
        stats[path if path == "device" else dtype_name(dtype)] = st
        if b == 99:
            continue
        # the wide solve on this batch's factors
        C, G = k7.bt_factor(M, b)
        g = torch.Generator(device=dev).manual_seed(b)
        r = torch.randn(B, n, generator=g, dtype=dtype, device=dev)
        _, warps = k7.solve_plan(b, dtype)
        ss = report_times(f"K7 bt_solve wide {label}, CTAs of {warps} warps", lambda: k7.bt_solve(C, G, r),
                          lambda: k7.bt_solve_plain(C, G, r), 20, sb, sf)
        L = torch.linalg.cholesky(M)  # outside the timed region
        rc = r[:, :, None].contiguous()
        lib = cuda_ms(lambda: torch.cholesky_solve(rc, L), 50)
        x, xp = k7.bt_solve(C, G, r), k7.bt_solve_plain(C, G, r)
        torch.cuda.synchronize()
        require(torch.equal(x, xp), f"K7's wide solve differs from its plain version at {label}")
        print(f"  library torch.cholesky_solve {lib:.4f} ms; wide solve over library {ss['ms'] / lib:.3f}; "
              f"bit-identical to plain True")
        ss.update(library_ms=lib, warps=warps, max_abs_err=0.0, at=label)
        solve_stats[dtype_name(dtype)] = ss
    cluster_stats = dict(stats["float32"], max_abs_err=worst["cluster"], float64=stats["float64"])
    device_stats = dict(stats["device"], max_abs_err=worst["device"],
                        named_b140_float32_ms=stats["float32"]["device_named_ms"])
    wide_stats = dict(solve_stats["float64"], float32=solve_stats["float32"])
    return launches, cluster_stats, device_stats, wide_stats


def phase_dense_ops(dev):
    """The other dense backends' torch.library operators
    (csrc/torch_ops.cpp) against their ctypes launches, bit for bit, on
    one input each: K7's factor (bt_factor) on the warp path at the MPC
    cell's reduced matrix (B=1000, b=12, Nb=31, float32), on the cluster
    path at b=140 (B=4, Nb=3, float32) and on the device path at b=362
    (Nb=3, float64) for B = 1 to 4; its solve (bt_solve) in the warp
    layout (the MPC cell) and the wide one (b=140 float32, b=362
    float64); K6's step (cg_step) on the cg backend's dense system at the
    headline shape (B=1024, n=100, m=200, float32, every fourth instance
    converged at the start), three steps in turn against the in-place
    launch, and the traced stepwise PCG (pcg_solve_stepwise_program: a
    while_loop of 8 operator steps a turn and a cond for the tail, run
    eagerly) against the live stepwise path at a cap of 13; K6's dense
    loop (cg_dense_loop) on the same system, from x0 and from zero,
    against its live launch.  The operators count no launch.  Each operator's ms beside its launch's
    (CUDA events, means of 20 after 2 warm-up calls)."""
    import torch

    from osqp_tpu_torch.linsys import cg as cg_backend
    from osqp_tpu_torch.ops import block_tridiag as k7, cg as k6

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, _, M = mpc_prepared(MPC["B"], torch.float32, dev)
    cases = [("warp, the MPC cell", M, 12), *(
        (f"{label}", band_schur(B, 3, b, dtype, dev)[0], b)
        for label, B, b, dtype in (("cluster, B=4", 4, 140, torch.float32),
                                   *((f"device, B={B}", B, 362, torch.float64) for B in (1, 2, 3, 4))))]
    stats = {}
    for label, M, b in cases:
        path = k7.factor_path(b, M.dtype)
        cluster = {"warp": lambda: 0, "cluster": lambda: k7.cluster_plan(b, M.shape[0], M.dtype, sms),
                   "device": lambda: k7.device_plan(M.shape[0], sms)}[path]()
        before = read_counts()
        C, G = k7.bt_factor_op(M, b, path, cluster)
        C0, G0 = k7.bt_factor(M, b)
        r = torch.randn(M.shape[0], M.shape[1], dtype=M.dtype, device=dev)
        warps = k7.solve_plan(b, M.dtype)[1]
        x = k7.bt_solve_op(C, G, r, warps)
        x0 = k7.bt_solve(C0, G0, r)
        torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
        ok = same_bits(C, C0) and same_bits(G, G0) and same_bits(x, x0)
        line = (f"K7 operators bt_factor / bt_solve, {label}, b={b} Nb={M.shape[1] // b} {dtype_name(M.dtype)} "
                f"({path} path, clusters of {cluster}; solve {warps} warps) [{CARD}]: bit for bit with the ctypes "
                f"launches {ok}; launches counted {counted}")
        if label.startswith(("warp", "cluster", "device, B=1")):
            op_ms = cuda_ms(lambda: k7.bt_factor_op(M, b, path, cluster), 20)
            ct_ms = cuda_ms(lambda: k7.bt_factor(M, b), 20)
            sop_ms = cuda_ms(lambda: k7.bt_solve_op(C, G, r, warps), 20)
            sct_ms = cuda_ms(lambda: k7.bt_solve(C0, G0, r), 20)
            line += (f"; factor ms operator {op_ms:.4f}, launch {ct_ms:.4f}; solve ms operator {sop_ms:.4f}, "
                     f"launch {sct_ms:.4f}")
            stats[f"k7 {path}"] = dict(factor_op_ms=op_ms, factor_ms=ct_ms, solve_op_ms=sop_ms, solve_ms=sct_ms)
        print(line)
        require(ok, f"K7's operators differ from the launches ({label})")
        require(set(counted) <= {"bt_factor", "bt_solve", f"bt_factor_{path}", "bt_solve_warp", "bt_solve_wide"}
                and counted.get("bt_factor") == 1 and counted.get("bt_solve") == 1,
                f"K7's operators counted launches ({label}): {counted}")

    n, m = HEADLINE["n"], HEADLINE["m"]
    dtype = torch.float32
    scaled, rs, _, dyn = path_operands(1024, n, m, dtype, dev, seed=4)
    fac = cg_backend.init(scaled.P, scaled.A, dyn.sigma, rs.rho_vec)
    op = k6._operator(scaled.P, scaled.A, rs.rho_vec, plain=False)
    x0 = torch.randn(1024, n, dtype=dtype, device=dev)
    u0, v0 = op(x0)
    b = u0 + float(fac["sigma"]) * x0 + v0 + 1e-3 * torch.randn(1024, n, dtype=dtype, device=dev)
    b[::4] = (u0 + float(fac["sigma"]) * x0 + v0)[::4]
    tol = torch.full((1024,), 1e-4, dtype=dtype, device=dev)
    sigma, dinv = fac["sigma"], fac["dinv"]
    x, rr_, z, p, rz, rr, tol2 = k6._start(op, sigma, dinv, b, x0, tol)
    steps = torch.zeros(1024, dtype=torch.int32, device=dev)
    state = (p, x, rr_, z, rz, rr, steps)
    live = [t.clone() for t in (p, x, rr_, z)]
    pairs = torch.stack([rz, torch.empty_like(rz)]), torch.stack([rr, torch.empty_like(rr)])
    live_steps, Mp = steps.clone(), torch.empty_like(b)
    parts = torch.empty((3, 1024, k6._build.library().osqp_cg_parts(n)), dtype=dtype, device=dev)
    ok = True
    before = read_counts()["cg_step"]
    for cur in (0, 1, 0):
        u, v = op(state[0])
        state = k6.cg_step_op(state[0], u, v, sigma, dinv, tol2, state[4], state[5], state[1], state[2], state[3],
                              state[6])
        k6.cg_step(live[0], u, v, float(sigma), dinv, tol2, *pairs, cur, Mp, live[1], live[2], live[3], parts,
                   live_steps)
        want = (*live, pairs[0][1 - cur], pairs[1][1 - cur], live_steps)
        ok = ok and all(same_bits(a, w) for a, w in zip(state, want))
    counted = read_counts()["cg_step"] - before
    u, v = op(p)
    op_ms = cuda_ms(lambda: k6.cg_step_op(p, u, v, sigma, dinv, tol2, rz, rr, x, rr_, z, steps), 20)
    step_ms = cuda_ms(lambda: k6.cg_step(live[0], u, v, float(sigma), dinv, tol2, *pairs, 0, Mp, live[1], live[2],
                                         live[3], parts, live_steps), 20)
    xs, ss = k6.pcg_solve_stepwise(op, sigma, dinv, b, tol, 13, x0)
    xg, sg = k6.pcg_solve_stepwise_program(op, sigma, dinv, b, tol, 13, x0)
    loop_ok = same_bits(xg, xs) and same_bits(sg, ss)
    print(f"K6 operator cg_step, the cg backend's dense system B=1024 n={n} m={m} f32 [{CARD}]: three steps bit for "
          f"bit with the in-place launch {ok} (ctypes launches counted {counted}, 3 expected: the operator's none); "
          f"the stepwise program at a cap of 13 (8 steps + a tail of 5) bit for bit with the live stepwise path "
          f"{loop_ok}, steps max {int(ss.max())}; a step's vector work ms operator {op_ms:.4f}, launch "
          f"{step_ms:.4f}")
    require(ok and counted == 3, "K6's step operator differs from its launch, or counted launches")
    require(loop_ok, "the stepwise program differs from the live stepwise path")
    stats["cg_step"] = dict(op_ms=op_ms, ms=step_ms)

    # K6's dense loop through its operator against the live launch, from x0
    # and from zero, on the plan the live solve takes
    ok, counted = True, 0
    for start in (x0, None):
        before = read_counts()["cg_dense_loop"]
        xk, sk = k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, 300, start)
        xo, so = k6.pcg_solve_dense_loop_op(op, sigma, dinv, b, tol, 300, start, plan=k6.last_dense_plan)
        torch.cuda.synchronize()
        counted += read_counts()["cg_dense_loop"] - before
        ok = ok and same_bits(xo, xk) and same_bits(so, sk)
    plan = k6.last_dense_plan
    dop_ms = cuda_ms(lambda: k6.pcg_solve_dense_loop_op(op, sigma, dinv, b, tol, 300, x0, plan=plan), 5)
    dl_ms = cuda_ms(lambda: k6.pcg_solve_dense_loop(op, sigma, dinv, b, tol, 300, x0), 5)
    print(f"K6 operator cg_dense_loop, the same system [{CARD}]: from x0 and from zero bit for bit with the live "
          f"launch {ok} (launches counted {counted}, 2 expected: the operator's none), steps max {int(sk.max())}; "
          f"plan {plan_text(plan)}; a solve's ms operator {dop_ms:.4f}, launch {dl_ms:.4f}")
    require(ok and counted == 2, "K6's dense loop operator differs from its launch, or counted launches")
    stats["cg_dense_loop"] = dict(op_ms=dop_ms, ms=dl_ms)
    return stats


def leaf_spy(fn, seen):
    """``fn()`` with each of K2's leaf launches held against its plain
    version on the same input: appends (n, |Tk - Tp|max relative, S) to
    ``seen`` for every leaf the call runs."""
    from osqp_tpu_torch.ops import spd_inverse as k2

    real = k2.chol_inverse_leaf

    def spy(S):
        T = real(S)
        seen.append((S.shape[-1], rel_err(T, k2.chol_inverse_leaf_plain(S))[1], S))
        return T

    k2.chol_inverse_leaf = spy
    try:
        return fn()
    finally:
        k2.chol_inverse_leaf = real


def plain_leaves(fn):
    """``fn()`` with K2's recursion on its plain leaves (the plain route)."""
    from osqp_tpu_torch.ops import spd_inverse as k2

    real = k2.chol_inverse_leaf
    k2.chol_inverse_leaf = k2.chol_inverse_leaf_plain
    try:
        return fn()
    finally:
        k2.chol_inverse_leaf = real


def one_block_leaves(fn):
    """``fn()`` with K2's leaves on one block an instance, as before the
    cluster form (the old tree, with leaf_n = max_n)."""
    from osqp_tpu_torch.ops import spd_inverse as k2

    real = k2.chol_inverse_leaf
    k2.chol_inverse_leaf = lambda S: real(S, cluster=0)
    try:
        return fn()
    finally:
        k2.chol_inverse_leaf = real


def tree_leaves(n, leaf_n):
    """The leaf sizes of K2's recursion at n with leaves of at most leaf_n."""
    from osqp_tpu_torch.ops import spd_inverse as k2

    if n <= leaf_n:
        return [n]
    h = k2.split(n)
    return tree_leaves(h, leaf_n) + tree_leaves(n - h, leaf_n)


def portfolio_batch(B, n=500, k=50, seed=0):
    """bench.py's portfolio leg (bench_portfolio, BASELINE config 3): B
    Markowitz problems of n assets and k factors, from default_rng(seed)."""
    from osqp_tpu_torch.models import build_portfolio

    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(B):
        mu = rng.standard_normal(n)
        F = rng.standard_normal((n, k)) / np.sqrt(k)
        D = np.abs(rng.standard_normal(n)) * np.sqrt(k)
        probs.append(build_portfolio(mu, F, D, gamma=1.0))
    return tuple(np.stack(v) for v in zip(*probs))


PORTFOLIO = dict(B=256, n=500, k=50, K=8)
# K2's route against its plain route (the same recursion on the plain
# leaves), |Xk - Xp|max relative, and each leaf against its plain version
# at the inputs the route gives it.  Measured on an H100 at the MPC cell,
# the portfolio leg, CVXQP2_M and max_n + 1: the routes at most 6.9e-4
# (float32, the portfolio) and 7.9e-15 (float64, CVXQP2_M), the leaves
# at most 4.7e-5 (float32, the portfolio's first) and 2.0e-15 (float64).
ROUTE_REL_TOL = {"float32": 2e-3, "float64": 1e-13}
LEAF_REL_TOL = {"float32": 1e-4, "float64": 2e-14}
# A route's inverse residual against the other routes': measured within
# 1.9x of the plain and the library route's (the MPC cell, float32).
ROUTE_RESID_FACTOR = 3
# The residual guard's rescue through the library (cholesky_inverse's
# triangular solves), which the portfolio leg's set-up must not run, and
# the library's Cholesky factor, which the set-up's convexity check of
# P + sigma I runs (as the JAX package's and the reference's set-up).
RESCUE_KERNELS = ("trsm", "potri")
LIBRARY_FACTOR = ("potrf", "potf", "magma", "cholesky")


def phase_k2_route(dev):
    """K2 above max_n: dense_inv.init's route (spd_inverse: the blocked
    recursion on the leaf kernel, Newton-Schulz, the scaling undone)
    against the plain route (the same recursion on the plain leaves), the
    old library route (torch's Cholesky, cholesky_inverse and the
    Newton-Schulz step) and torch.linalg.inv, at the shapes the main paths
    give it: the MPC cell (B=1000, n=372, float32), the portfolio leg
    (B=256, n=550, float32), CVXQP2_M (B=1, n=1000) in float64 and
    float32, and n = max_n + 1 in both dtypes (B=64); every leaf of one
    route call held against its plain version on the input it was given,
    the kernel route against the plain route, each route's worst inverse
    residual |I - M X|max against the refine gate, the instances each
    flags and those the residual guard sends to Cholesky, the leaves a
    call and those of the cluster form (which B at most half the SM count
    takes: CVXQP2_M's four leaves of at most 256 and the B=64 cases, not
    the MPC cell nor the portfolio), times with and without the guard
    beside the bound and, where the leaves take the cluster form, the old
    tree's (leaves of at most max_n on one block an instance) in the same
    call.  Then the leaf kernel timed at the portfolio's first leaf, and
    its cluster form at CVXQP2_M's first leaf in both dtypes."""
    import torch

    from osqp_tpu_torch import _build
    from osqp_tpu_torch.linsys import dense_inv
    from osqp_tpu_torch.linsys.dense_chol import form_schur
    from osqp_tpu_torch.ops import spd_inverse as k2

    def schur(arrays, dtype):
        scaled, rs, _, dyn = prepared(*on_device(arrays, dtype, dev))
        return form_schur(scaled.P, scaled.A, dyn.sigma, rs.rho_vec).contiguous()

    def spd(B, n, dtype):
        G = np.random.default_rng(n).standard_normal((B, n, n))
        return torch.as_tensor(G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n), dtype=dtype, device=dev)

    cases = [("MPC cell", lambda: mpc_prepared(MPC["B"], torch.float32, dev)[3]),
             ("portfolio leg", lambda: schur(portfolio_batch(PORTFOLIO["B"])[:5], torch.float32)),
             ("CVXQP2_M", lambda: schur(maros_dense("CVXQP2_M"), torch.float64)),
             ("CVXQP2_M", lambda: schur(maros_dense("CVXQP2_M"), torch.float32)),
             ("max_n + 1", lambda: spd(64, k2.max_n(torch.float32) + 1, torch.float32)),
             ("max_n + 1", lambda: spd(64, k2.max_n(torch.float64) + 1, torch.float64))]
    sms = _build.sm_count(dev)
    routes, cluster_leaves = {}, {}
    for name, make in cases:
        M = make()
        B, n, dtype = M.shape[0], M.shape[-1], M.dtype
        f32 = dtype == torch.float32
        gate = dense_inv._REFINE_TOL_F32 if f32 else dense_inv._REFINE_TOL_F64
        guard = dense_inv._GUARD_TOL_F32 if f32 else dense_inv._GUARD_TOL_F64
        leaves, clustered, seen = k2.launches_leaf, k2.launches_leaf_cluster, []
        Xk = leaf_spy(lambda: k2.spd_inverse(M), seen)
        per_call, cluster_call = k2.launches_leaf - leaves, k2.launches_leaf_cluster - clustered
        tree = tree_leaves(n, k2.leaf_size(B, dtype, dev))
        Xp = plain_leaves(lambda: k2.spd_inverse(M))
        Xl = k2.newton_schulz(M, dense_inv._chol_inverse(M))
        torch.cuda.synchronize()
        rk, rp, rl = (dense_inv._inverse_residual(M, X) for X in (Xk, Xp, Xl))
        worst = {key: float(v.max()) for key, v in (("kernel", rk), ("plain", rp), ("library", rl))}
        flags = {key: int((v > gate).sum()) for key, v in (("kernel", rk), ("plain", rp), ("library", rl))}
        rescued0 = dense_inv.guard_rescued
        dense_inv.guarded_inverse(M)
        rescued = dense_inv.guard_rescued - rescued0
        err, rel = rel_err(Xk, Xp)
        leaf_rel = max(r for _, r, _ in seen)
        label = f"{name} B={B} n={n} {dtype_name(dtype)}"
        reps = 3 if B > 100 else 10
        ms = cuda_ms(lambda: k2.spd_inverse(M), reps)
        plain_ms = cuda_ms(lambda: plain_leaves(lambda: k2.spd_inverse(M)), reps)
        chol_ms = cuda_ms(lambda: k2.newton_schulz(M, dense_inv._chol_inverse(M)), reps)
        guarded_ms = cuda_ms(lambda: dense_inv.guarded_inverse(M), reps)
        inv_ms = cuda_ms(lambda: torch.linalg.inv(M), reps)  # library_ms only
        # the old tree (leaves of at most max_n, one block an instance) where
        # the leaves now take the cluster form
        old_ms = cuda_ms(lambda: one_block_leaves(lambda: k2.spd_inverse(M, leaf_n=k2.max_n(dtype))),
                         reps) if cluster_call else None
        b_ms, b_by = bound(2 * M.element_size() * B * n * n, {dtype_name(dtype): B * n**3})
        print(f"K2 route {label}: {per_call} leaf launches a call, {cluster_call} of the cluster form "
              f"(clusters of {k2.leaf_plan(B, tree[0], dtype, sms)}), leaves {tree}; |I-MX|max kernel route "
              f"{worst['kernel']:.3e}, plain "
              f"route {worst['plain']:.3e}, library route {worst['library']:.3e} (refine gate {gate:g}; flagged "
              f"{flags['kernel']} / {flags['plain']} / {flags['library']} of {B}); the guard sent {rescued} of {B} "
              f"to Cholesky; |Xk-Xp|max relative {rel:.3e} (limit {ROUTE_REL_TOL[dtype_name(dtype)]:g}); leaves "
              f"(n, |Tk-Tp|max relative) {[(nl, float(f'{r:.3e}')) for nl, r, _ in seen]} (limit "
              f"{LEAF_REL_TOL[dtype_name(dtype)]:g})")
        print(f"  times: kernel route {ms:.4f} ms, with the residual guard {guarded_ms:.4f} ms, plain route "
              f"{plain_ms:.4f} ms, old library route (Cholesky, "
              f"cholesky_inverse, Newton-Schulz) {chol_ms:.4f} ms, torch.linalg.inv {inv_ms:.4f} ms"
              f"{'' if old_ms is None else f', old tree (leaves of max_n, one block each) {old_ms:.4f} ms'}; bound "
              f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / ms:.4f}")
        busy = None
        if B == 1:
            # at B=1 the host paces the route's ~30-55 small launches, and
            # its event times move by 2x between calls: the device time of
            # each route under the profiler is the steadier comparison
            busy, walls = {}, {}
            for key, fn in (("kernel route", lambda: k2.spd_inverse(M)),
                            ("old library route", lambda: k2.newton_schulz(M, dense_inv._chol_inverse(M))),
                            ("old tree", lambda: one_block_leaves(lambda: k2.spd_inverse(M, leaf_n=k2.max_n(dtype)))),
                            ("torch.linalg.inv", lambda: torch.linalg.inv(M))):
                fn()
                _, wall, events = profiled(lambda: [fn() for _ in range(5)])
                busy[key], walls[key] = event_ms(events) / 5, wall / 5
            print(f"  device time per call under the profiler (ms): {({k: round(v, 4) for k, v in busy.items()})}; "
                  f"host wall per call there {({k: round(v, 4) for k, v in walls.items()})}")
        require(per_call == len(tree) and bool(torch.isfinite(Xk).all()),
                f"K2 route {label}: {per_call} leaves where the tree has {len(tree)}, or not finite")
        require(cluster_call == (per_call if B <= sms // 2 else 0),
                f"K2 route {label}: {cluster_call} of {per_call} leaves on the cluster form at B = {B}")
        if name == "CVXQP2_M":  # four leaves of at most CLUSTER_LEAF_N (eight or seven of max_n on one block each)
            require(tree == [256, 240, 256, 248], f"K2 route {label}: leaves {tree}, not [256, 240, 256, 248]")
        require(worst["kernel"] <= max(gate, ROUTE_RESID_FACTOR * worst["plain"],
                                       ROUTE_RESID_FACTOR * worst["library"]),
                f"K2 route {label}: residual {worst['kernel']:.3e} against the gate and the other routes'")
        require(rel <= ROUTE_REL_TOL[dtype_name(dtype)], f"K2 route {label}: off the plain route by {rel:.3e}")
        require(len(seen) == per_call and leaf_rel <= LEAF_REL_TOL[dtype_name(dtype)],
                f"K2 route {label}: a leaf off its plain version by {leaf_rel:.3e}")
        routes[f"{label}"] = dict(ms=ms, guarded_ms=guarded_ms, plain_ms=plain_ms, cholesky_route_ms=chol_ms,
                                  inv_ms=inv_ms, old_tree_ms=old_ms, device_ms=busy, bound_ms=b_ms,
                                  resid=worst["kernel"], flagged=flags["kernel"], rescued=rescued, leaves=per_call,
                                  cluster_leaves=cluster_call, route_rel=rel, leaf_rel=leaf_rel)
        if name == "portfolio leg":
            leaf_M = seen[0][2]  # the route's first leaf, as it was given
        if name == "CVXQP2_M":
            cluster_leaves[dtype_name(dtype)] = seen[0][2]

    # the leaf kernel at the portfolio's first leaf
    B, nl = leaf_M.shape[0], leaf_M.shape[-1]
    Tk, Tp = k2.chol_inverse_leaf(leaf_M), k2.chol_inverse_leaf_plain(leaf_M)
    again = k2.chol_inverse_leaf(leaf_M)
    torch.cuda.synchronize()
    err, rel = rel_err(Tk, Tp)
    require(torch.equal(Tk, again), "K2's leaf: two launches differ")
    require(rel <= LEAF_REL_TOL["float32"], f"K2's leaf off its plain version by {rel:.3e} relative")
    # S read and T written once; the factor and the triangular inverse take
    # about n^3/3 operations each
    stats = report_times(f"K2 chol_inverse_leaf portfolio's first leaf B={B} n={nl} float32",
                         lambda: k2.chol_inverse_leaf(leaf_M), lambda: k2.chol_inverse_leaf_plain(leaf_M), 10,
                         2 * 4 * B * nl * nl, {"float32": 2 * B * nl**3 // 3})
    print(f"  |Tk-Tp|max {err:.3e}, relative {rel:.3e}; two launches bit-identical")

    # the cluster form at CVXQP2_M's first leaf (B=1, n=256), both dtypes
    cluster = {}
    for dt in ("float64", "float32"):
        S = cluster_leaves[dt]
        B, nl = S.shape[0], S.shape[-1]
        before = k2.launches_leaf_cluster
        Tk, Tp, again = k2.chol_inverse_leaf(S), k2.chol_inverse_leaf_plain(S), k2.chol_inverse_leaf(S)
        torch.cuda.synchronize()
        e, r = rel_err(Tk, Tp)
        require(k2.launches_leaf_cluster - before == 2, f"K2's leaf at CVXQP2_M {dt} did not take the cluster form")
        require(torch.equal(Tk, again), f"K2's cluster leaf: two launches differ ({dt})")
        require(r <= LEAF_REL_TOL[dt], f"K2's cluster leaf off its plain version by {r:.3e} relative ({dt})")
        elt = S.element_size()
        k = k2.leaf_plan(B, nl, S.dtype, sms)
        st = report_times(f"K2 chol_inverse_leaf cluster form, CVXQP2_M's first leaf B={B} n={nl} {dt}, "
                          f"clusters of {k}", lambda: k2.chol_inverse_leaf(S), lambda: k2.chol_inverse_leaf_plain(S),
                          20, 2 * elt * B * nl * nl, {dt: 2 * B * nl**3 // 3})
        sizes = {c: cuda_ms(lambda: k2.chol_inverse_leaf(S, cluster=c), 20)
                 for c in k2.LEAF_CLUSTERS if k2.cluster_fits(nl, c, S.dtype)}
        print(f"  |Tk-Tp|max {e:.3e}, relative {r:.3e} (limit {LEAF_REL_TOL[dt]:g}); two launches bit-identical; by "
              f"CTAs a cluster (ms) {({c: round(v, 4) for c, v in sizes.items()})}")
        cluster[dt] = dict(st, max_abs_err=e, rel_err=r, by_cluster=sizes, cluster=k)
    cluster_stats = dict(cluster["float64"], library_ms=None, float32=cluster["float32"])
    return dict(stats, max_abs_err=err, library_ms=None, routes=routes), cluster_stats


def phase_parametric_portfolio(dev):
    """bench.py's portfolio leg (bench_portfolio, BASELINE config 3) through
    BatchedSolver: B=256 instances of build_portfolio (500 assets, 50
    factors: 550 variables, 551 constraints) from default_rng(0), float32,
    eps 1e-3, polish off; a cold solve, one untimed resolve(q = 1.01 q),
    as bench.py runs, then K=8 resolve(q = q (1 + 0.01 (j + 1))) with the
    q vectors on the card first.  Counts set to 0 just before the set-up
    and read after the last re-solve.  Re-solves per second over the
    timed loop (CUDA events), iterations per re-solve, the solved fraction
    after each (>= 0.99, no MAX_ITER_REACHED), host reads per resolve; the
    first 4 instances held against BatchedSolver on the CPU over the same
    sequence; the set-up alone timed by CUDA events (K4, the Schur
    matrices, K2's route and the residual guard), the guard's rescues (0
    required); device time by kernel for the set-up and cold solve, with
    no kernel of the library's inverse (its Cholesky factor runs only in
    the convexity check, printed), and for one more re-solve under the
    profiler."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.linsys import dense_inv

    B, K = PORTFOLIO["B"], PORTFOLIO["K"]
    arrays = portfolio_batch(B, PORTFOLIO["n"], PORTFOLIO["k"])
    nv, mc = arrays[0].shape[-1], arrays[2].shape[1]
    kw = dict(dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False)
    P, q, A, l, u = on_device(arrays, torch.float32, dev)
    q_news = [q * (1.0 + 0.01 * (j + 1)) for j in range(K)]
    torch.cuda.synchronize()
    rescued0 = dense_inv.guard_rescued
    reset_counts()
    t0 = time.perf_counter()
    bs = ot.BatchedSolver(P, q, A, l, u, **kw)
    r0 = bs.solve()
    cold_status = r0.status_val.cpu().numpy()
    cold_s = time.perf_counter() - t0
    warm = bs.resolve(q=q_news[0])  # untimed, as bench.py's first resolve
    warm_status = warm.status_val.cpu().numpy()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    results, reads = [], []
    for j in range(K):
        results.append(bs.resolve(q=q_news[j]))
        reads.append(bs.last_resolve["host_reads"])
        require(not bs.last_resolve["refactored"], "portfolio: a q update refactored")
    stop.record()
    torch.cuda.synchronize()
    launches = read_counts()
    loop_ms = start.elapsed_time(stop)
    iters = [r.iter.cpu().numpy() for r in results]
    statuses = [r.status_val.cpu().numpy() for r in results]
    solved = [float(np.mean(st == ot.OSQP_SOLVED)) for st in statuses]
    rate = B * K / (loop_ms / 1e3)
    print(f"parametric_portfolio B={B} n={nv} m={mc} float32: set-up and cold solve {cold_s:.3f} s, cold solved "
          f"{float(np.mean(cold_status == ot.OSQP_SOLVED)):.4f}, iterations max {int(r0.iter.max())}; {K} re-solves in "
          f"{loop_ms:.3f} ms (CUDA events): {rate:.1f} re-solves/s, {loop_ms / K:.3f} ms a re-solve")
    print(f"  per re-solve: iterations mean {[round(float(i.mean()), 2) for i in iters]}, max "
          f"{[int(i.max()) for i in iters]}; solved {[round(x, 4) for x in solved]}; host reads {reads}")
    rescued = dense_inv.guard_rescued - rescued0
    print(f"  launches (set-up, cold solve and {K + 1} re-solves): {launches}; the residual guard sent "
          f"{rescued} instances to Cholesky")
    require(rescued == 0, f"portfolio: the residual guard sent {rescued} instances to the library's Cholesky")
    for j, st in enumerate(statuses):
        require(solved[j] >= 0.99, f"portfolio re-solve {j}: solved {solved[j]}")
        require(not np.any(st == ot.OSQP_MAX_ITER_REACHED), f"portfolio re-solve {j}: MAX_ITER_REACHED")
    require(np.isfinite(results[-1].x.cpu().numpy()).all() and results[-1].x.shape == (B, nv), "portfolio: x")
    require(launches["chol_inverse_leaf"] > 0 and launches["chol_inverse"] == 0, "portfolio: K2's route not taken")
    require(launches["chol_inverse_leaf_cluster"] == 0, "portfolio: a K2 leaf took the cluster form at B = 256")

    # the first 4 instances on the CPU, over the same sequence
    cpu = ot.BatchedSolver(*(a[:4] for a in arrays), device="cpu", **kw)
    pairs = [(cold_status[:4], r0.iter.cpu().numpy()[:4], cpu.solve()),
             (warm_status[:4], warm.iter.cpu().numpy()[:4], cpu.resolve(q=arrays[1][:4] * 1.01))]
    for j in range(K):
        pairs.append((statuses[j][:4], iters[j][:4], cpu.resolve(q=arrays[1][:4] * (1.0 + 0.01 * (j + 1)))))
    worst = 0
    for st, it, rc in pairs:
        require(np.array_equal(st, rc.status_val.numpy()), "portfolio: statuses of the first 4 differ from the CPU's")
        worst = max(worst, int(np.abs(it - rc.iter.numpy()).max()))
    print(f"  the first 4 instances against BatchedSolver on the CPU, cold solve and {K + 1} re-solves: statuses "
          f"equal True, iterations differ by at most {worst}")
    require(worst <= 25, f"portfolio: iterations of the first 4 differ from the CPU's by {worst}")

    setup_ms = cuda_ms(lambda: ot.BatchedSolver(P, q, A, l, u, **kw), 3, warmup=1)
    print(f"  set-up alone (K4, Schur matrices, K2's route with the residual guard, A M^-1): {setup_ms:.3f} ms "
          f"(CUDA events, mean of 3)")
    _, wall, events = profiled(lambda: ot.BatchedSolver(P, q, A, l, u, **kw).solve())
    busy = event_ms(events)
    rescue = [e for e in events if any(k in e.name.lower() for k in RESCUE_KERNELS)]
    check = [e for e in events if any(k in e.name.lower() for k in LIBRARY_FACTOR)]
    print(f"  set-up and cold solve under the profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; the guard's library inverse: {len(rescue)} kernels; the convexity check's library "
          f"Cholesky of P + sigma I: {len(check)} kernels, {event_ms(check):.3f} ms; by kernel: {top_kernels(events, 8)}")
    require(not rescue, f"portfolio: the set-up ran the guard's library inverse ({top_kernels(rescue, 3)})")
    _, wall, events = profiled(lambda: bs.resolve(q=q_news[0]))
    busy = event_ms(events)
    print(f"  one re-solve under the profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; by kernel: {top_kernels(events, 8)}")
    return launches


def phase_parametric_mpc(dev):
    """The MPC cell (mpc_scenarios: B=1000, n=372, m=612, float32, eps
    1e-3, polish off) as a receding horizon through BatchedSolver, for
    block_tridiag (K7's warp path) and dense_inv (K2's route at n=372, K1r
    resident): a cold solve, then 10 steps, each setting x0 to the previous
    step's x_1 on the card (MPCProblem.update_xinit's bounds, batched) and
    calling resolve(l=, u=).  Per step: ms (CUDA events), QPs/s,
    iterations, the solved fraction and whether a refactor ran (none
    should: the classes do not change); each step held to a fresh
    solve_batch on the same bounds (equal statuses).  Counts set to 0 just
    before each leg's set-up and read after its last step."""
    import torch

    import osqp_tpu_torch as ot

    base, *arrays = mpc_scenarios()
    B, b, nx = MPC["B"], base.block_size, base.nx
    P, q, A, l, u = on_device(arrays, torch.float32, dev)
    torch.cuda.synchronize()
    legs = {"block_tridiag": dict(block_size=b), "dense_inv": {}}
    out = {}
    for backend, extra in legs.items():
        kw = dict(MPC_KW, dtype="float32", linsys_solver=backend, **extra)
        reset_counts()
        bs = ot.BatchedSolver(P, q, A, l, u, **kw)
        res = bs.solve()
        lk, uk = l.clone(), u.clone()
        rows = []
        for step in range(10):
            x1 = res.x[:, b:b + nx]
            lk, uk = lk.clone(), uk.clone()
            lk[:, :nx] = x1
            uk[:, :nx] = x1
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = bs.resolve(l=lk, u=uk)
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
            status, iters = res.status_val.cpu().numpy(), res.iter.cpu().numpy()
            fresh = ot.solve_batch(P, q, A, lk, uk, **kw).status_val.cpu().numpy()
            solved = float(np.mean(status == ot.OSQP_SOLVED))
            rows.append((step, round(ms, 3), round(B / (ms / 1e3), 1), round(float(iters.mean()), 2),
                         int(iters.max()), solved, bs.last_resolve["refactored"]))
            require(np.array_equal(status, fresh), f"parametric_mpc {backend} step {step}: statuses differ from a "
                                                   "fresh solve_batch")
            require(solved >= 0.99 and not np.any(status == ot.OSQP_MAX_ITER_REACHED),
                    f"parametric_mpc {backend} step {step}: solved {solved}")
            require(not bs.last_resolve["refactored"], f"parametric_mpc {backend} step {step}: a refactor ran")
            require(np.isfinite(res.x.cpu().numpy()).all(), f"parametric_mpc {backend} step {step}: x")
        launches = read_counts()
        print(f"parametric_mpc {backend} B={B} n={base.P.shape[0]} m={base.A.shape[0]} float32, 10 receding-horizon "
              f"steps (step, ms, QPs/s, iterations mean, max, solved, refactored): {rows}")
        print(f"  statuses equal to a fresh solve_batch at every step True; launches {launches}")
        if backend == "block_tridiag":
            require(launches["bt_solve"] > 0 and launches["bt_solve_warp"] == launches["bt_solve"],
                    "parametric_mpc block_tridiag: K7's warp path did not run")
        else:
            require(launches["chol_inverse_leaf"] > 0 and launches["admm_iter_refined_resident"] > 0,
                    "parametric_mpc dense_inv: K2's route or K1r's resident path did not run")
            require(launches["chol_inverse_leaf_cluster"] == 0,
                    "parametric_mpc dense_inv: a K2 leaf took the cluster form at B = 1000")
        out[backend] = launches
    return out


def phase_sparse_polish(dev):
    """Polish on the sparse path: polish's PCG on K6 against the plain loop
    on LISWET1's polish system; solve_sparse(polish=True) at LISWET1
    (float64, float32), CVXQP2_L (float64) and 2 copies of LISWET1
    against sparse_polish.npz, with the polished (or rejected) point's
    residuals beside the ADMM point's, polish ms, PCG steps and K6
    launches per polish; the SparseSolver's set-up, solve, update_lin_cost
    and warm re-solve on LISWET1.  Counts are set to 0 just before the
    LISWET1 float64 solve and read just after it."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import _build, admm, batch
    from osqp_tpu_torch import polish as tpolish
    from osqp_tpu_torch.ops import cg as k6, ell as k5

    # Measurement hooks: what each polish returns and the PCG steps of each
    # of its solves, wrapping the functions batch.py and polish.py call.
    seen = []
    real_polish, real_solver = batch.polish_fn, tpolish._ell_kkt_solver

    def polish_spy(*args, **kw):
        torch.cuda.synchronize()
        before, t0 = (k6.launches, k6.launches_loop), time.perf_counter()
        res = real_polish(*args, **kw)
        torch.cuda.synchronize()
        seen.append(dict(res=res, ms=(time.perf_counter() - t0) * 1e3, k6=k6.launches - before[0],
                         loops=k6.launches_loop - before[1], steps=[]))
        return res

    def solver_spy(*args):
        solve, steps = real_solver(*args)
        seen.append(dict(steps=steps))
        return solve, steps

    # _pcg on K6 against the plain loop, on LISWET1's first polish system,
    # PCG_CHECK_STEPS steps in each dtype: the plain step summing in the
    # kernels' order costs ~4 ms a step on the card
    pcg_stats = None
    polish_bounds = {}  # a PCG step's bound on LISWET1's polish system, by dtype
    for dtype in ("float32", "float64"):
        cfg, dyn, scaled, scl, rs, fac, it = sparse_prepared("LISWET1", dtype, dev)
        c = admm.run_segment(cfg, scaled, scl, dyn, admm.init_carry(cfg, scaled, rs, fac, it), cfg.max_iter)
        x, z, y = c.it.x, c.it.z, c.it.y
        B, n = x.shape
        m = cfg.m
        lower, upper = z - scaled.l < -y, scaled.u - z < y
        mask = (lower | upper).to(x.dtype)
        MA = k5.ell_scale(scaled.A, mask, torch.ones((B, n), dtype=x.dtype, device=dev))
        rhs_z = mask * torch.where(lower, scaled.l, torch.where(upper, scaled.u, torch.zeros_like(scaled.l)))
        d = dyn.delta if dtype == "float64" else torch.clamp(dyn.delta, min=1e-4)
        t = (-scaled.q + k5.ell_tmatvec(MA, rhs_z.contiguous()) / d).contiguous()
        ones = torch.ones((B, m), dtype=x.dtype, device=dev)
        dinv = 1.0 / (k5.ell_diagonal(scaled.P) + d + k5.ell_sq_colsums(MA, ones) / d)
        tol = torch.full((B,), 1e-12 if dtype == "float64" else 1e-7, dtype=x.dtype, device=dev)
        max_iter = PCG_CHECK_STEPS
        op = k6.EllOperator(scaled.P, MA, div=d)
        plain = op.plain
        before = k6.launches_loop
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xk, sk = k6.pcg_solve(op, d, dinv, t, tol, max_iter)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        launched = k6.launches_loop - before
        # the stepwise path on the same operator (K5 launches and the step
        # kernels), in the same call
        before = k6.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, ss = k6.pcg_solve_stepwise(op, d, dinv, t, tol, max_iter)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        stepped = k6.launches - before
        # the plain step, summing in the kernels' order, over the same (K5)
        # products: K6 alone is compared
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xp, sp_ = k6.pcg_solve_plain(op, d, dinv, t, tol, max_iter, dot=k6.kernel_dot)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # and the CPU path's plain loop: K5's plain products, PyTorch's sums
        xq, sq = k6.pcg_solve_plain(plain, d, dinv, t, tol, max_iter)

        def residual(v):
            u, w = plain(v)
            return float(torch.linalg.vector_norm(u + d * v + w - t) / torch.linalg.vector_norm(t))

        diff, rel = rel_err(xk, xp)
        steps = int(sk.max())
        label = f"LISWET1 polish system n={n} m={m} (active rows {int(mask.sum())}) {dtype}, cap {max_iter}"
        print(f"polish PCG on K6 {label}: steps {steps} (plain step {int(sp_.max())}), equal "
              f"{torch.equal(sk, sp_)}, x bit-identical {torch.equal(xk, xp)}, {launched} loop launch; the stepwise "
              f"path x bit-identical {torch.equal(xs, xk)}, steps equal {torch.equal(ss, sk)}, {stepped} step "
              f"launches; the CPU path's plain loop {int(sq.max())} steps, x relative difference "
              f"{rel_err(xk, xq)[1]:.3e}; relative residual of S x = t {residual(xk):.3e} (CPU path's loop "
              f"{residual(xq):.3e}); one solve {solve_ms:.3f} ms on the loop, {solve_ms / max(steps, 1):.4f} ms per "
              f"CG step, against {step_ms:.3f} ms, {step_ms / max(steps, 1):.4f} ms per step on the stepwise path "
              f"({solve_ms / step_ms:.4f} of it)")
        require(torch.equal(sk, sp_) and torch.equal(xk, xp), f"polish PCG differs from its plain loop at {label}")
        require(torch.equal(xs, xk) and torch.equal(ss, sk), f"polish PCG: loop and stepwise path differ at {label}")
        require(launched == 1, f"polish PCG at {label} did not run on the device loop")
        nbytes, flops = loop_cost(op, B, n, steps)
        bound_ms, bound_by = bound(nbytes, flops)
        polish_bounds[dtype] = bound_ms / steps
        plan = k6.last_plan
        _, _, events = profiled(lambda: k6.pcg_solve(op, d, dinv, t, tol, max_iter))
        device_ms = event_ms(events, K6_LOOP)
        print(loop_step_line("loop in polish's PCG", plan, device_ms, steps, bound_ms / steps)
              + f" ({bound_by}); plain loop {plain_ms / steps:.4f} ms per step")
        require(plan.cluster > 1 and plan.vectors, f"K6's loop did not spread {label} over a cluster")
        if pcg_stats is None:
            pcg_stats = dict(ms=device_ms / steps, plain_ms=plain_ms / steps, bound_ms=bound_ms / steps,
                             bound_by=bound_by, library_ms=None, max_abs_err=diff, stepwise_ms=step_ms / steps,
                             wall_ms=solve_ms / steps, steps=steps, shape=label, plan=dataclasses.asdict(plan))

    gold = np.load(SPARSE_POLISH_GOLDENS)
    cases = {"LISWET1/float64": ("LISWET1", "float64", 1), "LISWET1/float32": ("LISWET1", "float32", 1),
             "CVXQP2_L/float64": ("CVXQP2_L", "float64", 1), "LISWET1_B2/float64": ("LISWET1", "float64", 2)}
    # x and y against the golden, relative to its largest entry: CVXQP2_L's
    # ADMM point is held to its eps (see phase_sparse), float32 to 1e-3
    xy_tol = {"CVXQP2_L/float64": 1e-3, "LISWET1/float32": 1e-3}
    launches = polish_k6 = None
    polish_paths = {}
    batch.polish_fn, tpolish._ell_kkt_solver = polish_spy, solver_spy
    try:
        for case, (name, dtype, B) in cases.items():
            P, q, A, l, u = scenario(name, B)
            g = lambda f: gold[f"{case}/{f}"]
            main_path = case == "LISWET1/float64"
            off = ot.solve_sparse(P, q, A, l, u, dtype=dtype, verbose=False)
            seen.clear()
            if main_path:
                reset_counts()
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ot.solve_sparse(P, q, A, l, u, dtype=dtype, polish=True, verbose=False)
            status, sp_status = res.status_val.cpu().numpy(), res.status_polish.cpu().numpy()
            wall = (time.perf_counter() - t0) * 1e3
            after = read_counts()
            if main_path:
                launches = after
            pol = next(e for e in seen if "res" in e)
            steps = [[int(k.max()) for k in e["steps"]] for e in seen if "res" not in e]
            if main_path:
                polish_k6 = pol["loops"]
            iters = res.iter.cpu().numpy()
            x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
            dx = float(np.abs(x - g("x")).max() / np.abs(g("x")).max())
            dy = float(np.abs(y - g("y")).max() / np.abs(g("y")).max())
            pr = pol["res"]
            print(f"sparse_polish {case} B={B}: status {status.tolist()} (golden {g('status_val').tolist()}), iterations "
                  f"{iters.tolist()} (golden {g('iter').tolist()}), status_polish {sp_status.tolist()} (golden "
                  f"{g('status_polish').tolist()}); polished candidate pri_res {pr.pri_res.cpu().tolist()}, dua_res "
                  f"{pr.dua_res.cpu().tolist()} against the ADMM point's pri_res "
                  f"{off.pri_res.cpu().tolist()}, dua_res {off.dua_res.cpu().tolist()}; x and y within {dx:.3e} and "
                  f"{dy:.3e} of the golden's largest entry; polish {pol['ms']:.3f} ms of a {wall:.3f} ms solve, PCG "
                  f"steps per solve {steps}, K6 loop launches in the polish {pol['loops']} (step launches "
                  f"{pol['k6']}), launches {dict((k, after[k] - before[k]) for k in ('ell_ops', 'cg_step', 'cg_loop'))}")
            if f"{name}/{dtype}/host_status_polish" in gold.files and B == 1:
                print(f"  the JAX package's B = 1 host polish gave status_polish "
                      f"{int(gold[f'{name}/{dtype}/host_status_polish'])}")
            require(np.array_equal(status, g("status_val")), f"sparse_polish {case}: status {status.tolist()}")
            require(np.array_equal(sp_status, g("status_polish")), f"sparse_polish {case}: status_polish")
            require(np.isfinite(x).all() and np.isfinite(y).all(), f"sparse_polish {case}: non-finite x or y")
            tol = xy_tol.get(case, 1e-5)
            if dtype == "float64" and case != "CVXQP2_L/float64":
                require(np.array_equal(iters, g("iter")), f"sparse_polish {case}: iterations {iters.tolist()}")
            else:
                require(np.abs(iters - g("iter")).max() <= 25, f"sparse_polish {case}: iterations {iters.tolist()}")
            require(dx <= tol and dy <= tol, f"sparse_polish {case} disagrees with the JAX package's run")
            require(pol["loops"] > 0 and pol["k6"] == 0 and all(s > 0 for s in steps[0]),
                    f"sparse_polish {case}: the PCG did not run on K6's device loop")
            if case in ("LISWET1/float64", "LISWET1/float32"):
                n_steps = sum(steps[0])
                # The same polish-on solve on the stepwise path, in the same
                # call, in float32 only: in float64 its ~1.5e5 step launches
                # took ~36 s, and the stepwise path's float64 bits are held
                # to the loop's on the polish system above (cap 300).
                stepwise = dtype == "float32"
                if stepwise:
                    seen.clear()
                    with stepwise_everywhere():
                        res_s = ot.solve_sparse(P, q, A, l, u, dtype=dtype, polish=True, verbose=False)
                        torch.cuda.synchronize()
                    pol_s = next(e for e in seen if "res" in e)
                    same = all(torch.equal(getattr(res_s, f), getattr(res, f))
                               for f in ("x", "y", "iter", "status_polish"))
                run = lambda: ot.solve_sparse(P, q, A, l, u, dtype=dtype, polish=True, verbose=False)
                with cg_step_spy() as seen_all:
                    _, pwall, events = profiled(run)
                idle = 1 - event_ms(events) / pwall
                loop_dev = event_ms(events, K6_LOOP)
                all_steps = sum(int(k.max()) for k in seen_all)
                print(loop_step_line(f"{case} K6's loop in the polish-on solve (the ADMM's CG solves and the "
                                     f"polish's PCG; a polish step's bound)", k6.last_plan, loop_dev, all_steps,
                                     polish_bounds[dtype]))
                idle_s = "not measured (its 1e4-1e6 kernel events are too many to trace)"
                polish_paths[case] = dict(loop_ms=pol["ms"], steps=n_steps, loop_ms_per_step=pol["ms"] / n_steps,
                                          idle_loop=idle, loop_device_ms_per_step=loop_dev / all_steps,
                                          bound_ms_per_step=polish_bounds[dtype],
                                          plan=dataclasses.asdict(k6.last_plan))
                if not stepwise:
                    print(f"  {case} polish: {pol['ms']:.3f} ms, {pol['ms'] / n_steps:.4f} ms per CG step, "
                          f"{pol['loops']} loops; idle share of the polish-on solve under the profiler {idle:.3f} "
                          f"(wall {pwall:.3f} ms)")
                    continue
                polish_paths[case].update(stepwise_ms=pol_s["ms"], stepwise_ms_per_step=pol_s["ms"] / n_steps)
                print(f"  {case} polish on the stepwise path in the same call: x, y, iterations and status_polish "
                      f"bit-identical {same}; polish {pol_s['ms']:.3f} ms against the loop's {pol['ms']:.3f} "
                      f"({pol['ms'] / pol_s['ms']:.4f} of it); ms per CG step {pol_s['ms'] / n_steps:.4f} against "
                      f"{pol['ms'] / n_steps:.4f}; launches in the polish: K6 {pol_s['k6']} steps against "
                      f"{pol['loops']} loops; idle share of the polish-on solve under the profiler: loop {idle:.3f} "
                      f"(wall {pwall:.3f} ms), stepwise {idle_s}")
                require(same, f"sparse_polish {case}: the stepwise path and the device loop differ")
    finally:
        batch.polish_fn, tpolish._ell_kkt_solver = real_polish, real_solver

    # The SparseSolver on LISWET1 (float64, polish off): set-up, solve,
    # update_lin_cost and a warm-started re-solve.
    P, q, A, l, u = scenario("LISWET1")
    sparse_gold = np.load(SPARSE_GOLDENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = ot.SparseSolver(P, q[0], A, l[0], u[0], device=dev, dtype="float64", verbose=False)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    r1 = s.solve()
    s.update_lin_cost(1.1 * q[0])
    r2 = s.solve()
    cold = ot.solve_sparse(P, 1.1 * q[0], A, l[0], u[0], device=dev, dtype="float64", verbose=False)
    dx = float(np.abs(r1.x - sparse_gold["LISWET1/float64/x"][0]).max())
    print(f"SparseSolver LISWET1 float64: set-up {setup_ms:.3f} ms; solve {r1.info.status}, {r1.info.iter} iterations "
          f"(golden {int(sparse_gold['LISWET1/float64/iter'][0])}), {r1.info.solve_time * 1e3:.3f} ms, |dx|max "
          f"{dx:.3e}; after update_lin_cost a warm re-solve {r2.info.status}, {r2.info.iter} iterations "
          f"({r2.info.solve_time * 1e3:.3f} ms) where a cold solve takes {int(cold.iter[0])}")
    require(r1.info.status_val == ot.OSQP_SOLVED and r1.info.iter == int(sparse_gold["LISWET1/float64/iter"][0])
            and dx <= 1e-5 * np.abs(sparse_gold["LISWET1/float64/x"]).max(), "SparseSolver LISWET1: first solve")
    require(r2.info.status_val == ot.OSQP_SOLVED and np.abs(r2.x - cold.x.cpu().numpy()[0]).max() <= 1e-2,
            "SparseSolver LISWET1: the warm re-solve")
    return launches, polish_k6, pcg_stats, polish_paths


# Kernels that the corpus run and the families suite must launch: K1/K1r
# (either body), K2 (any entry), K3, K4, K8 on the dense buckets, K5 and
# K6's device loop on the sparse rows.
CORPUS_KERNELS = (("K1/K1r", ("admm_iter", "admm_iter_refined")),
                  ("K2", ("chol_inverse", "chol_inverse_leaf", "chol_inverse_leaf_cluster")),
                  ("K3", ("term_products",)), ("K4", ("ruiz",)), ("K8 factor", ("kkt_lu_factor",)),
                  ("K8 solve", ("kkt_lu_solve",)), ("K5", ("ell_ops",)), ("K6 loop", ("cg_loop",)))
MM_INDEX = os.path.join(MAROS, "MM_INDEX.json")
MAROS_TPU_F64 = os.path.join(ROOT, "MAROS_r04_F64.json")
MAROS_TPU = os.path.join(ROOT, "MAROS_r05.json")
MAROS_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "maros_rows.npz")
FAMILY_GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens", "families.npz")
# The objective's relative error that counts as the published optimum
# (tools/run_maros_mm.py:38).
OBJ_RTOL = 5e-3
# Dense rows whose iterations or status_polish may differ from the JAX CPU
# golden: CVXQP2_M polishes on the card (K8's pivoted LU) where the JAX
# package's polish fails at the same ADMM point (ROADMAP queue 3).
GOLDEN_EXCEPTIONS = ("CVXQP2_M",)


def require_kernels(counts, kernels, what):
    """Fail unless each named kernel (one of its counts) launched."""
    for label, names in kernels:
        require(sum(counts[n] for n in names) > 0, f"{what}: {label} was launched no time")


def bucket_times(rows) -> str:
    """'(N, M) B=k: s' per bucket chunk of dense rows, in first-seen order."""
    seen = {}
    for r in rows:
        if r.get("bucket") is not None:
            seen.setdefault(tuple(r["bucket"]), r["time"])
    return ", ".join(f"({N}, {M}) B={B}: {t:.3f} s" for (N, M, B), t in seen.items())


def phase_maros(dev):
    """The Maros-Meszaros corpus through osqp_tpu_torch.maros.run_maros:
    the native parser against the Python one; the 36 rows in float64
    (eps 1e-3, polish on) with the pass criterion, each beside the JAX
    package's TPU float64 row; the dense rows in float32 with the float64
    fallback; single mode on the small rows.  Counts are set to 0 just
    before the float64 corpus run and read just after it."""
    import torch

    from osqp_tpu_torch import maros
    from osqp_tpu_torch.io import native
    from osqp_tpu_torch.io.qps import load_qps, parse_qps, parse_qps_fast
    from osqp_tpu_torch.verify import kkt_check

    require(native.load_native() is not None, "maros: the native QPS parser did not build")
    paths = maros.collect_paths([MAROS])
    require(len(paths) == 36, f"maros: {len(paths)} corpus files, not 36")
    texts = [(open(p).read(), os.path.splitext(os.path.basename(p))[0]) for p in paths]
    t0 = time.perf_counter()
    fast = [parse_qps_fast(t, h) for t, h in texts]
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [parse_qps(t, h) for t, h in texts]
    t_slow = time.perf_counter() - t0
    for a, b in zip(fast, slow):
        same = ((a.name, a.n, a.m, a.obj_constant) == (b.name, b.n, b.m, b.obj_constant)
                and (a.P != b.P).nnz == 0 and (a.A != b.A).nnz == 0
                and all(np.array_equal(v, w) for v, w in ((a.q, b.q), (a.l, b.l), (a.u, b.u))))
        require(same, f"maros: the native parser and the Python parser differ on {b.name}")
    print(f"maros native QPS parser: built in {native.build_seconds:.2f} s (0 when already built); the 36 "
          f"corpus files parse to equal problems; native {t_fast:.3f} s, Python {t_slow:.3f} s")

    index = json.load(open(MM_INDEX))["problems"]
    tpu = {r["name"]: r for r in json.load(open(MAROS_TPU_F64))["rows"]}
    gold = np.load(MAROS_GOLDENS)
    problems = {qp.name: qp for qp in fast}

    def check(rows, eps=1e-3):
        for r in rows:
            qp = problems[r["name"]]
            r["kkt"] = kkt_check(qp.P, qp.q, qp.A, qp.l, qp.u, r["x"], r["y"], eps_abs=eps, eps_rel=eps)
            pub = index[r["name"]]["published"]
            r["rel"] = abs(r["obj"] - pub) / max(1.0, abs(pub))
            r["pass"] = r["status_val"] in (1, 2) and r["kkt"]["ok"]

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, summary = maros.run_maros(paths, eps=1e-3, polish=True, dtype="float64", device=dev,
                                    keep_solutions=True, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(rows)
    for r in rows:
        route = f"dense {r['bucket'][:2]} B={r['bucket'][2]}" if r.get("bucket") else "sparse"
        k = r["kkt"]
        t = tpu[r["name"]]
        golden = ""
        if f"{r['name']}/iter" in gold.files:
            golden = (f"; JAX CPU float64 (maros_rows.npz): iterations {int(gold[r['name'] + '/iter'])}, "
                      f"status_polish {int(gold[r['name'] + '/status_polish'])}, host_polish "
                      f"{bool(gold[r['name'] + '/host_polish'])}")
        print(f"  {r['name']:<9} n={r['n']:<6} m={r['m']:<6} {route:<22} {r['status']}, {r['iter']} iterations, "
              f"status_polish {r['status_polish']}, fallback {bool(r.get('fallback'))}, host_polish "
              f"{bool(r.get('host_polish'))}; obj relative to published {r['rel']:.2e}"
              f"{' (match)' if r['rel'] < OBJ_RTOL else ''}; kkt_check {'ok' if k['ok'] else 'FAILED'} "
              f"(pri {k['pri_res']:.2e} / {k['pri_tol']:.2e}, dua {k['dua_res']:.2e} / {k['dua_tol']:.2e}); "
              f"{r['time']:.3f} s{' (its bucket)' if r.get('bucket') else ''} | TPU float64 "
              f"(MAROS_r04_F64.json): {t['status']}, {t['iter']} iterations, status_polish {t['status_polish']}"
              f"{golden}")
    npass = sum(r["pass"] for r in rows)
    nmatch = sum(r["rel"] < OBJ_RTOL for r in rows)
    ref = json.load(open(MAROS_TPU))
    dense = [r for r in rows if r.get("bucket")]
    same_gold = sum(int(gold[f"{r['name']}/iter"]) == r["iter"]
                    and int(gold[f"{r['name']}/status_polish"]) == r["status_polish"] for r in dense)
    print(f"maros float64 corpus on the card: {npass}/36 passed, {nmatch} published optima matched, polish "
          f"{summary['polish_success']} succeeded and {summary['polish_fail']} failed, "
          f"{sum(bool(r.get('fallback')) for r in rows)} fallbacks, {sum(bool(r.get('host_polish')) for r in rows)} "
          f"host rescues; {wall:.3f} s in all (dense buckets: {bucket_times(rows)}; sparse rows "
          f"{sum(r['time'] for r in rows if r.get('sparse')):.3f} s); the JAX package's TPU run (MAROS_r05.json): "
          f"{ref['passed']}/36, {ref['published_obj_matches']} matched, {ref['polish_success']} polished; dense "
          f"rows with the JAX CPU golden's iterations and status_polish: {same_gold}/{len(dense)} (required of all but "
          f"{', '.join(GOLDEN_EXCEPTIONS)})")
    print(f"  launches in the float64 corpus run: {counts}")
    require(npass == 36, f"maros: {36 - npass} corpus rows failed in float64: "
            f"{[r['name'] for r in rows if not r['pass']]}")
    rescued = [r["name"] for r in rows if r.get("host_polish")]
    require(not rescued, f"maros: the host polish rescued {rescued} in float64; every row must polish on the card")
    off_gold = [r["name"] for r in dense if r["name"] not in GOLDEN_EXCEPTIONS
                and (int(gold[f"{r['name']}/iter"]), int(gold[f"{r['name']}/status_polish"]))
                != (r["iter"], r["status_polish"])]
    require(not off_gold, f"maros: dense rows off the JAX CPU golden's iterations or status_polish: {off_gold}")
    require_kernels(counts, CORPUS_KERNELS, "maros float64 corpus run")

    # The dense rows in float32 with the float64 fallback.
    path_of = {qp.name: p for qp, p in zip(fast, paths)}
    dense_paths = [path_of[r["name"]] for r in rows if r.get("bucket")]
    t0 = time.perf_counter()
    rows32, s32 = maros.run_maros(dense_paths, eps=1e-3, polish=True, dtype="float32", fallback_dtype="float64",
                                  device=dev, keep_solutions=True, verbose=False)
    wall32 = time.perf_counter() - t0
    check(rows32)
    for r in rows32:
        print(f"  {r['name']:<9} float32: {r['status']}, {r['iter']} iterations, status_polish {r['status_polish']}, "
              f"fallback {bool(r.get('fallback'))}, host_polish {bool(r.get('host_polish'))}, kkt_check "
              f"{'ok' if r['kkt']['ok'] else 'FAILED'}, obj relative to published {r['rel']:.2e}")
    print(f"maros float32 dense rows with the float64 fallback: {s32['final']}/{len(rows32)} final, "
          f"{sum(r['pass'] for r in rows32)} pass; fell back: "
          f"{[r['name'] for r in rows32 if r.get('fallback')]}; host rescues: "
          f"{[r['name'] for r in rows32 if r.get('host_polish')]}; {wall32:.3f} s")
    require(s32["final"] == len(rows32), "maros: a dense row is not final in float32 with the float64 fallback")
    rescued = [r["name"] for r in rows32 if r.get("host_polish")]
    require(not rescued, f"maros: the host polish rescued {rescued} in float32; every row must polish on the card")

    # Single mode on the small rows, through the Solver.
    small = [p for p, qp in zip(paths, fast) if qp.n <= 16]
    by_name = {r["name"]: r for r in rows}
    t0 = time.perf_counter()
    rows1, s1 = maros.run_maros(small, eps=1e-3, polish=True, dtype="float64", single=True, device=dev,
                                keep_solutions=True, verbose=False)
    wall1 = time.perf_counter() - t0
    check(rows1)
    same = sum((r["status_val"], r["iter"], r["status_polish"]) == (by_name[r["name"]]["status_val"],
               by_name[r["name"]]["iter"], by_name[r["name"]]["status_polish"]) for r in rows1)
    print(f"maros single mode (Solver) on the {len(rows1)} rows with n <= 16: {sum(r['pass'] for r in rows1)} pass; "
          f"status, iterations and status_polish equal to the batched run's in {same}; {wall1:.3f} s")
    require(all(r["pass"] for r in rows1), "maros: a small row failed in single mode")
    return counts


def phase_families(dev):
    """benchmarks.run_suite on the default generate_suite() (dims 10-250,
    2 instances, the ten families: 100 instances) in float64, polish on,
    against the JAX package's run in families.npz: each instance's status
    and pass equal, iteration differences printed, the pass rate and the
    time per bucket.  Counts are set to 0 just before the run and read
    just after it."""
    import torch

    from osqp_tpu_torch import benchmarks

    gold = np.load(FAMILY_GOLDENS)
    seen = []
    real = benchmarks.solve_problems

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.extend(out)
        return out

    problems = benchmarks.generate_suite()
    benchmarks.solve_problems = spy
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, summary = benchmarks.run_suite(problems, dtype="float64", polish=True, device=dev, verbose=False)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        benchmarks.solve_problems = real
    diffs, mismatched = [], []
    for r in rows:
        want = (int(gold[f"{r['name']}/status_val"]), bool(gold[f"{r['name']}/pass"]))
        if (r["status_val"], r["pass"]) != want:
            mismatched.append(r["name"])
        d = r["iter"] - int(gold[f"{r['name']}/iter"])
        if d:
            diffs.append(f"{r['name']} {d:+d}")
    chunks = {}
    for res in seen:
        chunks.setdefault(res.bucket, res.seconds)
    times = ", ".join(f"({N}, {M}) B={B}: {t:.3f} s" for (N, M, B), t in chunks.items())
    print(f"families suite on the card (float64, polish on): {summary['passed']}/{summary['problems']} pass "
          f"(pass rate {summary['pass_rate']:.4f}); status and pass equal to the JAX golden in "
          f"{len(rows) - len(mismatched)}/{len(rows)}; iterations differ in {len(diffs)}: {diffs}; "
          f"{wall:.3f} s in all; by bucket chunk: {times}")
    print(f"  launches in the families run: {counts}")
    require(not mismatched, f"families: status or pass differ from the JAX golden at {mismatched}")
    require_kernels(counts, CORPUS_KERNELS[:6], "families run")
    return counts


# The differentiable layer, compaction and export (phases qp_layer, compact
# and export).  Every time they print carries CARD, the card's name and
# power limit as nvidia-smi gives them (set by main).
CARD = "card not read"
LAYER = dict(B=1024, n=100, m=200)
# Tight settings: the gradient assumes an accurate optimum.
LAYER_KW = dict(eps_abs=1e-8, eps_rel=1e-8)
# The card's gradients against the CPU layer's on the same instances, and
# dq against central differences, each relative to max(1, the largest
# entry of the CPU's or the analytic value).
LAYER_GRAD_TOL = 1e-6
LAYER_FD_TOL = 1e-5
LAYER_FD_STEP = 1e-4
LIBRARY_LU = ("getrf", "getrs", "magma", "cusolver")
COMPACT_MIN_BATCH = 256
COMPACT_X_RTOL = 1e-4


def event_times(fn, reps=5):
    """(fn's last result, the milliseconds of each of ``reps`` calls) by
    CUDA events around each call."""
    import torch

    times, out = [], None
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return out, times


def wall_times(fn, reps=5):
    """Milliseconds of each of ``reps`` calls of ``fn`` by the host's clock,
    each ending in a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def same_bits(a, b) -> bool:
    """Equal bit for bit (NaNs included)."""
    import torch

    if a.dtype.is_floating_point:
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return a.shape == b.shape and torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


def layer_run(layer, arrays, w, dtype, dev):
    """The layer's x and the gradients of sum(w x) for P, q, A, l and u
    (tensors of ``dtype`` on ``dev`` from ``arrays``)."""
    import torch

    ts = [torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_(True) for a in arrays]
    x = layer(*ts)
    grads = torch.autograd.grad((torch.as_tensor(w, dtype=dtype, device=dev) * x).sum(), ts)
    return x.detach(), grads


def phase_qp_layer(dev):
    """The differentiable QP layer (osqp_tpu_torch.make_qp_layer) at the
    headline's width: B=1024, n=100, m=200 in float64 with polish on and
    eps 1e-8 (LAYER_KW), and the headline batch (B=8192, float32, eps
    1e-3, polish on).  Forward and backward with a random weight on x;
    the forward pass equal to solve_batch bit for bit; a final status on
    >= 0.99 of the instances; the backward pass's launches (counts set to
    0 just before it): K8's blocks factor once, its solve 1 + 3 times,
    K3 3 times, and under the profiler no library LU; the card's dP, dq,
    dA, dl and du on 4 polished instances against the CPU layer's on the
    same instances (LAYER_GRAD_TOL), dq against central differences
    along a random direction on 2 polished instances (LAYER_FD_TOL);
    forward and backward ms, medians of 5 by CUDA events."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch.linsys import kkt_lu as kkt_backend

    names = ("P", "q", "A", "l", "u")
    blocks_calls = []
    real_blocks = kkt_backend.kkt_lu_factor_blocks

    def blocks_spy(*args, **kw):
        blocks_calls.append(args[0].shape[0])
        return real_blocks(*args, **kw)

    backward_counts = {}
    for label, (B, n, m), dtype, kw, seed in (
        ("float64", (LAYER["B"], LAYER["n"], LAYER["m"]), torch.float64, LAYER_KW, 3),
        ("float32", (HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]), torch.float32,
         dict(eps_abs=SOLVE_KW["eps_abs"], eps_rel=SOLVE_KW["eps_rel"]), 0),
    ):
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        arrays = make_qps(B, n, m, seed=seed, dtype=np_dtype)
        w = np.random.default_rng(4).standard_normal((B, n))
        layer = ot.make_qp_layer(**kw)
        res = ot.solve_batch(*on_device(arrays, dtype, dev), dtype=dtype, polish=True, verbose=False, **kw)
        ts = [torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_(True) for a in arrays]
        wt = torch.as_tensor(w, dtype=dtype, device=dev)
        x, fwd = event_times(lambda: layer(*ts))
        loss = (wt * x).sum()
        reset_counts()
        blocks_calls.clear()
        kkt_backend.kkt_lu_factor_blocks = blocks_spy
        try:
            grads = torch.autograd.grad(loss, ts, retain_graph=True)
            torch.cuda.synchronize()
        finally:
            kkt_backend.kkt_lu_factor_blocks = real_blocks
        counts = read_counts()
        _, bwd = event_times(lambda: torch.autograd.grad(loss, ts, retain_graph=True))
        _, _, events = profiled(lambda: torch.autograd.grad(loss, ts, retain_graph=True))
        library = sorted({kernel_label(e.name) for e in events if any(k in e.name.lower() for k in LIBRARY_LU)})

        sv = res.status_val.cpu().numpy()
        sp_ = res.status_polish.cpu().numpy()
        solved = float(np.mean(sv == ot.OSQP_SOLVED))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        print(f"qp_layer {label} B={B} n={n} m={m} {kw}, polish on [{CARD}]: forward ms {[round(t, 3) for t in fwd]}, "
              f"median {statistics.median(fwd):.3f}; backward ms {[round(t, 3) for t in bwd]}, median "
              f"{statistics.median(bwd):.3f}; solved {solved:.4f}, status_polish 1 in {int((sp_ == 1).sum())} of {B}, "
              f"iterations mean {res.iter.float().mean().item():.2f} max {int(res.iter.max())}")
        print(f"  backward launches {nonzero(counts)}; K8 blocks entry calls {blocks_calls}; library LU kernels under the "
              f"profiler {library}; backward device time by kernel: {top_kernels(events)}")
        require(same_bits(x.detach(), res.x), f"qp_layer {label}: the forward pass differs from solve_batch")
        require(solved >= 0.99, f"qp_layer {label}: solved fraction {solved} < 0.99")
        require(finite, f"qp_layer {label}: a gradient is not finite")
        require(blocks_calls == [B] and counts["kkt_lu_factor"] == 1 and counts["kkt_lu_solve"] == 4
                and counts["term_products"] == 3,
                f"qp_layer {label}: the backward pass launched {nonzero(counts)}, K8 blocks calls {blocks_calls}")
        require(not library, f"qp_layer {label}: a library LU ran in the backward pass: {library}")
        backward_counts[label] = counts
        if dtype != torch.float64:
            continue

        polished = np.nonzero(sp_ == 1)[0]
        require(len(polished) >= 4, "qp_layer: fewer than 4 polished instances")
        pick = polished[:4]
        cpu_x, cpu_grads = layer_run(layer, [a[pick] for a in arrays], w[pick], dtype, "cpu")
        errs = {}
        for name, g, c in zip(names, grads, cpu_grads):
            diff = float((g[pick].cpu() - c).abs().max())
            errs[name] = diff / max(1.0, float(c.abs().max()))
        x_err = float((x.detach()[pick].cpu() - cpu_x).abs().max())
        print(f"  card against the CPU layer on instances {pick.tolist()}: x {x_err:.3e}; gradients, largest "
              f"difference over max(1, largest CPU entry): " + ", ".join(f"d{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {LAYER_GRAD_TOL})")
        require(all(v <= LAYER_GRAD_TOL for v in errs.values()), f"qp_layer: card gradients off the CPU's: {errs}")

        # dq against central differences, on a B=2 batch of two polished instances
        two = polished[:2]
        d = np.random.default_rng(5).standard_normal((2, n))
        sub = [a[two] for a in arrays]

        def loss_at(qv):
            r = ot.solve_batch(sub[0], qv, *sub[2:], device=dev, dtype=dtype, polish=True, verbose=False, **kw)
            require((r.status_polish == 1).all(), "qp_layer: polish failed at a perturbed q")
            return (torch.as_tensor(w[two], dtype=dtype, device=dev) * r.x).sum(-1).cpu().numpy()

        fd = (loss_at(sub[1] + LAYER_FD_STEP * d) - loss_at(sub[1] - LAYER_FD_STEP * d)) / (2 * LAYER_FD_STEP)
        an = (grads[1][two].cpu().numpy() * d).sum(-1)
        rel = np.abs(fd - an) / np.maximum(1.0, np.abs(an))
        print(f"  dq along a random direction on instances {two.tolist()}: analytic {an.tolist()}, central "
              f"differences (step {LAYER_FD_STEP}) {fd.tolist()}, relative difference {rel.max():.3e} "
              f"(tolerance {LAYER_FD_TOL})")
        require(rel.max() <= LAYER_FD_TOL, "qp_layer: dq disagrees with central differences")
    return backward_counts


def phase_compact(dev):
    """Instance compaction at the headline (bench.py:31-42: B=8192, n=100,
    m=200, float32, eps 1e-3, polish off) with min_compact_batch=256,
    beside the plain solve: the sub-batch sizes taken (a spy on
    admm.run_segment reads the working batch of each segment), equal
    statuses, iterations equal where the bits of x and y agree, how many
    instances differ in any bit and by how much in x (COMPACT_X_RTOL,
    relative to the instance's largest |x|), and each variant's wall time,
    median of 5.  On the card a kernel's split over blocks may depend on
    B, so a sub-batch can round differently from the full batch."""
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import admm as admm_mod

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    data = on_device(make_qps(B, n, m), torch.float32, dev)
    kw = dict(SOLVE_KW, compact=True, min_compact_batch=COMPACT_MIN_BATCH)
    reset_counts()
    plain = ot.solve_batch(*data, **SOLVE_KW)
    torch.cuda.synchronize()
    plain_counts = read_counts()
    widths = []
    real_segment = admm_mod.run_segment

    def spy(cfg, d, scl, dyn, c, end):
        widths.append(c.active.shape[0])
        return real_segment(cfg, d, scl, dyn, c, end)

    admm_mod.run_segment = spy
    try:
        reset_counts()
        comp = ot.solve_batch(*data, **kw)
        torch.cuda.synchronize()
        comp_counts = read_counts()
    finally:
        admm_mod.run_segment = real_segment
    plain_ms = wall_times(lambda: ot.solve_batch(*data, **SOLVE_KW))
    comp_ms = wall_times(lambda: ot.solve_batch(*data, **kw))

    bits = lambda t: t.contiguous().view(torch.int32)
    same = ((bits(plain.x) == bits(comp.x)).all(-1) & (bits(plain.y) == bits(comp.y)).all(-1)).cpu().numpy()
    it_p, it_c = plain.iter.cpu().numpy(), comp.iter.cpu().numpy()
    scale = plain.x.abs().amax(-1).clamp_min(1e-30)
    x_rel = ((comp.x - plain.x).abs().amax(-1) / scale).cpu().numpy()
    statuses_equal = torch.equal(plain.status_val, comp.status_val)
    sizes = [w for i, w in enumerate(widths) if i == 0 or w != widths[i - 1]]
    print(f"compact headline B={B} n={n} m={m} f32, min_compact_batch {COMPACT_MIN_BATCH} [{CARD}]: sub-batch sizes "
          f"{sizes} over {len(widths)} segments; statuses equal {statuses_equal}; instances whose x and y differ "
          f"in some bit {int((~same).sum())} of {B}; iterations differ in {int((it_p != it_c).sum())} (in "
          f"{int((it_p[same] != it_c[same]).sum())} of the bit-equal ones); x relative difference max "
          f"{x_rel.max():.3e}, mean over the differing {x_rel[~same].mean() if (~same).any() else 0.0:.3e}")
    print(f"  wall ms, median of 5 (host clock, synchronized): plain {statistics.median(plain_ms):.3f} "
          f"{[round(t, 3) for t in plain_ms]}, compact {statistics.median(comp_ms):.3f} "
          f"{[round(t, 3) for t in comp_ms]}; compact over plain {statistics.median(comp_ms) / statistics.median(plain_ms):.3f}")
    print(f"  launches plain {nonzero(plain_counts)}")
    print(f"  launches compact {nonzero(comp_counts)}")
    # Which kernels' results follow B: K1 and K3 on every 32nd row of a
    # random headline state, at B=8192 and on those rows alone (B=256).
    from osqp_tpu_torch.ops import admm_iter as k1, term_products as k3

    ops = random_operands(B, n, m, torch.float32, dev)
    pick = torch.arange(0, B, B // COMPACT_MIN_BATCH, device=dev)
    sub = {k: v.index_select(0, pick).contiguous() if torch.is_tensor(v) and v.ndim else v for k, v in ops.items()}
    k3_args = lambda o: (o["P"], o["A"], o["x"], o["y"], o["dx"], o["dy"])
    rows_same = lambda full, part: all(same_bits(a.index_select(0, pick), b) for a, b in zip(full, part))
    k1_same = rows_same(k1.admm_iter(*k1_args(ops)), k1.admm_iter(*k1_args(sub)))
    k3_same = rows_same(k3.term_products(*k3_args(ops)), k3.term_products(*k3_args(sub)))
    print(f"  the same {len(pick)} rows of a random state at B={B} and alone: K1 bit-identical {k1_same}, "
          f"K3 bit-identical {k3_same}")
    require(statuses_equal, "compact: statuses differ from the plain solve")
    require(bool((it_p[same] == it_c[same]).all()), "compact: iterations differ where x and y agree bit for bit")
    require(float(x_rel.max()) <= COMPACT_X_RTOL, f"compact: x off the plain solve by {x_rel.max():.3e}")
    require(len(sizes) > 1 and min(sizes) >= COMPACT_MIN_BATCH, f"compact: sub-batch sizes {sizes}")
    return dict(sizes=sizes, plain_ms=statistics.median(plain_ms), compact_ms=statistics.median(comp_ms))


# The kernels a loaded program must launch (names under the profiler): K4
# on either path, K2's kernel or its cluster leaf, K1's epilogue, K3, and
# with polish on K8's panels on either path; on the sparse path K5's grouped
# products, its fused CG start and its scaling, and K6's device loop.
EXPORT_KERNELS = {
    "K4": ("ruiz_resident_kernel", "amax_kernel"),
    "K2": ("chol_inverse_kernel", "cluster_leaf_kernel"),
    "K1": ("epilogue_kernel",),
    "K3": ("products_kernel",),
    "K8": ("bpanel_kernel", "cluster_panel_kernel"),
    "K5 group": ("group_kernel",),
    "K5 start": ("cg_start_kernel",),
    "K5 scale": ("scale_kernel",),
    "K6 loop": ("cluster_loop_kernel",),
    "K4 split": ("amax_kernel",),
    "K7 warp factor": ("warp_factor_kernel",),
    "K7 warp solve": ("warp_solve_kernel",),
    "K8 solve": ("lu_solve_kernel", "strip_solve_kernel"),
    "K6 step": ("dot_kernel", "direction_kernel"),
    "K6 dense loop": ("dense_loop_kernel",),
}
SPARSE_EXPORT_KERNELS = ("K5 group", "K5 start", "K5 scale", "K6 loop")
# The batch of the export legs of kkt_lu, dense_chol and cg at the
# headline shape, and the timed calls of those legs and of block_tridiag's
# (one each, live and loaded, to keep the script's time).
EXPORT_DENSE_B = 1024
EXPORT_DENSE_REPS = 1
# Worker processes that export blobs at once (phase export).
EXPORT_WORKERS = 4


def export_job(name, args, kwargs):
    """One export in a worker process of phase export:
    ``osqp_tpu_torch.export.<name>(*args, **kwargs)`` on the card; returns
    (blob, its seconds by the host's clock, ``export.last_seconds``, host
    reads while tracing)."""
    from osqp_tpu_torch import export, linalg

    reads = linalg.host_reads
    t0 = time.perf_counter()
    blob = getattr(export, name)(*args, **kwargs)
    return blob, time.perf_counter() - t0, dict(export.last_seconds), linalg.host_reads - reads

# A process with torch alone: osqp_tpu_torch and osqp_tpu cannot be
# imported.  For each (blob, inputs, outputs, reps, wanted kernels)
# quintuple it loads the blob (the operators' library into the process,
# the program by torch.export.load), runs it once to warm, reps times by
# CUDA events and once under the profiler after a discarded warm-up call
# in the same profiler (schedule warmup=1, active=1), and saves the
# outputs; it prints one JSON line a blob: load ms, call ms, the
# operators in the program's graphs, the kernels the profiled call
# launched, its host reads (aten::is_nonzero: the loop's and the
# branches' predicates, each read by `if pred`; the operators read their
# settings from host tensors, which waits on nothing) and its six
# operators of most host time ([name, calls, self ms]).  The wanted
# kernels are a JSON list of groups of names: where a profiled window
# lacks every name of some group, the profiler dropped device records
# (once on the H100 it handed back every kernel of a CVXQP2_M call but the
# first, K4's amax_kernel), so the same call is profiled again, up to
# three windows in all, and the kernels are those of all windows; reads
# and host times stay the first window's.
ARTIFACT_CHILD = r"""
import io, json, os, sys, tempfile, time
sys.modules["osqp_tpu_torch"] = None
sys.modules["osqp_tpu"] = None
import torch
from torch.profiler import ProfilerActivity, profile, schedule

for blob_path, args_path, out_path, reps, wanted in zip(*[iter(sys.argv[1:])] * 5):
    t0 = time.perf_counter()
    spec = torch.load(blob_path, weights_only=True)
    assert spec["torch_version"] == str(torch.__version__), spec["torch_version"]
    if not hasattr(torch.ops.osqp_tpu_torch, "admm_iter"):
        fd, lib = tempfile.mkstemp(suffix=".so")
        with os.fdopen(fd, "wb") as f:
            f.write(spec["ops_library"])
        torch.ops.load_library(lib)
        os.unlink(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    solve = torch.export.load(io.BytesIO(spec["programs"]["cuda"])).module()
    load_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted({str(n.target).split(".")[1] for _, g in solve.named_modules() if hasattr(g, "graph")
                  for n in g.graph.nodes if n.op == "call_function" and str(n.target).startswith("osqp_tpu_torch.")})
    args = [t.cuda() for t in torch.load(args_path)]
    times = []
    with torch.no_grad():
        solve(*args)
        for _ in range(int(reps)):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            solve(*args)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        kernels, windows = set(), 0
        for windows in range(1, 4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):
                    out = solve(*args)
                    torch.cuda.synchronize()
                    prof.step()
            events = prof.events()
            kernels |= {e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
            if windows == 1:
                reads = sum(e.name == "aten::is_nonzero" for e in events)
                top = sorted((e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")),
                             key=lambda e: -e.self_cpu_time_total)[:6]
                cpu_top = [[e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)] for e in top]
            if all(any(n in k for k in kernels for n in group) for group in json.loads(wanted)):
                break
    kernels = sorted(kernels)
    torch.save(dict(zip(spec["fields"], (o.cpu() for o in out))), out_path)
    print(json.dumps({"load_ms": load_ms, "call_ms": times, "ops": ops, "kernels": kernels, "host_reads": reads,
                      "cpu_top": cpu_top, "profiled_windows": windows,
                      "packages": [k for k, v in sys.modules.items() if k.startswith("osqp") and v is not None]}))
"""


def run_artifact_child(cases, kernels, workdir):
    """Run ARTIFACT_CHILD over ``cases``, a list of (blob bytes, input
    tensors, timed calls), each wanting the kernels of its entry of
    ``kernels`` ((label, keys of EXPORT_KERNELS)); returns, for each,
    (outputs on the card, the child's JSON)."""
    import torch

    argv, saved = [], {}
    for i, ((blob, inputs, reps), (_, names)) in enumerate(zip(cases, kernels, strict=True)):
        paths = [os.path.join(workdir, f"{i}.{kind}") for kind in ("blob", "inputs", "outputs")]
        with open(paths[0], "wb") as f:
            f.write(blob)
        if id(inputs) not in saved:  # cases that share their inputs share the file
            torch.save([t.cpu() for t in inputs], paths[1])
            saved[id(inputs)] = paths[1]
        paths[1] = saved[id(inputs)]
        argv += [*paths, str(reps), json.dumps([EXPORT_KERNELS[k] for k in names])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, *argv], capture_output=True, text=True,
                          cwd=workdir, env=env, timeout=600)
    require(proc.returncode == 0, f"export: the torch-only process failed:\n{proc.stderr[-3000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    require(len(lines) == len(cases), f"export: the torch-only process printed {len(lines)} results")
    return [({k: v.to("cuda") for k, v in torch.load(argv[5 * i + 2]).items()}, lines[i]) for i in range(len(cases))]


def check_artifact(what, outputs, info, want, kernels):
    """Print a loaded program's run in the torch-only process and require
    ``want``'s bits (a dict of tensors), ``kernels`` (keys of
    EXPORT_KERNELS) among its kernels and neither package imported."""
    differ = [f for f in want if not same_bits(outputs[f], want[f].to(outputs[f].device))]
    found = {k: [n for n in EXPORT_KERNELS[k] if any(n in name for name in info["kernels"])] for k in kernels}
    print(f"export {what} [{CARD}], torch-only process: load {info['load_ms']:.3f} ms, call ms "
          f"{[round(t, 3) for t in info['call_ms']]} (median {statistics.median(info['call_ms']):.3f}), "
          f"host reads a call {info['host_reads']}; operators in the program {info['ops']}; kernels by K "
          f"{found} (profiled windows {info['profiled_windows']}); osqp packages imported {info['packages']}; fields differing from the live solve in some "
          f"bit: {differ}")
    require(not info["packages"], f"export {what}: the torch-only process imported {info['packages']}")
    require(not differ, f"export {what}: the loaded program differs from the live solve in {differ}")
    missing = [k for k, names in found.items() if not names]
    require(not missing, f"export {what}: {missing} launched no kernel in the torch-only process")


def phase_export(dev):
    """The fixed-shape artifact (osqp_tpu_torch.export), format 2, the
    traced program: the headline shape exported in float32 with polish off
    and on, and CVXQP2_M through Solver.export in float64 with polish on
    (K4 split, K2's cluster leaves, K1, K8's cluster path); the other
    dense backends: block_tridiag at the MPC cell (B=1000, n=372, m=612,
    b=12, float32, eps 1e-3: K7's warp factor and solve, K4 split, K3),
    and kkt_lu (K8's batched factor and solve, K4, K3), dense_chol (K4, K3,
    cuSOLVER's Cholesky) and cg (K6's dense loop, K4, K3; its blob's bytes
    and export seconds beside those of the blob in which each CG solve was 8-step chunks
    of K6's step operator) at the headline shape
    with B=1024 in float32, each against the live solve_batch(segmented=
    False), its export split into trace, save and the operators' library
    (export.last_seconds); the sparse
    program at LISWET1 in float64 with polish on through
    SparseSolver.export, and at the sparse phase's 8 copies of LISWET1 in
    float64 through export_sparse_solver(B=8) (K5's products, start and
    scaling, K6's loop).  Each is loaded and run by a process that has
    torch alone (osqp_tpu_torch and osqp_tpu blocked), which must give the
    live solve's bits (solve_batch's, the Solver's, solve_sparse's) and
    launch the card's kernels; the polish-on headline blob also loaded
    here by load_solver.  The blobs of export_solver and
    export_sparse_solver are exported by EXPORT_WORKERS worker processes
    at once (export_job), those of Solver.export and SparseSolver.export
    here meanwhile.  Blob bytes, export seconds (host clock, no host read
    while tracing), load and call ms, host reads a call and the profiled
    call's operators of most host time in the torch-only process beside
    the live solve's ms and host reads.  The
    LISWET1 blob is also loaded here and held to SparseSolver.solve within
    1e-6, then with P's values x2 through the artifact and through
    update_P within 1e-5; so is a format-1 LISWET1 blob (polish off, the
    live solve on its pattern and maps), which load_sparse_solver still
    reads.  The Solver runs with warm_start off and its rho
    reset to the setting before the re-solve, so that it starts where the
    artifact starts: a re-solve from the first solve's iterates or adapted
    rho stops at another point within eps 1e-3 of the optimum (1.9e-3 from
    the artifact's in x, on the CPU), which no tolerance of 1e-5 could
    hold."""
    import tempfile

    import scipy.sparse as sp
    import torch

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import export, linalg, program
    from osqp_tpu_torch.io.qps import load_qps

    import multiprocessing

    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    data = on_device(make_qps(B, n, m), torch.float32, dev)
    base, *mpc = mpc_scenarios()
    mpc = on_device(mpc, torch.float32, dev)
    dense = on_device(make_qps(EXPORT_DENSE_B, n, m), torch.float32, dev)
    P8, q8, A8, l8, u8 = scenario("LISWET1", 8)
    # (key, label, data, settings, kernels, timed calls) of the legs whose
    # blobs the worker processes export; the other dense backends at the
    # MPC cell and the headline shape each held to the live unsegmented
    # solve_batch, dense_inv's to the live segmented one.
    legs = [(f"headline_polish_{'on' if polish else 'off'}", f"headline polish {'on' if polish else 'off'}", data,
             dict(SOLVE_KW, polish=polish), ("K4", "K2", "K1", "K3") + (("K8",) if polish else ()), 3)
            for polish in (False, True)]
    legs.append(("block_tridiag", f"block_tridiag MPC cell B={MPC['B']} n={base.P.shape[0]} m={base.A.shape[0]} "
                                  f"b={base.block_size} f32", mpc,
                 dict(MPC_KW, dtype="float32", linsys_solver="block_tridiag", block_size=base.block_size),
                 ("K7 warp factor", "K7 warp solve", "K4 split", "K3"), EXPORT_DENSE_REPS))
    legs += [(backend, f"{backend} headline shape B={EXPORT_DENSE_B} n={n} m={m} f32", dense,
              dict(SOLVE_KW, linsys_solver=backend), want, EXPORT_DENSE_REPS)
             for backend, want in (("kkt_lu", ("K8", "K8 solve", "K4", "K3")), ("dense_chol", ("K4", "K3")),
                                   ("cg", ("K6 dense loop", "K4", "K3")))]
    cases, wants, sizes, kernels = [], [], {}, []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(EXPORT_WORKERS) as pool:
        # the longest first
        order = sorted(legs, key=lambda leg: leg[0] != "cg")
        jobs = {key: pool.apply_async(export_job, ("export_solver", (d[1].shape[0], d[1].shape[1], d[3].shape[1]), kw))
                for key, _, d, kw, _, _ in order}
        jobs["liswet1_b8"] = pool.apply_async(export_job, ("export_sparse_solver", (P8, A8),
                                                           dict(B=8, dtype="float64", verbose=False)))
        # Meanwhile the blobs that live objects write: CVXQP2_M through
        # Solver.export, LISWET1 with polish through SparseSolver.export.
        qp = load_qps(os.path.join(MAROS, "CVXQP2_M.qps"))
        s = ot.Solver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype="float64", verbose=False, polish=True)
        reads = linalg.host_reads
        t0 = time.perf_counter()
        sblob = s.export()
        sexport_s = time.perf_counter() - t0
        lqp = load_qps(os.path.join(MAROS, "LISWET1.qps"))
        ls = ot.SparseSolver(lqp.P, lqp.q, lqp.A, lqp.l, lqp.u, device=dev, dtype="float64", verbose=False,
                             warm_start=False, polish=True)
        t0 = time.perf_counter()
        lblob = ls.export()
        lexport_s = time.perf_counter() - t0
        require(linalg.host_reads == reads, "export: tracing Solver.export's or SparseSolver.export's program read "
                                            "the device")
        done = {key: job.get() for key, job in jobs.items()}
    print(f"export: {len(done)} blobs exported by {EXPORT_WORKERS} worker processes at once, 2 here meanwhile "
          f"(each export's seconds below are its own, by the host's clock, beside the others)")

    for key, label, d, kw, want, reps in legs:
        blob, export_s, split, traced_reads = done[key]
        require(traced_reads == 0, f"export: tracing the {label} program read the device")
        live_kw = kw if key.startswith("headline") else dict(kw, segmented=False)
        reads = linalg.host_reads
        live, live_ms = event_times(lambda: ot.solve_batch(*d, **live_kw), reps=reps)
        live_reads = (linalg.host_reads - reads) / reps
        print(f"export {label} [{CARD}]: format-2 blob {len(blob)} bytes, export {export_s:.3f} s (trace "
              f"{split['trace']:.3f}, save {split['save']:.3f}, operators' library {split['library']:.3f}); live "
              f"solve_batch{'' if key.startswith('headline') else '(segmented=False)'} ms "
              f"{[round(t, 3) for t in live_ms]} (median {statistics.median(live_ms):.3f}), host reads a solve "
              f"{live_reads:g}; solved {float((live.status_val == ot.OSQP_SOLVED).float().mean()):.4f}, iterations "
              f"max {int(live.iter.max())}")
        cases.append((blob, d, reps))
        wants.append(live._asdict())
        kernels.append((label, want))
        sizes[key] = dict(bytes=len(blob), export_s=export_s, **{f"{k}_s": v for k, v in split.items()},
                          live_ms=statistics.median(live_ms), live_reads=live_reads)

    blob = done["headline_polish_on"][0]
    t0 = time.perf_counter()
    fn = export.load_solver(blob)
    load_ms = (time.perf_counter() - t0) * 1e3
    out, call_ms = event_times(lambda: fn(*data), reps=3)
    differ = [f for f in export._FIELDS if not same_bits(out[f], wants[1][f])]
    print(f"export headline polish on, loaded here by load_solver [{CARD}]: load {load_ms:.3f} ms, call ms "
          f"{[round(t, 3) for t in call_ms]}; fields differing from the live solve in some bit: {differ}; "
          f"status_polish 1 in {int((out['status_polish'] == 1).sum())} of {B}")
    require(not differ, f"export: the loaded solver differs from the live solve in {differ}")

    reads = linalg.host_reads
    r, s_ms = event_times(s.solve, reps=1)
    s_reads = linalg.host_reads - reads
    Pd = qp.P.toarray()
    Pd = np.triu(Pd) + np.triu(Pd, 1).T
    sdata = on_device([np.asarray(v, np.float64)[None]
                       for v in (Pd, qp.q, qp.A.toarray(), np.clip(qp.l, -1e30, 1e30), np.clip(qp.u, -1e30, 1e30))],
                      torch.float64, dev)
    swant = {"x": torch.as_tensor(r.x)[None], "y": torch.as_tensor(r.y)[None],
             "iter": torch.tensor([r.info.iter], dtype=torch.int32),
             "status_val": torch.tensor([r.info.status_val], dtype=torch.int32),
             "status_polish": torch.tensor([r.info.status_polish], dtype=torch.int32),
             "obj_val": torch.tensor([r.info.obj_val], dtype=torch.float64),
             "pri_res": torch.tensor([r.info.pri_res], dtype=torch.float64),
             "dua_res": torch.tensor([r.info.dua_res], dtype=torch.float64)}
    print(f"export CVXQP2_M float64 polish on through Solver.export [{CARD}]: format-2 blob {len(sblob)} bytes, "
          f"export {sexport_s:.3f} s (host clock); live Solver solve {s_ms[0]:.3f} ms, host reads {s_reads}: "
          f"{r.info.status}, {r.info.iter} iterations, status_polish {r.info.status_polish}")
    cases.append((sblob, sdata, 3))
    wants.append(swant)
    kernels.append(("CVXQP2_M float64 polish on", ("K4", "K2", "K1", "K3", "K8")))
    sizes["cvxqp2_m"] = len(sblob)

    # The sparse program: LISWET1 with polish through SparseSolver.export,
    # and 8 copies of LISWET1 (q scaled by 1 + 0.1 i) through
    # export_sparse_solver, each against solve_sparse on the same values.
    qp, s = lqp, ls
    Pv, Av = s._Pu.data.copy(), s._Ac.data.copy()
    sparse = {}
    for label, B in (("LISWET1 float64 polish on through SparseSolver.export", 1),
                     ("8 copies of LISWET1 float64 through export_sparse_solver(B=8)", 8)):
        P, q, A, l, u = scenario("LISWET1", B) if B == 1 else (P8, q8, A8, l8, u8)
        kw = dict(dtype="float64", verbose=False, polish=B == 1)
        if B == 1:
            blob, export_s = lblob, lexport_s
        else:
            blob, export_s, _, traced_reads = done["liswet1_b8"]
            require(traced_reads == 0, f"export: tracing the sparse program ({label}) read the device")
        reads = linalg.host_reads
        live, live_ms = event_times(lambda: ot.solve_sparse(P, q, A, l, u, device=dev, **kw), reps=3)
        live_reads = (linalg.host_reads - reads) / 3
        print(f"export sparse {label} [{CARD}]: format-2 blob {len(blob)} bytes, export {export_s:.3f} s (host "
              f"clock); live solve_sparse ms {[round(t, 3) for t in live_ms]} (median "
              f"{statistics.median(live_ms):.3f}), host reads a solve {live_reads:g}: status "
              f"{live.status_val.tolist()}, iterations {live.iter.tolist()}, status_polish "
              f"{live.status_polish.tolist()}")
        vals = (Pv, Av) if B == 1 else (sp.triu(sp.csc_matrix(P), format="csc").data, sp.csc_matrix(A).data)
        values = [torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float64, device=dev)
                  for v in (vals[0], q, vals[1], l, u)]
        cases.append((blob, values, 3))
        wants.append(live._asdict())
        kernels.append((label, SPARSE_EXPORT_KERNELS))
        sparse[label] = blob
        sizes["liswet1_polish" if B == 1 else "liswet1_b8"] = len(blob)

    with tempfile.TemporaryDirectory() as workdir:
        runs = run_artifact_child(cases, kernels, workdir)
    for (outputs, info), want, (what, names) in zip(runs, wants, kernels):
        check_artifact(what, outputs, info, want, names)
        leg = sizes.get(what.split()[0])
        if isinstance(leg, dict):
            leg.update(load_ms=info["load_ms"], call_ms=statistics.median(info["call_ms"]), reads=info["host_reads"])
            print(f"export {what.split()[0]} [{CARD}]: a loaded call {leg['call_ms']:.3f} ms (median of "
                  f"{len(info['call_ms'])}) against the live solve's {leg['live_ms']:.3f} "
                  f"({leg['call_ms'] / leg['live_ms']:.3f}x); host reads a call {leg['reads']} against "
                  f"{leg['live_reads']:g}; blob {leg['bytes']} bytes, export {leg['export_s']:.3f} s (trace "
                  f"{leg['trace_s']:.3f}, save {leg['save_s']:.3f}, library {leg['library_s']:.3f}), load "
                  f"{leg['load_ms']:.3f} ms; host time of the profiled call by operator {info['cpu_top']}")

    cg = sizes["cg"]
    print(f"export cg [{CARD}]: blob {cg['bytes']} bytes against the stepwise program's 24349421, export "
          f"{cg['export_s']:.3f} s beside the other exports against the stepwise program's 58.514 s alone and 80.925 "
          f"beside them; a loaded call {cg.get('call_ms', float('nan')):.3f} ms against the live {cg['live_ms']:.3f}, host "
          f"reads a call {cg.get('reads')} against {cg['live_reads']:g}")

    sblob = next(iter(sparse.values()))
    t0 = time.perf_counter()
    sfn = export.load_sparse_solver(sblob)
    load_ms = (time.perf_counter() - t0) * 1e3
    vecs = (qp.q[None], np.asarray(qp.l, np.float64)[None], np.asarray(qp.u, np.float64)[None])
    (o1, t1) = event_times(lambda: sfn(Pv, vecs[0], Av, *vecs[1:]), reps=1)
    r1, s1 = event_times(s.solve, reps=1)
    e1 = float(np.abs(o1["x"][0].cpu().numpy() - r1.x).max())
    (o2, t2) = event_times(lambda: sfn(2.0 * Pv, vecs[0], Av, *vecs[1:]), reps=1)
    s.update_P(Px=2.0 * Pv)
    s.update_rho(s.settings.rho)
    r2, s2 = event_times(s.solve, reps=1)
    e2 = float(np.abs(o2["x"][0].cpu().numpy() - r2.x).max())
    print(f"export LISWET1 float64 polish on, loaded here by load_sparse_solver [{CARD}]: load {load_ms:.3f} ms; "
          f"artifact status {int(o1['status_val'][0])}, iterations {int(o1['iter'][0])} against the Solver's "
          f"{r1.info.status} {r1.info.iter}: x max difference {e1:.3e} (tolerance 1e-6); artifact call {t1[0]:.3f} "
          f"ms, Solver solve {s1[0]:.3f} ms; with P x2: status {int(o2['status_val'][0])}, iterations "
          f"{int(o2['iter'][0])} against {r2.info.status} {r2.info.iter}, x max difference {e2:.3e} (tolerance "
          f"1e-5), artifact call {t2[0]:.3f} ms, Solver solve {s2[0]:.3f} ms")
    require(int(o1["status_val"][0]) == ot.OSQP_SOLVED and e1 <= 1e-6, "export: LISWET1 artifact off the Solver")
    require(e2 <= 1e-5, "export: LISWET1 artifact off the Solver after update_P")

    # A format-1 blob of LISWET1 (the settings, pattern and maps alone, as
    # export_sparse_solver wrote it before format 2), polish off:
    # load_sparse_solver still reads it and runs the live unsegmented solve
    # on the card, held to the same checks against a SparseSolver.
    s = ot.SparseSolver(qp.P, qp.q, qp.A, qp.l, qp.u, device=dev, dtype="float64", verbose=False, warm_start=False)
    st = export._settings("float64", {f.name: getattr(s.settings, f.name) for f in dataclasses.fields(s.settings)
                                      if f.name not in ("dtype", "verbose", "time_limit")} | {"verbose": False},
                         linsys_solver="cg")
    operands = program.sparse_operands(s._Pu, s._Ac)
    blob = export._dump(dict(kind="sparse", B=1, n=operands["P"]["shape"][0], m=operands["A"]["shape"][0],
                             dtype=st.dtype, platforms=["cuda"], settings=dataclasses.asdict(st),
                             operands=operands), 1)
    t0 = time.perf_counter()
    sfn = export.load_sparse_solver(blob)
    load_ms = (time.perf_counter() - t0) * 1e3
    (o1, t1) = event_times(lambda: sfn(Pv, vecs[0], Av, *vecs[1:]), reps=1)
    r1, s1 = event_times(s.solve, reps=1)
    e1 = float(np.abs(o1["x"][0].cpu().numpy() - r1.x).max())
    (o2, t2) = event_times(lambda: sfn(2.0 * Pv, vecs[0], Av, *vecs[1:]), reps=1)
    s.update_P(Px=2.0 * Pv)
    s.update_rho(s.settings.rho)
    r2, s2 = event_times(s.solve, reps=1)
    e2 = float(np.abs(o2["x"][0].cpu().numpy() - r2.x).max())
    print(f"export LISWET1 float64 polish off, format-1 blob {len(blob)} bytes, loaded here by load_sparse_solver "
          f"[{CARD}]: load {load_ms:.3f} ms; artifact status {int(o1['status_val'][0])}, iterations "
          f"{int(o1['iter'][0])} against the Solver's {r1.info.status} {r1.info.iter}: x max difference {e1:.3e} "
          f"(tolerance 1e-6); artifact call {t1[0]:.3f} ms, Solver solve {s1[0]:.3f} ms; with P x2: status "
          f"{int(o2['status_val'][0])}, iterations {int(o2['iter'][0])} against {r2.info.status} {r2.info.iter}, "
          f"x max difference {e2:.3e} (tolerance 1e-5), artifact call {t2[0]:.3f} ms, Solver solve {s2[0]:.3f} ms")
    require(int(o1["status_val"][0]) == ot.OSQP_SOLVED and e1 <= 1e-6, "export: format-1 LISWET1 off the Solver")
    require(e2 <= 1e-5, "export: format-1 LISWET1 artifact off the Solver after update_P")
    return dict(sizes, liswet1_format_1=len(blob))


# The parallel phase (osqp_tpu_torch.parallel) on a one-rank NCCL group.
PARALLEL_DENSE = dict(n=1000, m=8000, seed=21)
PARALLEL_DENSE_POLISHED = dict(n=1000, m=2000, seed=21)  # its polish succeeds at eps 1e-3
PARALLEL_SPARSE_POLISH = "AUG3D"  # a sparse row whose polish succeeds (0.07 s in the maros phase)
K4_BLOCKS = 4
# K3 on K4_BLOCKS row blocks, the partial A'y summed, against K3 whole:
# relative to the largest entry of each product
K3_BLOCKS_RTOL = {"float32": 1e-5, "float64": 1e-12}


# The dense sharded polish (the Schur branch) against the unsharded one
# (K8's LU of K_delta): the ROADMAP's parity bounds, absolute on x, y and
# the residuals, relative on the objective.
PARALLEL_POLISH_ATOL = 1e-6
PARALLEL_POLISH_OBJ_RTOL = 1e-9
# The fields of the dense sharded polish-on solve that stay bit for bit
# with the unsharded one: everything the ADMM loop decides.
PARALLEL_ADMM_FIELDS = ("status_val", "iter", "rho_updates", "rho_estimate", "prim_inf_cert", "dual_inf_cert")
# A time limit that every solve reaches at its first poll, after two
# segments (iteration 200), at tolerances that nothing meets before.
PARALLEL_TIME_LIMIT = dict(time_limit=1e-9, eps_abs=1e-9, eps_rel=1e-9)


class PolishProbe:
    """batch's polish timed (synchronized, host clock) with the launches
    made inside it (``read_counts``' keys, summed over the calls), and the
    first S that polish hands K2's route (``polish.spd_inverse``)."""

    def __init__(self):
        self.ms, self.launches, self.S = 0.0, {}, None

    def __enter__(self):
        import torch

        from osqp_tpu_torch import batch, polish

        self._real = batch.polish_fn, polish.spd_inverse

        def timed_polish(*args, **kw):
            torch.cuda.synchronize()
            before, t0 = read_counts(), time.perf_counter()
            out = self._real[0](*args, **kw)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            for k, v in read_counts().items():
                self.launches[k] = self.launches.get(k, 0) + v - before[k]
            return out

        def captured(M, *args, **kw):
            if self.S is None:
                self.S = M.clone()
            return self._real[1](M, *args, **kw)

        batch.polish_fn, polish.spd_inverse = timed_polish, captured
        return self

    def __exit__(self, *exc):
        from osqp_tpu_torch import batch, polish

        batch.polish_fn, polish.spd_inverse = self._real


@contextlib.contextmanager
def schur_polish():
    """solve_batch's polish on the Schur branch (``polish(schur=True)``),
    the branch the row-sharded dense entry takes."""
    from osqp_tpu_torch import batch, polish

    real = batch.polish_fn
    batch.polish_fn = functools.partial(polish.polish, schur=True)
    try:
        yield
    finally:
        batch.polish_fn = real


def dense_qp(n, m, seed):
    """tests/test_intra_sharding.py:_qp at (n, m): a random strictly
    convex QP with m two-sided constraints around a feasible point."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.2 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    return P, q, A, A @ x0 - 1.0, A @ x0 + 1.0


def phase_parallel(dev):
    """osqp_tpu_torch.parallel on a one-rank NCCL group (make_mesh starts
    it on an in-process store, NCCL on the loopback interface): each
    entry against its unsharded solve, every field bit for bit, with
    the launch counts (set to 0 just before the sharded solve, read just
    after) and the collectives by kind:
    solve_batch_sharded at the headline (B=8192, n=100, m=200, float32,
    eps 1e-3, polish off) against solve_batch; solve_single_sharded at a
    dense QP of n=1000, m=8000 (dense_qp, float64, polish on) against
    solve_batch with the cg backend on the step kernels
    (stepwise_everywhere: the sharded solve's path, its bits), and at
    n=1000, m=2000, whose polish succeeds (PARALLEL_DENSE_POLISHED), each
    also held to the unsharded solve on K6's dense loop by the parity
    bounds (status, iterations within one check interval, x and y within
    1e-6), each of which must launch K3, K4's
    step entries, K6's cg_step and, in polish, K2's leaf and no K8: the
    ADMM fields bit for bit, status_polish equal (1 at the second), the polished x, y and
    residuals within PARALLEL_POLISH_ATOL and the objective within
    PARALLEL_POLISH_OBJ_RTOL (the sharded polish solves the Schur
    complement, the unsharded one K8's LU), every field bit for bit with
    the unsharded solve whose polish takes the Schur branch, no all-gather
    above B m, peak memory and polish ms of both, and K2's route on the
    polish's S against the plain route, torch.linalg.inv and the bound;
    solve_single_sharded_sparse at CVXQP2_L (float64, polish off) against
    solve_sparse, and at AUG3D (float64, polish on), which runs K5 and
    cg_step, in the polish too (no K6 loop), with its PCG steps; both
    entries at PARALLEL_TIME_LIMIT (the dense QP and CVXQP2_L), every
    field bit for bit with the unsharded solve at the same limit.  In one
    process, K4's step entries on 4 row blocks of the headline A
    with their maxima merged as the collectives merge them
    (ops.ruiz.ruiz_blocks) against ruiz, all eight outputs bit for bit,
    in float32 and at CVXQP2_M's shape in float64, timed beside ruiz,
    ruiz_plain and the bound; K3 on the same blocks with the partial
    A'y summed against K3 whole (K3_BLOCKS_RTOL); allreduce_summary over
    run_maros(shard=(0, 1)) of the HS rows, equal to the run's own
    summary.  Wall ms of each entry against its unsharded solve (host
    clock, synchronized), beside the card's name and power limit."""
    import torch
    import torch.distributed as dist

    import osqp_tpu_torch as ot
    from osqp_tpu_torch import parallel
    from osqp_tpu_torch.maros import run_maros
    from osqp_tpu_torch.ops import ruiz as k4, spd_inverse as k2, term_products as k3
    from osqp_tpu_torch.parallel import rows

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = parallel.make_mesh(device=dev)
    try:
        require(str(dist.get_backend()) == "nccl" and dist.get_world_size() == 1, "parallel: not a one-rank NCCL group")
        fields = lambda r: list(r)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def compare(label, sharded, unsharded, counts_wanted=(), reps=1):
            """Both solves once, timed (counts around the sharded one), their
            bits, then ``reps`` more timed runs of each."""
            reset_counts()
            rows.reset_collectives()
            got, first_s = timed(sharded)
            counts, coll = read_counts(), dict(rows.collectives)
            want, first_u = timed(unsharded)
            differ = [f for f, a, b in zip(ot.BatchSolveResults._fields, fields(got), fields(want))
                      if not same_bits(a, b)]
            t_s, t_u = [first_s] + wall_times(sharded, reps=reps), [first_u] + wall_times(unsharded, reps=reps)
            print(f"parallel {label} [{CARD}]: fields differing from the unsharded solve in some bit {differ}; status "
                  f"{got.status_val[:4].tolist()}, iterations {got.iter[:4].tolist()}, status_polish "
                  f"{got.status_polish[:4].tolist()}; wall ms sharded {statistics.median(t_s):.3f} "
                  f"{[round(t, 3) for t in t_s]}, unsharded {statistics.median(t_u):.3f} {[round(t, 3) for t in t_u]} "
                  f"(sharded over unsharded {statistics.median(t_s) / statistics.median(t_u):.3f}); collectives "
                  f"{coll}; launches {nonzero(counts)}")
            require(not differ, f"parallel {label}: sharded and unsharded differ in {differ}")
            require(sum(coll.values()) > 0, f"parallel {label}: no collective ran")
            for k in counts_wanted:
                require(counts[k] > 0, f"parallel {label}: {k} was launched no time")
            return counts, dict(sharded_ms=statistics.median(t_s), unsharded_ms=statistics.median(t_u))

        def stepwise_solve(fn):
            with stepwise_everywhere():
                return fn()

        times = {}
        # the instance batch
        B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
        data = on_device(make_qps(B, n, m), torch.float32, dev)
        _, times["batch"] = compare(
            f"solve_batch_sharded headline B={B} n={n} m={m} float32, data on the card",
            lambda: parallel.solve_batch_sharded(*data, mesh=mesh, **SOLVE_KW),
            lambda: ot.solve_batch(*data, **SOLVE_KW), reps=4)
        del data

        # one dense QP, rows sharded, polished on the shards: the QP too
        # large for a card (its polish fails in both branches at eps 1e-3),
        # then one whose polish succeeds
        def dense_leg(d, polished):
            P, q, A, l, u = dense_qp(d["n"], d["m"], d["seed"])
            kw = dict(dtype="float64", polish=True, verbose=False)
            sharded = lambda: parallel.solve_single_sharded(P, q, A, l, u, mesh=mesh, **kw)
            unsharded = lambda: ot.solve_batch(P[None], q[None], A[None], l[None], u[None], device=dev,
                                               linsys_solver="cg", **kw)
            reset_counts()
            rows.reset_collectives()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)  # what the phase holds already
            with PolishProbe() as pol_s:
                got, ms_s = timed(sharded)
            peak_s = torch.cuda.max_memory_allocated(dev) - base
            counts, coll, largest = read_counts(), dict(rows.collectives), rows.largest_gather
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            # the unsharded reference on the step kernels, the sharded
            # solve's path (stepwise_everywhere): its bits
            with stepwise_everywhere():
                with PolishProbe() as pol_u:
                    want, ms_u = timed(unsharded)
                peak_u = torch.cuda.max_memory_allocated(dev) - base
                with schur_polish():
                    route = unsharded()
            # and on the dense loop: the parity bounds
            before = read_counts()["cg_dense_loop"]
            with schur_polish():
                loop, ms_l = timed(unsharded)
            loop_launches = read_counts()["cg_dense_loop"] - before
            interval = ot.Settings().check_termination
            loop_err = {f: float((getattr(got, f) - getattr(loop, f)).abs().max()) for f in ("x", "y")}
            loop_iters = int((got.iter - loop.iter).abs().max())
            exact = [f for f in PARALLEL_ADMM_FIELDS if not same_bits(getattr(got, f), getattr(want, f))]
            err = {f: float((getattr(got, f) - getattr(want, f)).abs().max())
                   for f in ("x", "y", "pri_res", "dua_res")}
            obj_rel = float(((got.obj_val - want.obj_val).abs() / want.obj_val.abs()).max())
            differ_route = [f for f, a, b in zip(ot.BatchSolveResults._fields, got, route) if not same_bits(a, b)]
            B_m = got.y.shape[0] * (d["m"] + (-d["m"]) % dist.get_world_size())
            label = f"solve_single_sharded n={d['n']} m={d['m']} float64 polish on"
            print(f"parallel {label} [{CARD}]: ADMM fields differing from the unsharded solve in some bit {exact}; "
                  f"status {got.status_val.tolist()}, iterations {got.iter.tolist()}, status_polish "
                  f"{got.status_polish.tolist()} (unsharded {want.status_polish.tolist()}); polished fields against "
                  f"the unsharded polish (K8's LU): max |diff| {', '.join(f'{k} {v:.3e}' for k, v in err.items())} "
                  f"(tolerance {PARALLEL_POLISH_ATOL:g}), obj_val relative {obj_rel:.3e} (tolerance "
                  f"{PARALLEL_POLISH_OBJ_RTOL:g}); fields differing in some bit from the unsharded solve with its "
                  f"polish on the Schur branch {differ_route}; wall ms sharded {ms_s:.3f}, unsharded {ms_u:.3f}; "
                  f"polish ms sharded {pol_s.ms:.3f}, unsharded {pol_u.ms:.3f}; peak memory above what the phase held "
                  f"sharded {peak_s} B, unsharded {peak_u} B (torch.cuda.max_memory_allocated); largest all-gather {largest} elements "
                  f"(B m = {B_m}); collectives {coll}; launches {nonzero(counts)}; in the sharded polish "
                  f"{nonzero(pol_s.launches)}, in the unsharded {nonzero(pol_u.launches)}; against the unsharded "
                  f"solve on the dense loop (Schur polish; {loop_launches} dense loop launches, {ms_l:.3f} ms): status "
                  f"{loop.status_val.tolist()}, iterations {loop.iter.tolist()} (within {loop_iters}, interval "
                  f"{interval}), max |diff| x {loop_err['x']:.3e}, y {loop_err['y']:.3e} (tolerance 1e-6)")
            require(not exact, f"parallel {label}: ADMM fields {exact} differ from the unsharded solve")
            require(same_bits(got.status_polish, want.status_polish), f"parallel {label}: status_polish differs")
            require(not polished or int(got.status_polish[0]) == 1, f"parallel {label}: the sharded polish failed")
            require(max(err.values()) <= PARALLEL_POLISH_ATOL and obj_rel <= PARALLEL_POLISH_OBJ_RTOL,
                    f"parallel {label}: polished fields off the unsharded polish: {err}, obj {obj_rel:.3e}")
            require(not differ_route, f"parallel {label}: off the Schur-route unsharded solve in {differ_route}")
            require(loop_launches > 0 and same_bits(got.status_val, loop.status_val) and loop_iters <= interval
                    and max(loop_err.values()) <= 1e-6, f"parallel {label}: off the dense loop's unsharded solve "
                    f"beyond the parity bounds: iterations {loop_iters}, {loop_err}")
            for k in ("term_products", "ruiz_sweep", "cg_step", "chol_inverse_leaf"):
                require(counts[k] > 0, f"parallel {label}: {k} was launched no time")
            require(counts["ruiz"] == 0, f"parallel {label}: the sharded dense solve ran K4 whole")
            require(counts["kkt_lu_factor"] == 0, f"parallel {label}: the sharded dense polish ran K8")
            require(0 < largest <= B_m, f"parallel {label}: an all-gather of {largest} elements, above B m = {B_m}")
            return counts, pol_s, pol_u, peak_s, peak_u, dict(sharded_ms=ms_s, unsharded_ms=ms_u), (P, q, A, l, u)

        d = PARALLEL_DENSE
        dense_counts, pol_s, pol_u, peak_s, peak_u, times["dense"], (P, q, A, l, u) = dense_leg(d, False)
        _, pol_ok, pol_ok_u, *_ = dense_leg(PARALLEL_DENSE_POLISHED, True)

        # K2's route on the sharded polish's first S (B=1, n=1000, float64)
        S = pol_s.S
        n_s = S.shape[-1]
        eye = torch.eye(n_s, dtype=S.dtype, device=dev)
        X, Xp = k2.spd_inverse(S), plain_leaves(lambda: k2.spd_inverse(S))
        s_err = float((X - Xp).abs().max() / Xp.abs().max())
        resid = [float((eye - torch.bmm(S, Y)).abs().max()) for Y in (X, Xp)]
        s_ms = cuda_ms(lambda: k2.spd_inverse(S), reps=5)
        s_plain_ms = cuda_ms(lambda: plain_leaves(lambda: k2.spd_inverse(S)), reps=5)
        s_inv_ms = cuda_ms(lambda: torch.linalg.inv(S), reps=5)  # library_ms only
        s_bound, s_by = bound(2 * S.element_size() * S.shape[0] * n_s * n_s, {dtype_name(S.dtype): S.shape[0] * n_s ** 3})
        print(f"K2 route on the sharded polish's S B={S.shape[0]} n={n_s} float64 [{CARD}]: kernel route {s_ms:.4f} ms, "
              f"plain route {s_plain_ms:.4f}, torch.linalg.inv {s_inv_ms:.4f}; bound {s_bound:.4f} ms ({s_by}), share "
              f"{s_bound / s_ms:.4f}; kernel against plain route max relative {s_err:.3e}, |I-SX|max kernel "
              f"{resid[0]:.3e}, plain {resid[1]:.3e}; per sharded polish {pol_s.launches['chol_inverse_leaf']} leaf "
              f"launches ({pol_s.launches['chol_inverse_leaf_cluster']} in the cluster form), "
              f"{pol_s.launches['term_products']} K3, {pol_s.launches['cg_step']} cg_step")
        require(resid[0] <= 10 * max(resid[1], 1e-12), f"K2 route on S: |I-SX| {resid[0]:.3e} against the plain "
                f"route's {resid[1]:.3e}")
        polish_stats = dict(s_inverse=dict(ms=s_ms, plain_ms=s_plain_ms, library_ms=s_inv_ms, bound_ms=s_bound,
                                           bound_by=s_by, max_abs_err=s_err),
                            launches=dict(pol_s.launches), polish_ms=pol_s.ms, unsharded_polish_ms=pol_u.ms,
                            peak_bytes=peak_s, unsharded_peak_bytes=peak_u, polished_ms=pol_ok.ms,
                            polished_unsharded_ms=pol_ok_u.ms)

        # one sparse QP, rows sharded, without and with polish
        Ps, qs, As, ls, us = scenario("CVXQP2_L")
        cvxqp2_l = (Ps, qs[0], As, ls[0], us[0])
        kw = dict(dtype="float64", verbose=False)
        sparse_counts, times["sparse"] = compare(
            "solve_single_sharded_sparse CVXQP2_L float64",
            lambda: parallel.solve_single_sharded_sparse(Ps, qs[0], As, ls[0], us[0], mesh=mesh, **kw),
            lambda: ot.solve_sparse(Ps, qs[0], As, ls[0], us[0], device=dev, **kw),
            ("ell_group", "cg_step"), reps=0)
        require(sparse_counts["cg_loop"] == 0, "parallel: the sharded sparse solve ran K6's loop")
        Ps, qs, As, ls, us = scenario(PARALLEL_SPARSE_POLISH)
        kw = dict(dtype="float64", polish=True, verbose=False)
        probes = []

        def probed(fn):
            with PolishProbe() as probe:
                out = fn()
            probes.append(probe)
            return out

        rows.reset_collectives()
        polish_counts, times["sparse_polish"] = compare(
            f"solve_single_sharded_sparse {PARALLEL_SPARSE_POLISH} float64 polish on",
            lambda: probed(lambda: parallel.solve_single_sharded_sparse(Ps, qs[0], As, ls[0], us[0], mesh=mesh,
                                                                          **kw)),
            lambda: probed(lambda: ot.solve_sparse(Ps, qs[0], As, ls[0], us[0], device=dev, **kw)),
            ("ell_group", "cg_step"), reps=0)
        pol_sh, pol_un = probes[0], probes[1]
        pol_steps = pol_sh.launches["cg_step"]
        print(f"parallel {PARALLEL_SPARSE_POLISH} sharded polish [{CARD}]: {pol_steps} PCG steps on K6's step "
              f"kernels, {pol_sh.launches['cg_loop']} loop launches, {pol_sh.ms:.3f} ms; the unsharded polish "
              f"{pol_un.launches['cg_loop']} loop launches, {pol_un.ms:.3f} ms; largest all-gather "
              f"{rows.largest_gather} elements")
        require(polish_counts["cg_loop"] == 0, "parallel: the sharded sparse polish ran K6's loop")
        require(0 < rows.largest_gather <= As.shape[0], f"parallel {PARALLEL_SPARSE_POLISH}: an all-gather of "
                f"{rows.largest_gather} elements, above B m = {As.shape[0]}")
        polish_stats.update(sparse_pcg_steps=pol_steps, sparse_polish_ms=pol_sh.ms,
                            sparse_unsharded_polish_ms=pol_un.ms)

        # a time limit that stops both entries at their first poll
        for label, sharded, unsharded in (
                (f"dense n={d['n']} m={d['m']}", lambda: parallel.solve_single_sharded(
                    P, q, A, l, u, mesh=mesh, dtype="float64", verbose=False, **PARALLEL_TIME_LIMIT),
                 lambda: stepwise_solve(lambda: ot.solve_batch(P[None], q[None], A[None], l[None], u[None], device=dev,
                                                               linsys_solver="cg", dtype="float64", verbose=False,
                                                               **PARALLEL_TIME_LIMIT))),
                ("sparse CVXQP2_L", lambda: parallel.solve_single_sharded_sparse(
                    *cvxqp2_l, mesh=mesh, dtype="float64", verbose=False, **PARALLEL_TIME_LIMIT),
                 lambda: ot.solve_sparse(*cvxqp2_l, device=dev, dtype="float64", verbose=False,
                                         **PARALLEL_TIME_LIMIT))):
            reset_counts()
            got = sharded()
            want = unsharded()
            differ = [f for f, a, b in zip(ot.BatchSolveResults._fields, got, want) if not same_bits(a, b)]
            print(f"parallel time limit {label} float64 {PARALLEL_TIME_LIMIT} [{CARD}]: status "
                  f"{got.status_val.tolist()}, iterations {got.iter.tolist()}; fields differing from the unsharded "
                  f"solve at the same limit in some bit {differ}")
            require(not differ and int(got.status_val[0]) == ot.OSQP_TIME_LIMIT_REACHED and int(got.iter[0]) == 200,
                    f"parallel time limit {label}: {differ}, status {got.status_val.tolist()}, iter {got.iter.tolist()}")

        # K4's step entries on row blocks, in one process
        sweep_stats = None
        cvxqp = maros_dense("CVXQP2_M")
        for label, arrays, dtype in ((f"headline B={B} n={n} m={m} float32", make_qps(B, n, m), torch.float32),
                                     ("CVXQP2_M B=1 n=1000 m=1250 float64", cvxqp, torch.float64)):
            args = on_device(arrays, dtype, dev)
            Pt, qt, At, lt, ut = args
            blocks = [b.contiguous() for b in torch.tensor_split(At, K4_BLOCKS, dim=1)]
            whole = k4.ruiz(*args, 10)
            before = k4.launches_sweep
            got = k4.ruiz_blocks(Pt, qt, blocks, lt, ut, 10)
            torch.cuda.synchronize()
            launched = k4.launches_sweep - before
            got = got[:5] + (torch.cat(got[5], dim=1),) + got[6:]
            names = ("c", "D", "E", "P", "q", "A", "l", "u")
            differ = [nm for nm, a, b in zip(names, got, whole) if not same_bits(a, b)]
            plain = k4.ruiz_plain(*args, 10)
            err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, plain))
            ms = cuda_ms(lambda: k4.ruiz_blocks(Pt, qt, blocks, lt, ut, 10), reps=5)
            ruiz_ms = cuda_ms(lambda: k4.ruiz(*args, 10), reps=5)
            plain_ms = cuda_ms(lambda: k4.ruiz_plain(*args, 10), reps=5)
            Bq, nq, mq = At.shape[0], At.shape[2], At.shape[1]
            elt = At.element_size()
            bound_ms, bound_by = bound(elt * Bq * (2 * (nq * nq + mq * nq + nq + 2 * mq) + nq + mq + 1),
                                       {dtype_name(dtype): 32 * Bq * (nq * nq + mq * nq)})
            print(f"K4 step entries on {K4_BLOCKS} row blocks, {label}, maxima merged as the collectives merge them "
                  f"[{CARD}]: outputs differing from ruiz in some bit {differ}; {launched} launches; against "
                  f"ruiz_plain max |difference| {err:.3e}; {ms:.4f} ms against ruiz's {ruiz_ms:.4f} "
                  f"({'resident' if k4.cluster_size(nq, mq, dtype) else 'split'} path) and the plain version's "
                  f"{plain_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}")
            require(not differ, f"K4 step entries differ from ruiz at {label} in {differ}")
            if sweep_stats is None:
                sweep_stats = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=None, ruiz_ms=ruiz_ms)

        # K3 on the same blocks, A'y partials summed, against K3 whole
        g = torch.Generator(device=dev).manual_seed(7)
        for dtype in (torch.float32, torch.float64):
            Pt, qt, At, lt, ut = on_device(make_qps(B, n, m), dtype, dev)
            x, dx = (torch.randn(B, n, generator=g, dtype=dtype, device=dev) for _ in range(2))
            y, dy = (torch.randn(B, m, generator=g, dtype=dtype, device=dev) for _ in range(2))
            whole = k3.term_products(Pt, At, x, y, dx, dy)
            parts = [k3.term_products(Pt, blk.contiguous(), x, yb.contiguous(), dx, dyb.contiguous())
                     for blk, yb, dyb in zip(torch.tensor_split(At, K4_BLOCKS, dim=1),
                                             torch.tensor_split(y, K4_BLOCKS, dim=1),
                                             torch.tensor_split(dy, K4_BLOCKS, dim=1))]
            merged = (torch.cat([p.Ax for p in parts], 1), parts[0].Px, sum(p.Aty for p in parts),
                      sum(p.Atdy for p in parts), parts[0].Pdx, torch.cat([p.Adx for p in parts], 1))
            rel = {nm: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for nm, a, b in zip(("Ax", "Px", "Aty", "Atdy", "Pdx", "Adx"), merged, whole)}
            tol = K3_BLOCKS_RTOL[dtype_name(dtype)]
            print(f"K3 on {K4_BLOCKS} row blocks, headline B={B} {dtype_name(dtype)}, A'y partials summed, against K3 "
                  f"whole: relative differences {', '.join(f'{k} {v:.3e}' for k, v in rel.items())} (tolerance {tol})")
            require(all(v <= tol for v in rel.values()), f"parallel: K3 on row blocks off K3 whole: {rel}")

        # the multi-host helpers on the Maros harness's HS rows
        paths = [os.path.join(MAROS, f"{name}.qps") for name in
                 ("HS118", "HS21", "HS268", "HS35", "HS35MOD", "HS51", "HS52", "HS53", "HS76")]
        rank, world = parallel.host_shard()
        _, summary = run_maros(paths, dtype="float64", shard=(rank, world), verbose=False, device=dev)
        total = parallel.allreduce_summary(summary)
        print(f"parallel allreduce_summary over run_maros(shard=({rank}, {world})) of {len(paths)} HS rows: {total}")
        require(all(total[k] == summary[k] for k in ("problems", "solved", "final", "polish_success", "polish_fail"))
                and total["pass_rate"] == 1.0, "parallel: allreduce_summary off the run's own summary")
    finally:
        dist.destroy_process_group()
    return dense_counts, sweep_stats, times, polish_stats


# The torch.library operator of each row of the kernels line.
OPERATORS = {
    "admm_iter": "admm_iter", "admm_iter_refined": "admm_iter_refined",
    "admm_iter_refined_resident": "admm_iter_refined_resident", "chol_inverse": "chol_inverse", "ruiz": "ruiz",
    "ruiz_sweep": None, "term_products": "term_products", "kkt_lu_factor": "kkt_lu_factor_blocks",
    "kkt_lu_solve": "kkt_lu_solve", "ell_group": "ell_group", "ell_cg_start": "ell_cg_start",
    "ell_scale": "ell_scale", "cg_step": "cg_step", "cg_dense_loop": "cg_dense_loop",
    "cg_step_polish_pcg": "cg_loop", "k7_factor": "bt_factor",
    "k7_solve": "bt_solve", "cg_loop": "cg_loop", "block_tridiag_factor_device": "bt_factor",
    "block_tridiag_factor_cluster": "bt_factor", "block_tridiag_solve_wide": "bt_solve",
    "chol_inverse_leaf": "chol_inverse_leaf", "chol_inverse_leaf_cluster": "chol_inverse_leaf_cluster",
}


def run_phase(phase, dev):
    """``phase(dev)``, and a line with its wall time."""
    t0 = time.perf_counter()
    out = phase(dev)
    print(f"[{phase.__name__.removeprefix('phase_')}: {time.perf_counter() - t0:.1f} s]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import osqp_tpu_torch  # noqa: F401  (a checkout is required)
    from osqp_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    global CARD
    CARD = smi
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build(ops=True)
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib_path.name}, {_build.ops_path().name}")

    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--only":
            print("usage: chip_smoke.py [--only PHASE[,PHASE...]]", file=sys.stderr)
            return 2
        for name in sys.argv[2].split(","):
            run_phase(globals()[f"phase_{name}"], dev)
        print("chip_smoke: a partial run, no result line", file=sys.stderr)
        return 2

    k2_stats = run_phase(phase_k2, dev)
    k2_leaf_stats, k2_cluster_stats = run_phase(phase_k2_route, dev)
    k1_stats = run_phase(phase_k1, dev)
    k4_stats = run_phase(phase_k4, dev)
    k3_stats = run_phase(phase_k3, dev)
    k1r_stats, k1r_resident_stats = run_phase(phase_k1r, dev)
    run_phase(phase_parity, dev)
    launches = run_phase(phase_headline, dev)
    solver_launches = run_phase(phase_solver, dev)
    k8_factor_stats, k8_solve_stats = run_phase(phase_k8, dev)
    polish_launches = run_phase(phase_polish_batched, dev)
    run_phase(phase_polish_solver, dev)
    run_phase(phase_kkt_lu_backend, dev)
    k5_group_stats, k5_start_stats, k5_scale_stats = run_phase(phase_k5, dev)
    k6_stats, loop_stats, dense_stats = run_phase(phase_k6, dev)
    sparse_launches, sparse_paths = run_phase(phase_sparse, dev)
    cg_dense_launches = run_phase(phase_cg_dense, dev)
    k7_factor_stats, k7_solve_stats = run_phase(phase_k7, dev)
    k7_large_launches, k7_cluster_stats, k7_device_stats, k7_wide_stats = run_phase(phase_k7_device, dev)
    op_stats = run_phase(phase_dense_ops, dev)
    mpc_legs = run_phase(phase_mpc, dev)
    mpc_launches = mpc_legs["block_tridiag"]
    portfolio_launches = run_phase(phase_parametric_portfolio, dev)
    run_phase(phase_parametric_mpc, dev)
    polish_launches_sparse, polish_loops, pcg_stats, polish_paths = run_phase(phase_sparse_polish, dev)
    run_phase(phase_maros, dev)
    run_phase(phase_families, dev)
    layer_launches = run_phase(phase_qp_layer, dev)["float64"]
    run_phase(phase_compact, dev)
    run_phase(phase_export, dev)
    parallel_launches, sweep_stats, _, sharded_polish = run_phase(phase_parallel, dev)

    # launches: the batched headline solve's, and for K1r, which that
    # well-conditioned batch does not run, the Solver path's (its times:
    # CVXQP2_M in float32, where the Solver runs it; the others' at the
    # headline shape); for K8 the headline solve's with polish on (times at
    # the headline, and at CVXQP2_M B=1 under cvxqp2_m_b1); for K5's three
    # kernels the sparse path's CVXQP2_L solve (times at CVXQP2_L in
    # float64: P x with A x for ell_group, A x alone and B=64 beside it;
    # the fused start, both launches, for ell_cg_start; the scaling); for
    # K6's step kernels the row-sharded dense solve of the parallel phase
    # (n=1000, m=8000; times: one step at B=1, n=1000, float64, the step
    # kernels' shape there, and at the headline, float32, under B8192 and
    # B1024); for K6's dense loop the cg backend's dense
    # solve at B=1024 (times per CG step at the headline, B=8192 float32,
    # the other dense cases of phase k6 under their labels); for K6's device loop the
    # CVXQP2_L solve (times per CG step, and the stepwise path's beside
    # them under stepwise_ms); for K7 the MPC cell's block_tridiag solve
    # (times at the MPC cell, B=1000, float32); for K1r's resident path the
    # MPC cell's dense_inv solve (times at the MPC shape, all active,
    # float32); for K6 in polish's PCG the
    # loop's launches in LISWET1's float64 polish (times per CG step on
    # LISWET1's float32 polish system); for K7's cluster path the b = 140
    # float32 batch's solve_batch (times at its reduced matrix, the b = 99
    # float64 batch's under float64), for its device path and the wide
    # solve the b = cluster_max_block + 1 float64 batch's solve_batch (times
    # at its reduced matrix and factors, the wide solve's at the b = 140
    # float32 batch's under float32); for K2's leaf the
    # portfolio leg's set-up, cold solve and re-solves (times at its first
    # leaf, the routes' beside them under routes); for its cluster form the
    # Solver path's (CVXQP2_M at B=1; times at CVXQP2_M's first leaf in
    # float64, float32's under float32).
    kernels = [
        dict(name="admm_iter", route="cuda", source="osqp_tpu_torch/csrc/admm_iter.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:164", launches=launches["admm_iter"], **k1_stats),
        dict(name="admm_iter_refined", route="cuda", source="osqp_tpu_torch/csrc/admm_iter_refined.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:173", launches=solver_launches["admm_iter_refined"],
             **k1r_stats),
        dict(name="admm_iter_refined_resident", route="cuda", source="osqp_tpu_torch/csrc/admm_iter_refined.cu",
             replaces="osqp_tpu/linsys/dense_inv.py:173",
             launches=mpc_legs["dense_inv"]["admm_iter_refined_resident"], **k1r_resident_stats),
        dict(name="chol_inverse", route="cuda", source="osqp_tpu_torch/csrc/chol_inverse.cu",
             replaces="osqp_tpu/ops/spd_inverse.py:167", launches=launches["chol_inverse"], **k2_stats),
        dict(name="ruiz", route="cuda", source="osqp_tpu_torch/csrc/ruiz.cu",
             replaces="osqp_tpu/scaling.py:51", launches=launches["ruiz"],
             launches_resident=launches["ruiz_resident"], launches_split=launches["ruiz"] - launches["ruiz_resident"],
             **k4_stats),
        dict(name="ruiz_sweep", route="cuda", source="osqp_tpu_torch/csrc/ruiz.cu",
             replaces="osqp_tpu/scaling.py:51", launches=parallel_launches["ruiz_sweep"], **sweep_stats),
        dict(name="term_products", route="cuda", source="osqp_tpu_torch/csrc/term_products.cu",
             replaces="osqp_tpu/termination.py:47", launches=launches["term_products"],
             launches_backward=layer_launches["term_products"], **k3_stats),
        dict(name="kkt_lu_factor", route="cuda", source="osqp_tpu_torch/csrc/kkt_lu.cu",
             replaces="osqp_tpu/linsys/kkt_lu.py:37", launches=polish_launches["kkt_lu_factor"],
             launches_backward=layer_launches["kkt_lu_factor"], **k8_factor_stats),
        dict(name="kkt_lu_solve", route="cuda", source="osqp_tpu_torch/csrc/kkt_lu.cu",
             replaces="osqp_tpu/linsys/kkt_lu.py:42", launches=polish_launches["kkt_lu_solve"],
             launches_backward=layer_launches["kkt_lu_solve"], **k8_solve_stats),
        dict(name="ell_group", route="cuda", source="osqp_tpu_torch/csrc/ell_ops.cu",
             replaces="osqp_tpu/sparse_ops.py:120", launches=sparse_launches["ell_group"], **k5_group_stats),
        dict(name="ell_cg_start", route="cuda", source="osqp_tpu_torch/csrc/ell_ops.cu",
             replaces="osqp_tpu/linsys/cg.py:129", launches=sparse_launches["ell_cg_start"], **k5_start_stats),
        dict(name="ell_scale", route="cuda", source="osqp_tpu_torch/csrc/ell_ops.cu",
             replaces="osqp_tpu/sparse_ops.py:167", launches=sparse_launches["ell_scale"], **k5_scale_stats),
        dict(name="cg_step", route="cuda", source="osqp_tpu_torch/csrc/cg.cu",
             replaces="osqp_tpu/linsys/cg.py:129", launches=parallel_launches["cg_step"],
             launches_cg_B1024_stepwise=cg_dense_launches["stepwise_steps"], **k6_stats),
        dict(name="cg_dense_loop", route="cuda", source="osqp_tpu_torch/csrc/cg_dense.cu",
             replaces="osqp_tpu/linsys/cg.py:141", launches=cg_dense_launches["cg_dense_loop"],
             cg_B1024_wall_ms=cg_dense_launches["wall_ms"],
             cg_B1024_stepwise_wall_ms=cg_dense_launches["stepwise_wall_ms"],
             cg_B1024_dense_inv_wall_ms=cg_dense_launches["dense_inv_wall_ms"],
             cases={k: v for k, v in dense_stats.items() if not k.startswith("headline B=8192 n=100 m=200 float32")},
             **next(v for k, v in dense_stats.items() if k.startswith("headline B=8192 n=100 m=200 float32"))),
        dict(name="cg_step_polish_pcg", route="cuda", source="osqp_tpu_torch/csrc/cg.cu",
             replaces="osqp_tpu/polish.py:65", launches=polish_loops,
             launches_solve=polish_launches_sparse["cg_loop"], paths=polish_paths, **pcg_stats),
        dict(name="k7_factor", route="cuda", source="osqp_tpu_torch/csrc/block_tridiag.cu",
             replaces="osqp_tpu/linsys/block_tridiag.py:133", launches=mpc_launches["bt_factor"],
             launches_warp=mpc_launches["bt_factor_warp"], **k7_factor_stats),
        dict(name="k7_solve", route="cuda", source="osqp_tpu_torch/csrc/block_tridiag.cu",
             replaces="osqp_tpu/linsys/block_tridiag.py:180", launches=mpc_launches["bt_solve"],
             launches_warp=mpc_launches["bt_solve_warp"], **k7_solve_stats),
        dict(name="cg_loop", route="cuda", source="osqp_tpu_torch/csrc/cg.cu",
             replaces="osqp_tpu/linsys/cg.py:129", launches=sparse_launches["cg_loop"], paths=sparse_paths,
             **loop_stats),
        dict(name="block_tridiag_factor_device", route="cuda", source="osqp_tpu_torch/csrc/block_tridiag.cu",
             replaces="osqp_tpu/linsys/block_tridiag.py:144",
             launches=k7_large_launches["device"]["bt_factor_device"], **k7_device_stats),
        dict(name="block_tridiag_factor_cluster", route="cuda", source="osqp_tpu_torch/csrc/block_tridiag.cu",
             replaces="osqp_tpu/linsys/block_tridiag.py:144",
             launches=k7_large_launches["cluster"]["bt_factor_cluster"], **k7_cluster_stats),
        dict(name="block_tridiag_solve_wide", route="cuda", source="osqp_tpu_torch/csrc/block_tridiag.cu",
             replaces="osqp_tpu/linsys/block_tridiag.py:180",
             launches=k7_large_launches["device"]["bt_solve_wide"], **k7_wide_stats),
        dict(name="chol_inverse_leaf", route="cuda", source="osqp_tpu_torch/csrc/chol_inverse.cu",
             replaces="osqp_tpu/ops/spd_inverse.py:129", launches=portfolio_launches["chol_inverse_leaf"],
             **k2_leaf_stats),
        dict(name="chol_inverse_leaf_cluster", route="cuda", source="osqp_tpu_torch/csrc/chol_inverse.cu",
             replaces="osqp_tpu/ops/spd_inverse.py:129",
             launches=solver_launches["chol_inverse_leaf_cluster"], **k2_cluster_stats),
    ]
    # Each row's torch.library operator (csrc/torch_ops.cpp), which a
    # traced program calls in place of the ctypes launch (ruiz_sweep, the
    # row-sharded entries' steps, has none); for K7's and K6's step, the
    # operator's ms beside the launch's from phase dense_ops.
    for k in kernels:
        k["operator"] = OPERATORS[k["name"]]
    by_name = {k["name"]: k for k in kernels}
    by_name["cg_step"]["operator_ms"] = op_stats["cg_step"]["op_ms"]
    by_name["cg_dense_loop"]["operator_ms"] = op_stats["cg_dense_loop"]["op_ms"]
    for row, key in (("k7_factor", "k7 warp"), ("block_tridiag_factor_cluster", "k7 cluster"),
                     ("block_tridiag_factor_device", "k7 device")):
        by_name[row]["operator_ms"] = op_stats[key]["factor_op_ms"]
    by_name["k7_solve"]["operator_ms"] = op_stats["k7 warp"]["solve_op_ms"]
    by_name["block_tridiag_solve_wide"]["operator_ms"] = op_stats["k7 device"]["solve_op_ms"]
    # the row-sharded dense polish (the parallel phase): launches of K2's
    # leaf, K3 and K6's step per polish, and K2's route on its S
    for row, key in (("chol_inverse_leaf", "chol_inverse_leaf"), ("chol_inverse_leaf_cluster",
                     "chol_inverse_leaf_cluster"), ("term_products", "term_products"), ("cg_step", "cg_step")):
        by_name[row]["launches_sharded_polish"] = sharded_polish["launches"][key]
    by_name["chol_inverse_leaf"]["sharded_polish_S"] = sharded_polish["s_inverse"]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was launched no time on its main path")
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
