#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on flushed lines with the seconds since start:

1. device   the card's name, count, power limit, torch and CUDA versions;
            exits non-zero without a CUDA device.
2. build    the nvcc build of sctl_tpu_torch/csrc/*.cu for sm_90a, with
            its wall time, the ptxas register / shared-memory / spill
            lines and the two M2L kernels' dynamic shared memory.
3. setup    KIFMM(Laplace3D_FxU, p=6, depth=6, float32) on 1e7 uniform
            points from numpy.random.default_rng(0), as bench.py's
            bench_fmm.
4. kernels  each CUDA kernel against its plain PyTorch version on the
            card, at the widths of that KIFMM with a reduced count
            (sctl_tpu_torch/kernel_cases.py).  Bar: 1e-5 of the maximum,
            since the kernels sum in another order than the plain
            versions and rsqrtf is not torch.rsqrt; the redesigned
            kernels of this path (the slab stencil on a compacted slab,
            the two shared-surface kernels, all with counts) also
            against their plain versions in float64 (bar 5e-6).  Kernel
            time from CUDA events over 20 launches after a warm-up.
5. main     the KIFMM's evaluation: one warm and three timed
            evaluations with fresh densities, per-stage CUDA-event
            times (the P2P stage as the route's stencil, "P2P near", and
            the plain overflow sidebands, "P2P sidebands"), peak device
            memory, one profiled evaluation (device
            time by kernel, busy share), and the relative error at 1000
            sampled targets against a float64 direct sum on the card
            (bar 2e-4; BASELINE.md rung 1 is 8.1e-5 for p=6 f32).
            Every kernel's launch count in the four evaluations must be
            > 0.  The rounding spread: the error at the densities scaled
            by 1 + k 1e-6, k = 0..4, with S2M and L2T through their
            kernels and through their plain versions in float64; the
            kernels' median at most 1.25 times the float64 way's, every
            error under the bar.  Then each kernel alone on the run's
            own tensors; the slab stencil and the two shared-surface
            kernels over the real slots (counts) and over every slot,
            their blocks an SM (occupancy API) and their Laplace
            issue-slot floors (the SASS instructions a pair of the inner
            loop, cuobjdump); and the
            M2L kernel (3xTF32 on the tensor cores) at each level 3-6 on
            the run's own stack: its time against its CUDA-core and
            tensor-core bounds, its split, the bytes its blocks copy
            (tile counts), and its error
            against float64, at most twice the float32 plain version's.
4b. depth 2 ParticleFMM(Laplace3D_FxU) on 45,000 uniform points from
            numpy.random.default_rng(1): the tree path at automatic depth
            2, whose 64 boxes take S2M and L2T through the U-list kernel
            and, at about 700 points a box, the near field through the
            halo stencil; error at 1000 sampled targets against a float64
            direct sum on the card (bar 2e-4, as phase 4); then
            ParticleFMM.eval_tensor (device tensors in and out) against
            eval on the same densities (bar 1e-6 of the maximum).
5.  bie      the Stokes BIE solve of bench.py's bench_bie at its size:
            BoundaryIntegralOp(Stokes3D_DxU) at tolerance 1e-6 on
            torus_patches(nu=48, nv=20, q=6, R=2, r=0.5), 103,680
            unknowns, float32, far field through the adaptive FMM.
            Setup seconds by stage; the U-list kernel against its plain
            version at the far FMM's widths on 32 boxes for each of the
            six tree formulas (bar 1e-5, as phase 3) and against the
            plain version in float64 (bar 5e-6); the operator apply
            (median of 5, and by stage from CUDA events), and how far
            two applies of one density differ; the U-list kernel's own
            time per apply against its bound, its launches in one apply
            (one: the lists are compacted at setup), the apply's U
            stage and the kernel against float64 on the apply's own
            inputs (at most twice the float32 plain version's error:
            on these near-surface double-layer pairs float32 itself
            reads about 6e-6); the
            GMRES solve to 1e-6 (median of 2 after a warm solve).  Fails
            unless the residual recomputed with one more apply is at most
            1.5e-6, the error at 16 interior points against the exact
            Stokeslet at most 1e-4 (tests/test_bie.py:244) and the solve
            takes fewer than 120 iterations.  The U-list cases also run
            the kernel's float64 build against the plain version in
            float64 (bar 1e-12).  Then bench.py's host-loop baseline
            (:285-292): the host gmres on b (1 + 5e-7), tol 1e-6, at
            most 120 iterations, its seconds against the device solve's
            (bench.py's vs_baseline); and its recycling legs
            (:313-346): gmres_device(max_iter=30, restarts=4,
            recycle=True) on b, then the Stokeslet at (0, 6, 0.5) as a
            second right-hand side, solved plain and with the recycled
            stack as precond (iterations printed, no bar).  Each of
            these three residuals recomputed at most 1.5e-6.
5f. bie f64  bench.py's bench_bie_f64 (:105-186) on the card in
            float64: torus_patches(nu=16, nv=8, q=6), 13,824 unknowns,
            quadrature tolerance 1e-6, the far field through the
            adaptive FMM (cutoff 15,000 far nodes) on phase 5's
            operator tables, boundary data from the float64 p2p; the
            host gmres to a 1e-10 relative residual (at most 200
            iterations).  Setup seconds by stage, apply seconds (median
            of 5), solve seconds, iterations, the residual as returned
            (at most 1e-10) and recomputed (at most 2e-10), the
            interior error as phase 5 (at most 1e-4), and the float64
            U-list kernel: launched every apply, its time on one
            apply's inputs against its bound and its DP-instruction
            floor (cuobjdump), its error against its plain version in
            float64 (bar 1e-12).
5L. bie laplace  the Laplace double layer at bench_bie's width: the
            interior Dirichlet problem of tests/test_bie.py:89-124 on
            torus_patches(nu=48, nv=20, q=6), 34,560 unknowns, float32,
            tolerance 1e-6, the device near engine, the far field through
            the adaptive FMM (cold Laplace tables, p=6; its U list
            p2p_ulist's Laplace3D-DxU formula), A(s) = D s - s/2, boundary
            data the float64 p2p sum of a unit charge at (0, 6, 0.5),
            gmres_device to 1e-6.  Setup seconds by stage, the apply
            (median of 5, by stage from CUDA events), the U-list kernel
            on one apply's inputs against its bound and plain version in
            float64 (at most twice the float32 plain version's error),
            its launches an apply.  Bars: under 120 iterations, the
            residual recomputed at most 1.5e-6, the error at the 16
            interior ring points against the exact potential at most
            1e-4.
5L-f64      the Laplace double layer in float64 on the card on phase
            5f's torus_patches(nu=16, nv=8, q=6), 4,608 unknowns,
            tolerance 1e-6, the far field through the adaptive FMM
            (cutoff 15,000 far nodes, phase 5L's tables; its U list the
            float64 build of p2p_ulist's Laplace3D-DxU formula), boundary
            data of 5L's unit charge through the float64 p2p, the host
            gmres to a 1e-10 relative residual.  Setup seconds by stage
            with the host per-pair fallback count, apply seconds (median
            of 5), iterations, the residual as returned (at most 1e-10)
            and recomputed (at most 2e-10), the interior error as 5L (at
            most 1e-4), the float64 U-list kernel's launches (one an
            apply) and its time on one apply's inputs against its bound
            and its plain version in float64 (bar 1e-12).
5h. bie host  the host near path on the card: torus_patches(nu=12,
            nv=6, q=6), Laplace3D-DxU, tolerance 1e-6, float32: the
            device engine and the host path (use_device_near=False) on
            one geometry, the same near pairs, each engine's setup seconds
            and fallback count; their applies of one density within
            30 tol; the host path writes its near cache under a temporary
            directory and an op over a bare ParametricPatchList (no
            device_geom, so the host path by default) reads it, skips the
            near stages and applies bit for bit as the host path's (the
            near scatter in its deterministic form).
5q. legacy  LegacyQuadrature on BasisElemList.discretize(8,
            sphere_patches(n_per_face=2, q=6).charts), 24 elements,
            order_singular 12, order_direct 8: Laplace on the surface and
            at the near and deep targets of tests/test_legacy_quadrature.py
            (Gauss identity, 2e-4), the Stokes double layer of a rigid
            translation (5e-3); setup seconds (host, float64), eval ms on
            the card (the far sum through p2p); the card's eval in float64
            within 1e-12 and in float32 within 1e-5 (off the surface;
            twice the float32 CPU eval's error on it) of the same setup's
            float64 CPU eval.

6a. direct  ParticleFMM(float32) on 39,000 points from
            numpy.random.default_rng(3), one run for each of the eight
            kernels (unit normals for the double layers): the direct path
            through the p2p kernel (for Stokes3D-DxU also
            ParticleFMM.eval_tensor against eval, bar 1e-6).  At 1000
            sampled targets the float32 result against the float64 p2p
            on the card (bar 5e-6,
            tests_tpu/test_p2p_accuracy.py:45), and the float64 p2p
            against its plain version (bar 1e-12).  p2p's block for each
            formula in both types (targets a thread, blocks an SM from
            the occupancy API).  Then p2p against its plain version for
            every formula in both types at 4096 x 39,000 (bars 1e-5 and
            1e-12), and its float32 Stokes3D-FxU issue-slot floor.
6b. tree    ParticleFMM(float32) on 2e5 points from default_rng(4) at
            automatic depth for Laplace3D-DxU and -FxdU and Stokes3D-DxU
            and -FSxU: the tree path; error at 1000 sampled targets
            against the float64 p2p (bar 2e-4).  The cold Stokes3D-FSxU
            table build (p=6, rcond 3e-5) is timed on its own line first.
6c. stokes  the Stokeslet, Stokes3D-FxU, at 1e7 uniform points from
            default_rng(2), sources = targets, normal densities, p=6,
            float32: first through ParticleFMM at its defaults (the tree
            at about 256 points a leaf, depth 5: S2M and L2T through the
            U-list kernel, the near field through the halo stencil), then
            through KIFMM at bench_fmm's depth 6 on the same data.  For
            each: setup seconds, the median of 3 evaluations with fresh
            densities, per-stage CUDA-event times, one profiled
            evaluation, peak device memory and the error at 1000 sampled
            targets against the float64 p2p (bar 2e-4), with that
            oracle's time against its bound, its block (targets a
            thread, blocks an SM, source splits) and its floor from the
            DP instructions a pair of its loop at the DP pipe's rate;
            at depth 5 the halo stencil
            alone on the run's columns, over the boxes' real slots and
            over every padded slot (what the counts save).  At depth 6
            also the error with the M2L sweep at
            the exact ranks instead of the capped ones, the rounding
            spread of phase 4 (S2M and L2T through the shared-surface
            kernels and through their plain versions in float64), and
            the level-6
            M2L three ways (the sweep at capped and at exact ranks, the
            blocked kernel at capped ranks): times and differences.
            Last, the error against size and depth: 4,000 points at
            depth 3, then 2e5 points at depths 3 to 6, from
            default_rng(5) (bar 2e-4).
7.  p=8     ParticleFMM(accuracy=8, float32), Laplace3D_FxU, at 1e7
            uniform points from default_rng(7), sources = targets, at its
            defaults (depth 5, about 305 points a leaf): BASELINE.md's
            rung 2.  The cold p=8 table build on its own line; setup
            seconds; the route of each M2L level (level 2 the per-parity
            sweep, levels 3-5 the grid kernel m2l_grid, chosen by the
            stacks' sizes) and of the near field (the halo stencil
            p2p_stencil, as cap_t is over the slab stencil's 256); the
            median of 3 evaluations with fresh densities, per-stage
            times, one profiled evaluation, peak device memory, and the
            error at 1000 sampled targets against the float64 p2p (bar
            2e-4), and the rounding spread of phase 4.  m2l_grid,
            p2p_stencil and the two shared-surface kernels (cap_s 344,
            cap_t 328, ns 296) against their plain versions at reduced
            cases (p2p_stencil for the six tree formulas; all but
            m2l_grid also against the plain version in float64, bar
            5e-6; bar 1e-5, as phase 4) and alone at the run's shapes;
            m2l_grid at each level 3-5 as phase 4 does the blocked
            kernel; p2p_stencil and the two shared-surface kernels over
            the real slots and over every padded slot, and their
            Laplace issue-slot floors (the SASS instructions a pair of
            the inner loop, cuobjdump), the surface kernels' blocks an
            SM.  The
            level-5 M2L three ways on one random grid (m2l_grid, the
            blocked kernel at the same ranks, the per-parity sweep at
            the same ranks) and the near field through p2p_stencil and
            through p2p_ulist over each box's 27 neighbours' real slots:
            times and differences.  Last, rung 2 itself: KIFMM(p=8, depth=3) at
            4,000 points against the float64 p2p (bar 1e-4,
            tests/test_accuracy_ladder.py:32-33).
8.  float64 the float64 ladder on the card, every summary line with the
            card's name and power limit.  8d's set-up first:
            KIFMM(Laplace3D_FxU, p=6, depth=6, float64) on phase 4's 1e7
            points (its cold float64 tables, rcond 1e-9, timed with it),
            whose routes must be the shared-surface kernels, the slab
            stencil and the per-parity M2L sweep at the exact ranks.
    8a.     the float64 builds of surface_pair, l2t_surface and
            p2p_stencil9 at 8d's widths, and of p2p_stencil at 8e's,
            against their plain versions in float64 on the same inputs
            (bar 1e-12), on kernel_cases.py's cases ("[f64]") and every
            tree formula's ("[kernel,f64]").
    8d.     the 1e7-point float64 evaluation: warm, then the median of
            3 with fresh densities, stage times from CUDA events, one
            profiled evaluation, peak device memory and the error at
            1000 sampled targets against the float64 p2p (bar 5e-5,
            rung 3's); then each float64 build alone on the run's own
            tensors, its time against its bound (34 TFLOP/s) and held to
            its plain version (bar 1e-12), over every slot too, its
            blocks an SM and its DP-pipe floor (the DP instructions a
            pair of its inner loop, cuobjdump, at 64 lane-operations a
            clock per SM).
    8e.     ParticleFMM(accuracy=8, float64) at phase 7's 1e7 points
            (depth 5, cap_s 344: S2M and L2T through the float64 U-list
            kernel, as the surface rule refuses that capacity at 8
            bytes, the near field through the float64 halo stencil):
            set-up with its cold tables, eval, the figures of 8d (bar
            1e-6, rung 4's), the halo stencil's cases, and the halo
            stencil and the two U-list calls alone against their plain
            versions (bar 1e-12).
    8b.     rungs 3 and 4: KIFMM(p=6 and 8, depth 3, float64) on the
            ladder's 2,000 points from default_rng(12) against the
            float64 p2p at every target (bars 5e-5 and 1e-6,
            tests/test_accuracy_ladder.py:38-43).
    8c.     rung 7: the same at p=10 and 12 on the hiprec tables read
            from the committed lite files in ./data/ (rcond 1e-10; bar
            3e-8, :127-146); a missing file fails the phase.

9.  spectral the spectral layer in float64 on the card
            (sctl_tpu_torch.linalg), each figure with the card's name
            and power limit.
    9a.     SphericalHarmonics(512): the Legendre table's host build and
            its move to the card, shc2grid then grid2shc of 8 vectors
            from default_rng(9) (bar 1e-8 absolute,
            tests/test_sph_harm.py:448), each transform's time (CUDA
            events) and the peak device memory; at p = 128 the card
            against the CPU on the same inputs (bar 1e-12 of the
            maximum); the FFT facade's C2C / C2C_INV and R2C / C2R at
            dims (128, 128, 128), howmany 4: forward and round trip
            against the CPU and the round trip against the input (bar
            1e-12), times.
    9b.     p = 128: vecshc2grid then grid2vecshc with W_00 = X_00 = 0
            (bar 1e-9 absolute); stokes_eval_sl and stokes_eval_dl at
            1,000 targets on each of the spheres r = 0.55 and 1.7
            against direct sums of Stokes3D_FxU and Stokes3D_DxU
            (normals the sphere's points) over a (2p+2) x (4p+4) grid
            through direct_eval_blocked, the float64 p2p (bars 2e-5 and
            1e-3 of the maximum, tests/test_sph_harm.py:253-258, and
            1e-8 beside them, which a float32 slip on either side
            fails); the same oracle through the plain p2p on the CPU at
            the first 300 targets, held against the card's potentials
            (1e-8) and against the card's oracle (bar 1e-12);
            stokes_eval_kself, stokes_pressure_sl and stokes_eval_kl at
            p = 64 on the same targets against the CPU (bar 1e-11).
    9c.     SDC(8).adaptive_solve, tol 1e-10, to T = 0.25 on the rigid
            rotation of 4 fields at p = 256, F(u) = -du/dphi through
            shc2grid_grad(grid2shc(u)), initial coefficients N(0, 1)
            damped by exp(-l/32): T reached and the error against each
            (c_lm, s_lm) pair rotated by m T at most 10 tol of the
            maximum (tests/test_ode.py:44-48); accepted steps, F calls,
            wall time.
            The float64 p2p must have launched (the oracles of 9b).

10. library the rest of the single-device library, every figure with the
            card's name and power limit.
    10a.    the native host runtime (sctl_tpu_torch/native) built with
            g++ on the card's host (a failed build fails the phase); the
            UniformTree of phase 4's 1e7 points at depth 6 (its box sort
            the native radix sort) and the same sort through numpy's
            stable argsort: identical permutations, both times; PtTree(3)
            .update_refinement of 1e6 points from default_rng(10) (80% on
            a sphere of radius 0.3, 20% uniform), max_pts 64, balance21:
            seconds, leaves, levels, check_2to1 true.
    10b.    the profiler at level 0 around five evaluations of KIFMM(
            Laplace3D_FxU, p=6, depth 5, float32) on 1e6 uniform points:
            the median of the KIFMM::Eval blocks (sync) within 10% of
            the median of CUDA events around eval_tensor, the FLOP
            counter 5 x _flop_model(), the report printed; then the
            eval's stage times (CUDA events) and one profiled
            evaluation (device time by kernel, busy share).
    10c.    KIFMMLd's flagship rung (BASELINE.md rung 8,
            tests/test_accuracy_ladder.py:98-112): p = 12, depth 2,
            rcond 1e-11, 1,200 points from default_rng(12), on the
            card's host in a process of its own started after the build
            (its tables built cold unless the data directory or an
            earlier build has them), against the card's float64 p2p:
            bar 1.5e-9; its setup and eval seconds.
    10d.    Matrix.pinv of a (400, 300) float64 matrix on the card
            against the CPU's (1e-12); a KrylovPrecond collected by the
            host gmres on card tensors, saved and restored by
            utils.checkpoint bit for bit on the card.
            surface_pair, l2t_surface and the float64 p2p must have
            launched.

11. dist    the distributed layer (sctl_tpu_torch.comm, tree.dist_tree,
            fmm.kifmm_dist, the ring, eval_sharded, GMRES and SDC over a
            comm, fmm.adaptive_dist and bie.dist), its ranks started by comm.run_ranks (spawned
            processes, FileStore rendezvous), every figure with the
            card's name and power limit.
    11a.    one rank over NCCL: every Comm method and verb on CUDA
            tensors, KIFMMDist (p=6, depth 3, 20,000 points) and
            eval_direct_ring through the one-rank group, each equal to
            the self-communicator's result bit for bit.
    11b.    four gloo ranks sharing the card (NCCL refuses two ranks of
            one communicator on one device; gloo's send and receive take
            no CUDA tensor, so point-to-point stages through pinned host
            buffers): every verb on deterministic CUDA inputs against
            their closed-form blocks and against the same verbs on CPU
            tensors; then KIFMMDist(Laplace3D_FxU, p=6, depth=6,
            float32) on phase 4's 1e7 points, 16 planes a rank: setup,
            one warm and three timed eval_tensor calls with fresh
            densities (each ending in a synchronize and a barrier),
            each rank's stage times by CUDA events (the halo and
            coarse-gather exchanges stages of their own), peak device
            memory, launches; surface_pair, l2t_surface and p2p_ulist on
            rank 0's own slab against their plain versions (bar 1e-5)
            and alone at the slab's shapes against their bounds; the
            error at phase 4's 1000 sampled targets against its float64
            p2p sums (bar 2e-4) and against phase 4's potential there
            (bar 1e-4, tests/test_fmm_dist.py:56); and at the 5 targets
            where the two potentials differ most over all 1e7, each
            against the float64 p2p (KIFMMDist's bar 2e-4 of the sampled
            maximum; phase 4's, printed, has no bar: its near field
            differences global float32 coordinates).
    11c.    eval_direct_ring over the four ranks on 1e5 Laplace points
            from default_rng(13), float32, 1e10 pairs through p2p,
            against the float64 p2p in one process (bar 5e-6).
    11d.    DistPtTree of 10a's 1e6 points (max_pts 64, balance21): its
            leaves identical to the host PtTree's; AdaptiveFMM(p=4,
            max_pts 128, float64).eval_sharded on 2e5 points of that
            distribution within 1e-10 of the maximum of the
            single-device eval; the float64 p2p_ulist on rank 0's block
            of the U list against its plain version (bar 1e-12).
    11e.    gmres on the row-sharded N = 4,096 system of
            tests/test_gmres.py:78's form: the iterations of one process
            and its residual to 1e-12; SDC(8, comm) with one of four
            9c-style fields a rank at p = 64 to T = 0.25: the steps and F
            calls of one process holding all four.
    11f.    the distributed BIE on the same four ranks: phase 5's
            bench_bie (Stokes3D_DxU, float32, tol 1e-6, 103,680
            unknowns) with BoundaryIntegralOp(comm=) on phase 5's far
            tables: the distributed near search's pairs equal to phase
            5's, each rank's setup seconds by stage and its ghost leaves
            (Crg > 0 on some rank), the sharded apply (one warm, the
            median of three with fresh densities, each ending in a
            synchronize and a barrier), each rank's stage ms by CUDA
            events and peak device memory beside phase 5's, the gathered
            apply against phase 5's apply of the same density (bar 30
            tol, 3e-5, tests/test_near_device.py:111-126, with phase 5's
            two-apply spread beside it), gmres_device(comm=) on phase 5's
            system: iterations within 2 of phase 5's, the residual
            recomputed through the single-process op (1.5e-6), the
            interior error (1e-4), the distance from phase 5's solution;
            p2p_ulist on rank 0's U-list block (own targets, ghost
            sources) against its plain version (1e-5) and alone against
            its bound; the direct regime (sphere_patches(1),
            Laplace3D_DxU, each rank's far sums through p2p) against its
            single-process apply (1e-5), and p2p on rank 0's far sum
            (the replicated targets, its far nodes and densities)
            against its plain version (1e-5) and alone against its
            bound.  p2p_ulist and p2p must launch on every rank.
            A failed or hung rank fails the phase.

Each phase sets the launch counts to 0 before it drives its path and
reads them after; every kernel of the path must have launched (phases 8
and 9 the float64 counts, `launches_f64`).  Then a line with phase 8's
figures, a line with the BIE legs' figures (phase 5's baseline and
recycling, phases 5f, 5L, 5L-f64, 5h, 5q), a line with phase 9's
figures, a line with phase 10's, a line with phase 11's, one JSON line
with each kernel's numbers (launches summed over phases 4 to 7 and 9 to
11, the ranks' included; phase 11's figures under "phase11", 11f's
under "phase11f";
p2p_ulist's float64 build under "f64"; the four float64 builds as
"name[f64]" entries with their launches over phase 8), the card's name
and power limit, the run's wall time, and the closing JSON line.  Any
failed check raises, so the script exits non-zero and prints no closing
line.
"""

import json
import subprocess
import sys
import time

T0 = time.perf_counter()

N_POINTS = 10_000_000
DEPTH = 6
P = 6
N_SAMPLE = 1000
KERNEL_BAR = 1e-5
FMM_BAR = 2e-4

# H100 SXM peaks (NVIDIA H100 data sheet):
# device memory 3.35 TB/s, f32 on the CUDA cores 67 TFLOP/s; rsqrt on
# the special-function units 16 per SM per clock (NVIDIA's arithmetic
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz.
# f64 on the CUDA cores 34 TFLOP/s (the data sheet's FP64; its 67 is the
# tensor cores', which a pair kernel does not use).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
RSQRT_PER_S = 16 * 132 * 1.98e9
# dense TF32 on the tensor cores (the data sheet); the M2L kernels run
# their f32 products as three TF32 passes (3xTF32)
TF32_FLOPS = 495e12

ROUTES = {
    "surface_pair": ("sctl_tpu_torch/csrc/surface_pair.cu",
                     "sctl_tpu/ops/pallas_sl.py:254"),
    "l2t_surface": ("sctl_tpu_torch/csrc/l2t_surface.cu",
                    "sctl_tpu/ops/pallas_sl.py:354"),
    "m2l_grid_blocked": ("sctl_tpu_torch/csrc/m2l_blocked.cu",
                         "sctl_tpu/ops/pallas_m2l.py:272"),
    "p2p_stencil9": ("sctl_tpu_torch/csrc/p2p_stencil9.cu",
                     "sctl_tpu/ops/pallas_p2p.py:425"),
    "p2p_ulist": ("sctl_tpu_torch/csrc/p2p_ulist.cu",
                  "sctl_tpu/ops/pallas_p2p.py:496"),
    "p2p": ("sctl_tpu_torch/csrc/p2p_direct.cu",
            "sctl_tpu/ops/pallas_p2p.py:555"),
    "m2l_grid": ("sctl_tpu_torch/csrc/m2l_grid.cu",
                 "sctl_tpu/ops/pallas_m2l.py:149"),
    "p2p_stencil": ("sctl_tpu_torch/csrc/p2p_stencil.cu",
                    "sctl_tpu/ops/pallas_p2p.py:340"),
}
PARTICLE_N = 45_000
DIRECT_N = 39_000
DIRECT_BAR = 5e-6
ORACLE_BAR = 1e-12
TREE_N = 200_000
STOKES_N = 10_000_000
STOKES_DEPTH_N = 200_000
P2P_CASE = "p2p[Stokes3D-FxU,f32]"
BIE_TOL = 1e-6
BIE_RESID_BAR = 1.5e-6
BIE_INTERIOR_BAR = 1e-4
BIE_MAX_ITER = 120
# p2p_ulist on one BIE apply's own inputs against float64: at most this
# times the float32 plain version's error on the same inputs
ULIST_MAIN_RATIO = 1.1
# bench.py's host-loop baseline (:285-292) and recycling legs (:313-346)
BIE_HOST_SCALE = 1.0 + 5e-7
BIE_RECYCLE_M, BIE_RECYCLE_RESTARTS = 30, 4
BIE_SRC2 = (0.0, 6.0, 0.5)
# phase 5f, bench.py's bench_bie_f64 (:105-186) in float64 on the card
F64_NU, F64_NV = 16, 8
F64_CUTOFF = 15_000
F64_TOL = 1e-10
F64_MAX_ITER = 200
F64_RESID_BAR = 2e-10
# phase 5h, the host near path on a smaller torus
HOST_NU, HOST_NV = 12, 6
# phase 5q: the card's float32 legacy eval against the CPU's on the same
# setup: off the surface against the float64 eval; on it against the
# float32 eval, where the two float32 sums round r . n of near-coincident
# pairs in other orders (the card fuses its multiply-adds): on an H100
# they read 2.6e-5 (Laplace) and 4.4e-5 (Stokes) apart
LEGACY_F32_BAR = 1e-5
LEGACY_F32_SURFACE_BAR = 1e-4
# ParticleFMM.eval_tensor against eval, float32
EVAL_TENSOR_BAR = 1e-6
P8_N = 10_000_000
P8 = 8
RUNG2_N = 4000
RUNG2_BAR = 1e-4
# the rounding-spread check: the evaluation at densities f (1 + k 1e-6),
# k = 0..4, with S2M and L2T through their kernels and through their
# plain versions in float64; the median error of the first at most this
# times the second's
SPREAD_SCALES = tuple(1.0 + 1e-6 * k for k in range(5))
SPREAD_RATIO = 1.25
# kernels whose cases are also held against their plain versions in
# float64 (DIRECT_BAR)
F64_CASES = ("p2p_stencil9", "surface_pair", "l2t_surface")
# phase 8, the float64 ladder: the four kernels whose float64 builds the
# float64 KIFMM runs (p2p and p2p_ulist are held in float64 by phases
# 5f and 6); the ladder's inputs and bars (tests/test_accuracy_ladder.py:
# 2,000 points from default_rng(12), depth 3; rungs 3 and 4 at p = 6
# and 8, :38-43; rung 7 at p = 10 and 12 on the hiprec tables, rcond
# 1e-10, :127-146); the 1e7-point float64 path at rung 3's bar and the
# float64 facade at accuracy 8 at rung 4's
F64_BUILDS = ("surface_pair", "l2t_surface", "p2p_stencil9", "p2p_stencil")
LADDER_N = 2000
RUNG_BARS = {6: 5e-5, 8: 1e-6}
RUNG7_P, RUNG7_RCOND, RUNG7_BAR = (10, 12), 1e-10, 3e-8
F64_FMM_BAR = 5e-5
F64_FACADE_ACC, F64_FACADE_BAR = 8, 1e-6
# phase 9, the spectral layer in float64 (tests/test_sph_harm.py's bars):
# the scalar round trip at p = 512 (:432-448), the card against the CPU
# at p = 128, the FFT facade's round trips; the vector round trip at
# p = 128, SL and DL against direct sums (:253-258) on each sphere,
# KSelf, the pressure and KL against the CPU at p = 64; SDC(8) to T = 0.25
# on the rigid rotation of 4 fields at p = 256 (tests/test_ode.py:44-48)
SH_P, SH_BATCH, SH_BAR = 512, 8, 1e-8
SH_CMP_P, CARD_CPU_BAR = 128, 1e-12
FFT_DIMS, FFT_HOWMANY, FFT_BAR = (128, 128, 128), 4, 1e-12
VEC_P, VEC_BAR = 128, 1e-9
SPHERE_N, SPHERE_R, SL_BAR, DL_BAR = 1000, (0.55, 1.7), 2e-5, 1e-3
# SL and DL also against 1e-8 of the maximum, and against the same oracle
# through the plain p2p on the CPU at the first SPHERE_WITNESS_N targets:
# float32 on either side rounds each term at about 6e-8, over that bar
SPHERE_WITNESS_N, SPHERE_TIGHT_BAR = 300, 1e-8
KL_P, KL_BAR = 64, 1e-11
SDC_ORDER, SDC_TOL, SDC_T, SDC_DT0 = 8, 1e-10, 0.25, 1e-3
SDC_P, SDC_FIELDS, SDC_DAMP = 256, 4, 32.0


def log(msg):
    print(f"[{time.perf_counter() - T0:8.1f} s] {msg}", flush=True)


def bound(work):
    """(bound_ms, bound_by) of a kernel's counted work: a pair kernel's
    operations are the kernel's per-pair count (KernelSpec.flops) at the
    f32 or f64 rate and, in float32, one rsqrt a pair."""
    t_bytes = work["bytes"] / HBM_BPS
    if "pairs" in work:
        if work.get("f64"):
            t_ops = work["pairs"] * work["pair_flops"] / F64_FLOPS
        else:
            t_ops = max(work["pairs"] * work["pair_flops"] / F32_FLOPS,
                        work["pairs"] / RSQRT_PER_S)
    else:
        t_ops = min(op_bounds(work).values()) / 1e3
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def op_bounds(work):
    """An M2L kernel's operations bounds, ms: its flops on the CUDA
    cores at the f32 rate and, for the 3xTF32 kernels, as three TF32
    passes on the tensor cores; none for a pair kernel."""
    if "flops" not in work:
        return {}
    out = {"bound_cuda_core_ms": 1e3 * work["flops"] / F32_FLOPS}
    if work.get("tf32x3"):
        out["bound_tensor_core_ms"] = 1e3 * 3 * work["flops"] / TF32_FLOPS
    return out


def ops_limit(work):
    """Which operations set a float32 pair kernel's bound: the FMA pipes
    or the rsqrt units."""
    fma = work["pairs"] * work["pair_flops"] / F32_FLOPS
    return "fma" if fma > work["pairs"] / RSQRT_PER_S else "rsqrt"


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() on the card over `reps` calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, nvidia-smi '{smi}', torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from sctl_tpu_torch.ops import _build
    _build.build(force=True)
    lib = _build.library()
    log(f"build: done; dynamic shared memory a block: m2l_grid_blocked "
        f"{lib.sctl_m2l_grid_blocked_smem()} B, m2l_grid "
        f"{lib.sctl_m2l_grid_smem()} B")


def phase_kernels(torch, kf, cases=None, f64_bar=None):
    """Each case's kernel against its plain version (and, with f64_bar,
    against the plain version in float64 on the same inputs: the
    redesigned pair kernels' cases take `plain(torch.float64)`)."""
    from sctl_tpu_torch.kernel_cases import kernel_cases, rel_max_err
    cases = kernel_cases(kf) if cases is None else cases
    rows = {}
    for name, (run, plain, library, work) in cases.items():
        bar = ORACLE_BAR if work.get("f64") else KERNEL_BAR
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        err = rel_max_err(out, ref)
        abs_err = float((out.double() - ref.double()).abs().max())
        err64 = None
        if f64_bar is not None:
            err64 = rel_max_err(out, plain(torch.float64))
            log(f"kernel {name}: against its plain version in float64 "
                f"{err64:.3e} (bar {f64_bar:g}; the float32 plain "
                f"version {rel_max_err(ref, plain(torch.float64)):.3e})")
            if not err64 < f64_bar:
                raise SystemExit(f"chip_smoke: {name} against float64: "
                                 f"{err64:.3e}")
        ms = cuda_ms(torch, run, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        lib_ms = None if library is None else cuda_ms(torch, library, 20)
        b_ms, b_by = bound(work)
        ob = op_bounds(work)
        shape = "x".join(str(s) for s in out.shape)
        log(f"kernel {name}: out {shape}, max rel err {err:.3e} "
            f"(bar {bar:g}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})" + "".join(
                f", {k} {v:.4f}" for k, v in ob.items()))
        if not err < bar:
            raise SystemExit(f"chip_smoke: {name} disagrees with its "
                             f"plain version: {err:.3e}")
        rows[name] = dict(case=shape, max_abs_err=abs_err,
                          max_rel_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          **ob, **({} if err64 is None
                                   else {"max_rel_err_f64": err64}))
    return rows


def profile_eval(torch, kf, fp, fo, eval_s):
    """One evaluation under torch.profiler: device time by kernel and
    the card's busy share against the unprofiled median eval time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kf._eval_impl(fp, fo)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    # device activity only (kernels, copies, sets): entries with device
    # time and no host time; operator entries repeat their kernels' time
    events = sorted((e for e in prof.key_averages()
                     if dev_us(e) > 0 and e.self_cpu_time_total == 0),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        log("profile: the profiler recorded no device time: busy share "
            "not measured")
        return
    log(f"profile: device busy {busy_ms:.3f} ms of the {1e3 * eval_s:.3f}"
        f" ms median eval ({busy_ms / (1e3 * eval_s):.3f}; the eval also"
        f" gathers densities and unsorts)")
    for e in events[:14]:
        log(f"profile: {dev_us(e) / 1e3:9.3f} ms {e.count:5d} calls  "
            f"{e.key[:90]}")
    return busy_ms


def phase_setup(torch):
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU
    rng = np.random.default_rng(0)
    xs = rng.random((N_POINTS, 3))
    f = rng.normal(size=(N_POINTS, 1))
    t = time.perf_counter()
    kf = KIFMM(Laplace3D_FxU, p=P, depth=DEPTH,
               device=torch.device("cuda"),
               dtype=torch.float32).setup(xs, xs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    log(f"setup: {setup_s:.2f} s (boxes {kf.src_tree.n_boxes}, "
        f"cap_s {kf.cap_s}, cap_t {kf.cap_t}, SL {kf.SL}, overflow "
        f"sources {kf.n_ovf_s} targets {kf.n_ovf_t}, M2L ranks "
        f"{kf._ops.blk_r}/{kf._ops.blk_r2})")
    return kf, xs, f, rng


def phase_main(torch, kf, xs, f, rng, counters, kept=None):
    """4: the KIFMM's evaluation (see the docstring); with `kept` a dict,
    the sampled targets, their float64 direct sums and the potential go
    into it (phase 11's references)."""
    import numpy as np
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    dev = kf.device
    f_dev = torch.as_tensor(f, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    u = kf.eval_tensor(f_dev)                       # warm
    torch.cuda.synchronize()
    times = []
    for rep in range(3):
        f2 = f_dev * (1.0 + 1e-6 * (rep + 1))       # fresh densities
        torch.cuda.synchronize()
        t = time.perf_counter()
        kf.eval_tensor(f2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {k: c.launches for k, c in counters.items()}
    med = sorted(times)[1]
    log(f"main: eval s {['%.4f' % s for s in times]}, median "
        f"{med:.4f} s, {N_POINTS / med / 1e6:.2f} Mpts/s; launches in "
        f"4 evals {launches}")

    fp, fo = kf.pad_density(f_dev)
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    kf._eval_impl(fp, fo, marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    log("main: stage ms " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages.items()))
    profile_eval(torch, kf, fp, fo, med)
    log(f"main: peak device memory of the evaluations "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    idx = rng.choice(N_POINTS, N_SAMPLE, replace=False)
    x64 = torch.as_tensor(xs, device=dev)
    u_ref = direct_eval_blocked(Laplace3D_FxU, x64[idx], x64,
                                torch.as_tensor(f, device=dev),
                                block_t=N_SAMPLE, block_s=1 << 17)
    u_s = u[torch.as_tensor(idx, device=dev)].double()
    err = float((u_s - u_ref).abs().max() / u_ref.abs().max())
    if kept is not None:
        kept.update(idx=idx, u_ref=u_ref.cpu().numpy(),
                    u=u.cpu().numpy())
    log(f"main: rel err at {N_SAMPLE} sampled targets vs f64 direct sum "
        f"{err:.3e} (bar {FMM_BAR:g})")
    if not np.isfinite(err) or not err < FMM_BAR:
        raise SystemExit(f"chip_smoke: KIFMM error {err:.3e}")
    if not all(v > 0 for v in launches.values()):
        raise SystemExit(f"chip_smoke: a kernel was not launched on the "
                         f"main path: {launches}")
    spread = rounding_spread(torch, kf, f_dev, idx, u_ref.cpu().numpy(),
                             "main")

    # each kernel alone at the main path's shapes (after the counts
    # were read)
    from sctl_tpu_torch.ops.m2l import m2l_grid_blocked
    from sctl_tpu_torch.ops.p2p import p2p_stencil9, slab_gather
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    ops = kf._ops
    ns, B = ops.n_surf, kf.src_tree.n_boxes
    n = 1 << DEPTH
    q_cm = torch.randn((1, ns, B), device=dev)
    h = n // 2
    qbp = torch.zeros((h + 2,) * 3 + (8 * ops.blk_r2,), device=dev)
    qbp[1:-1, 1:-1, 1:-1] = torch.randn((h, h, h, 8 * ops.blk_r2),
                                        device=dev)
    f_s = slab_gather(fp, kf.slab_idx)
    full = {
        "surface_pair": lambda: surface_pair(
            Laplace3D_FxU, kf.surf_out_L, kf.xs_sl, fp.reshape(1, -1),
            kf.cap_s, None, kf.cnt_s_box),
        "l2t_surface": lambda: l2t_surface(
            Laplace3D_FxU, kf.surf_out_L, kf.xt_sl, q_cm, kf.cap_t,
            kf.cnt_t_box),
        "m2l_grid_blocked": lambda: m2l_grid_blocked(qbp, ops.m2l_blk,
                                                     ops.m2l_blk_tc),
        "p2p_stencil9": lambda: p2p_stencil9(
            Laplace3D_FxU, n, kf.SL, kf.cap_t, kf.xt_rast, kf.xs_slab,
            f_s, None, kf.cnt9, kf.cnt_t_rast),
    }
    main_rows = alone_rows(torch, kf, full, launches, "main")
    del qbp
    for name, row in surface_times(torch, kf, fp, q_cm, "main").items():
        main_rows[name].update(row)
    main_rows["surface_pair"]["rounding_spread"] = spread
    st = stencil9_times(torch, kf, f_s, "main")
    main_rows["p2p_stencil9"].update(
        every_slot_ms=st["every_slot_ms"], blocks_per_sm=st["blocks_per_sm"],
        lanes_per_target=st["lanes_per_target"],
        **(issue_floor("p2p_stencil9", "p2p_stencil9_kernelIfLi0E",
                       st["pairs"], "main") or {}))
    del f_s
    main_rows["m2l_grid_blocked"]["levels"] = m2l_levels(torch, kf, "main")
    return main_rows


def alone_rows(torch, kf, full, launches, label):
    """Each kernel of `full` alone at the set-up KIFMM's shapes: its ms
    against its bound (the M2L kernels' two operations bounds too)."""
    from sctl_tpu_torch.kernel_cases import main_path_work
    work = main_path_work(kf)
    rows = {}
    for name, fn in full.items():
        ms = cuda_ms(torch, fn, 5)
        b_ms, b_by = bound(work[name])
        ob = {f"main_path_{k}": v for k, v in op_bounds(work[name]).items()}
        rows[name] = dict(launches=launches[name], main_path_ms=ms,
                          main_path_bound_ms=b_ms, main_path_bound_by=b_by,
                          **ob)
        log(f"{label}: {name} alone at the run's shapes (M2L: level "
            f"{kf.depth}) {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + "".join(f", {k} {v:.4f}" for k, v in ob.items())
            + f", work {work[name]}")
    return rows


def m2l_levels(torch, kf, label):
    """The route's M2L kernel at each level 3..depth of the set-up
    KIFMM, on one random grid of the level's shape with the route's own
    operator stack: its time (CUDA events, 5 launches) against its two
    operations bounds, its split, the bytes its blocks copy into shared
    memory (from the tile counts) beside the bytes the function needs,
    and its error against a float64 evaluation of the same inputs
    beside the float32 plain version's; the kernel must be within
    KERNEL_BAR of the plain version and at most twice the plain
    version's float64 error.  -> {level: row}."""
    from sctl_tpu_torch.kernel_cases import (m2l_grid_blocked_work,
                                             m2l_grid_work, m2l_kernel,
                                             rel_max_err)
    from sctl_tpu_torch.ops import m2l
    ops, name = kf._ops, m2l_kernel(kf)
    dev = kf.device
    rows = {}
    for lvl in range(3, kf.depth + 1):
        n = 1 << lvl
        h = n // 2
        if name == "m2l_grid_blocked":
            K, N = ops.m2l_blk.shape[1:]
            qp = torch.zeros((h + 2,) * 3 + (K,), device=dev)
            qp[1:-1, 1:-1, 1:-1] = torch.randn((h, h, h, K), device=dev)
            mats, fn = ops.m2l_blk, m2l.m2l_grid_blocked
            run = lambda: fn(qp, mats, ops.m2l_blk_tc)
            plain = m2l.m2l_grid_blocked_plain
            work = m2l_grid_blocked_work(h, mats)
            stages = (-(-h ** 3 // m2l.TC_BM) * -(-N // m2l.BLOCKED_BN)
                      * 26 * -(-K // m2l.TC_BK))
            per = 4 * m2l.TC_BK * (m2l.TC_BM + 2 * m2l.BLOCKED_BN)
            out_floats = h ** 3 * N
        else:
            r2, r = ops.m2l_at.shape[1:]
            qp = torch.zeros((n + 6,) * 3 + (r2,), device=dev)
            qp[3:-3, 3:-3, 3:-3] = torch.randn((n, n, n, r2), device=dev)
            mats, fn = ops.m2l_at, m2l.m2l_grid
            run = lambda: fn(qp, mats, ops.m2l_at_tc)
            plain = m2l.m2l_grid_plain
            work = m2l_grid_work(n, r, r2)
            stages = (8 * -(-h ** 3 // m2l.TC_BM) * -(-r // m2l.GRID_BN)
                      * m2l.N_VALID * -(-r2 // m2l.TC_BK))
            per = 4 * m2l.TC_BK * (m2l.TC_BM + 2 * m2l.GRID_BN)
            out_floats = n ** 3 * r
        out = run()
        torch.cuda.synchronize()
        nsplit = fn.last_nsplit
        ref = plain(qp, mats)
        e_plain = rel_max_err(out, ref)
        r64 = plain(qp.double(), mats.double())
        e_k, e_p = rel_max_err(out, r64), rel_max_err(ref, r64)
        del ref, r64
        ms = cuda_ms(torch, run, 5)
        ob = op_bounds(work)
        # partial outputs: written by the blocks, read by the sum
        copied = stages * per + 4 * out_floats * (2 * nsplit if nsplit > 1
                                                  else 1)
        rows[lvl] = dict(ms=ms, nsplit=nsplit, flops=work["flops"],
                         max_rel_err_plain=e_plain, err_f64=e_k,
                         plain_err_f64=e_p, copied_bytes=copied,
                         needed_bytes=work["bytes"], **ob)
        log(f"{label}: {name} at level {lvl} ({'x'.join(map(str, out.shape))}"
            f", split {nsplit}): {ms:.4f} ms, bounds "
            + ", ".join(f"{k} {v:.4f}" for k, v in ob.items())
            + f"; vs plain {e_plain:.3e} (bar {KERNEL_BAR:g}); vs float64 "
            f"{e_k:.3e}, the float32 plain version's {e_p:.3e} (ratio "
            f"{e_k / e_p:.2f}, bar 2); bytes copied into shared memory "
            f"{copied / 1e9:.3f} GB (tile counts), needed "
            f"{work['bytes'] / 1e9:.3f} GB")
        if not (e_plain < KERNEL_BAR and e_k <= 2 * e_p):
            raise SystemExit(f"chip_smoke: {name} at level {lvl}: "
                             f"{e_plain:.3e} from the plain version, "
                             f"{e_k:.3e} against float64 ({e_p:.3e})")
        del qp, out
        torch.cuda.empty_cache()
    top = rows[kf.depth]
    # DRAM bytes need Nsight Compute's counters, which need profiling
    # rights a plain run lacks; the tile counts' estimate stands
    top["dram"] = "not measured: no profiler counters"
    log(f"{label}: {name} DRAM bytes at level {kf.depth}: {top['dram']}")
    return rows


def reset(counters):
    for c in counters.values():
        c.launches = 0


def read(counters):
    return {k: c.launches for k, c in counters.items()}


def phase_particle(torch, counters):
    """ParticleFMM at automatic depth 2 through the U-list kernel."""
    import numpy as np
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    rng = np.random.default_rng(1)
    x = rng.random((PARTICLE_N, 3))
    f = rng.normal(size=(PARTICLE_N, 1))
    fmm = ParticleFMM(accuracy=P, device="cuda", dtype=torch.float32)
    fmm.set_kernel_s2t("src", "trg", Laplace3D_FxU)
    fmm.set_src_coord("src", x)
    fmm.set_src_density("src", f)
    fmm.set_trg_coord("trg", x)
    reset(counters)
    t = time.perf_counter()
    u = fmm.eval("trg")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read(counters)
    kf = next(iter(fmm._kifmm_cache.values()))
    log(f"particle: {PARTICLE_N} points, depth {kf.depth}, boxes "
        f"{kf.src_tree.n_boxes}, cap_s {kf.cap_s}, cap_t {kf.cap_t}, "
        f"S2M/L2T route "
        f"{'surface kernels' if kf.surface_route else 'p2p_ulist'}, near "
        f"route p2p_{kf.near_route}; setup and eval {secs:.2f} s; "
        f"launches {launches}")
    idx = rng.choice(PARTICLE_N, N_SAMPLE, replace=False)
    xd = torch.as_tensor(x, device="cuda")
    u_ref = direct_eval_blocked(Laplace3D_FxU, xd[idx], xd,
                                torch.as_tensor(f, device="cuda"))
    u_ref = u_ref.cpu().numpy()
    err = float(np.abs(u[idx] - u_ref).max() / np.abs(u_ref).max())
    log(f"particle: rel err at {N_SAMPLE} sampled targets vs f64 direct "
        f"sum {err:.3e} (bar {FMM_BAR:g})")
    if kf.depth != 2 or not np.isfinite(err) or not err < FMM_BAR:
        raise SystemExit(f"chip_smoke: depth-2 ParticleFMM failed: depth "
                         f"{kf.depth}, error {err:.3e}")
    if not _tree_kernels_launched(kf, launches):
        raise SystemExit(f"chip_smoke: the depth-2 path did not launch "
                         f"its kernels: {launches}")
    eval_tensor_check(torch, fmm, {"src": f}, u, "particle")
    return launches


def eval_tensor_check(torch, fmm, dens, u, label):
    """ParticleFMM.eval_tensor (device tensors in and out) against eval
    on the same densities: at most EVAL_TENSOR_BAR of the maximum."""
    import numpy as np
    ut = fmm.eval_tensor("trg", {k: torch.as_tensor(
        v, dtype=fmm.dtype, device="cuda") for k, v in dens.items()})
    torch.cuda.synchronize()
    if not (ut.is_cuda and ut.shape == u.shape):
        raise SystemExit(f"chip_smoke: {label}: eval_tensor gave "
                         f"{ut.device} {tuple(ut.shape)}")
    diff = _sample_err(ut.cpu().numpy(), u)
    log(f"{label}: ParticleFMM.eval_tensor against eval {diff:.3e} of the "
        f"max (bar {EVAL_TENSOR_BAR:g})")
    if not (np.isfinite(diff) and diff <= EVAL_TENSOR_BAR):
        raise SystemExit(f"chip_smoke: {label}: eval_tensor differs from "
                         f"eval by {diff:.3e}")


def _bie_setup(torch):
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.ops import Stokes3D_DxU
    t = time.perf_counter()
    lst = torus_patches(nu=48, nv=20, q=6, R=2.0, r=0.5)
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cuda",
                            dtype=torch.float32)
    op.set_accuracy(BIE_TOL)
    op.add_elem_list(lst)
    op.setup()
    secs = time.perf_counter() - t
    af = op._far_fmm
    if af is None:
        raise SystemExit("chip_smoke: the BIE far field did not take the "
                         "adaptive FMM")
    log(f"bie setup: {secs:.2f} s; by stage s " + ", ".join(
        f"{k} {v:.2f}" for k, v in op.setup_times.items()))
    log(f"bie setup: unknowns {op.dim(0)}, far nodes {len(op.Xf)}, leaves "
        f"{af.n_leaf}, levels {af.L}, cap_s {af.cap_s}, cap_t "
        f"{af.cap_t}, rcond {af.rcond:g}, U list up to {af.u_cap} source "
        f"leaves a leaf, compacted to {af.ul_xs.shape[1]} real sources "
        f"({af.ul_xs.shape[1] / af.n_leaf:.1f} a leaf; the padded slabs "
        f"held {af.n_leaf * af.u_cap * af.cap_s} slots), one launch an "
        f"apply, W/X pairs "
        f"{sum(len(w[0]) for w in af.wpairs.values())}, V pairs "
        f"{sum(int((v[0] >= 0).sum()) for v in af.vtab.values())}; "
        f"near pairs "
        f"{len(op.near_pairs)}, near matrices "
        f"{op._near_mats_dev.numel() * 4 / 2 ** 20:.1f} MiB; near engine s "
        + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in op._near_prof.items()))
    return lst, op


def _median_time(torch, fn, reps):
    times = []
    for rep in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(rep)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2], times


def phase_bie(torch, counters, kept=None):
    """5 (see the module docstring).  kept: where 11f's inputs go (the
    near pairs, a density and its apply, the right-hand side, the
    solution, the iterations, the two applies' spread, the peak device
    memory)."""
    import numpy as np
    from sctl_tpu_torch.kernel_cases import (rel_max_err, ulist_cases,
                                             ulist_main_work)
    from sctl_tpu_torch.linalg import gmres, gmres_device
    from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FxU,
                                    direct_eval_blocked)
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    torch.cuda.reset_peak_memory_stats()
    lst, op = _bie_setup(torch)
    af = op._far_fmm

    # the fifth kernel case: p2p_ulist at the far FMM's widths, the
    # float32 build also against float64, the float64 build at 1e-12
    cases = ulist_cases(af)
    crows = phase_kernels(torch, None, {
        k: v for k, v in cases.items() if "[" not in k}, f64_bar=DIRECT_BAR)
    crows.update(phase_kernels(torch, None, {
        k: v for k, v in cases.items() if "[" in k}))

    X, _, _ = lst.get_node_coord()
    src = np.array([[6.0, 0.0, 0.0]])
    qs = np.array([[1.0, -0.5, 0.8]])
    c64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    b = direct_eval_blocked(Stokes3D_FxU, c64(X), c64(src), c64(qs)) \
        .reshape(-1).float()

    def A(sig, marks=None):
        return (op.compute_potential_tensor(sig, marks).reshape(-1)
                - 0.5 * sig)

    reset(counters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sig0 = torch.randn(b.shape, generator=gen, device="cuda")
    A(sig0)                                                 # warm
    apply_s, apply_all = _median_time(
        torch, lambda rep: A(sig0 * (1.0 + 1e-6 * (rep + 1))), 5)
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    A(sig0, marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    log(f"bie apply: s {['%.4f' % x for x in apply_all]}, median "
        f"{apply_s:.4f} s; stage ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    a1, a2 = A(sig0), A(sig0)
    spread = float((a1 - a2).abs().max() / a1.abs().max())
    log(f"bie apply: two applies of one density differ by {spread:.3e} "
        f"of the max (the order of the card's atomic scatters)")
    n_apply = 9

    x, iters, err = gmres_device(A, b, tol=BIE_TOL, max_iter=BIE_MAX_ITER)
    n_apply += int(iters) + 1
    solves = []

    def solve(rep):
        r = gmres_device(A, b * (1.0 + 1e-6 * (rep + 1)), tol=BIE_TOL,
                         max_iter=BIE_MAX_ITER)
        solves.append(r)
    solve_s, solve_all = _median_time(torch, solve, 2)
    n_apply += sum(int(r[1]) + 1 for r in solves)
    resid_est = float(err) / float(torch.linalg.vector_norm(b))
    resid = float(torch.linalg.vector_norm(A(x) - b)
                  / torch.linalg.vector_norm(b))
    n_apply += 1
    log(f"bie solve: s {['%.3f' % t for t in solve_all]}, median "
        f"{solve_s:.3f} s; iterations {iters} (repeats "
        f"{[int(r[1]) for r in solves]}), residual {resid_est:.3e} as "
        f"returned, {resid:.3e} recomputed (bar {BIE_RESID_BAR:g})")

    # bench.py's host-loop baseline (:285-292): the host gmres, one
    # projection vector read back an Arnoldi step, on b (1 + 5e-7)
    bh = b * BIE_HOST_SCALE
    torch.cuda.synchronize()
    t = time.perf_counter()
    x_h, it_h = gmres(A, bh, tol=BIE_TOL, max_iter=BIE_MAX_ITER)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    resid_h = rel_resid(torch, A, x_h, bh)
    n_apply += it_h + 1
    log(f"bie host loop: gmres {host_s:.3f} s, {it_h} iterations, "
        f"residual {resid_h:.3e} recomputed (bar {BIE_RESID_BAR:g}); host "
        f"seconds / device-solve seconds {host_s / solve_s:.3f} (bench.py's "
        f"vs_baseline)")

    # the recycling legs (:313-346): GMRES(30) with 4 restarts collecting
    # one (U, Qt) pair a cycle on b, then a second right-hand side (the
    # Stokeslet at (0, 6, 0.5)) plain and with the stack as precond
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, it_r1, _, stack = gmres_device(
        A, b, tol=BIE_TOL, max_iter=BIE_RECYCLE_M,
        restarts=BIE_RECYCLE_RESTARTS, recycle=True)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t
    b2 = direct_eval_blocked(Stokes3D_FxU, c64(X), c64([BIE_SRC2]),
                             c64(qs)).reshape(-1).float()
    legs = {}
    for leg, pre in (("plain", None), ("recycled", stack)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x2, it2, err2 = gmres_device(A, b2, tol=BIE_TOL,
                                     max_iter=BIE_MAX_ITER, precond=pre)
        torch.cuda.synchronize()
        legs[leg] = dict(iterations=int(it2),
                         seconds=time.perf_counter() - t,
                         resid_returned=float(err2) / float(
                             torch.linalg.vector_norm(b2)),
                         resid=rel_resid(torch, A, x2, b2))
        n_apply += int(it2) + 2
    n_apply += it_r1 + 1
    log(f"bie recycling: recycle=True solve {rec_s:.3f} s, {it_r1} "
        f"iterations in cycles of {BIE_RECYCLE_M}, stack "
        f"{tuple(stack[0].shape)}; second right-hand side " + ", ".join(
            f"{k} {v['iterations']} iterations, {v['seconds']:.3f} s, "
            f"residual {v['resid_returned']:.3e} returned, "
            f"{v['resid']:.3e} recomputed" for k, v in legs.items())
        + f" (bar {BIE_RESID_BAR:g}; the JAX package's TPU record "
        f"[22, 29], BENCH_r05)")
    del stack
    launches = read(counters)
    baseline = dict(host_s=host_s, host_iterations=it_h,
                    host_resid=resid_h, vs_baseline=host_s / solve_s,
                    recycle_iterations=it_r1,
                    recycle_iters_second_rhs=[legs["plain"]["iterations"],
                                              legs["recycled"]["iterations"]],
                    recycle_resid_second_rhs=[legs["plain"]["resid"],
                                              legs["recycled"]["resid"]])

    interior = interior_error(torch, lst, op, x, src, qs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"bie check: interior rel err vs exact Stokeslet {interior:.3e} "
        f"(bar {BIE_INTERIOR_BAR:g}); peak device memory of the phase "
        f"{peak:.2f} GiB")

    # the U-list kernel alone on one apply's inputs, its launches in one
    # apply, and its output against its plain version in float64
    fp = af.pad_density(torch.randn((len(op.Xf), 3), generator=gen,
                                    device="cuda"))
    args = af.ulist_args(fp)
    ul_ms = cuda_ms(torch, lambda: p2p_ulist(af.ker_s2t, *args), 5)
    p2p_ulist.launches = 0
    A(sig0)
    per_apply = p2p_ulist.launches
    u64 = p2p_ulist_plain(af.ker_s2t, *[
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args])
    err64 = rel_max_err(p2p_ulist(af.ker_s2t, *args), u64)
    plain64 = rel_max_err(p2p_ulist_plain(af.ker_s2t, *args), u64)
    del u64
    work = ulist_main_work(af)
    b_ms, b_by = bound(work)
    jax_slots = (af.n_leaf * -(-af.cap_t // 8) * 8
                 * -(-af.u_cap * af.cap_s // 128) * 128)
    log(f"bie U list: p2p_ulist {ul_ms:.4f} ms per apply in {per_apply} "
        f"launch(es), the apply's U stage {stages['U']:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}, {ops_limit(work)}), needed pairs "
        f"{work['pairs']} (the JAX layout's padded slabs: {jax_slots} pair "
        f"slots), work {work} (bytes "
        f"{1e3 * work['bytes'] / HBM_BPS:.4f} ms, operations "
        f"{1e3 * work['pairs'] * work['pair_flops'] / F32_FLOPS:.4f} ms); "
        f"against its plain version in float64 {err64:.3e} (the float32 "
        f"plain version {plain64:.3e}, ratio {err64 / plain64:.2f}, bar "
        f"{ULIST_MAIN_RATIO:g}); launches in the "
        f"phase {launches['p2p_ulist']} over {n_apply} applies")
    # the cases hold 5e-6; on the apply's own near-surface double-layer
    # pairs float32 arithmetic itself reads about 6e-6 (the plain
    # version), so there the kernel is held to the plain version's error
    if per_apply != 1 or not err64 <= ULIST_MAIN_RATIO * plain64:
        raise SystemExit(f"chip_smoke: the BIE U list: {per_apply} "
                         f"launches an apply, float64 error {err64:.3e} "
                         f"(the float32 plain version {plain64:.3e})")
    if not (np.isfinite(resid) and resid <= BIE_RESID_BAR
            and np.isfinite(interior) and interior <= BIE_INTERIOR_BAR
            and int(iters) < BIE_MAX_ITER):
        raise SystemExit(f"chip_smoke: BIE solve failed: residual "
                         f"{resid:.3e}, interior {interior:.3e}, "
                         f"iterations {iters}")
    resids = [resid_h] + [v["resid"] for v in legs.values()]
    if not all(np.isfinite(r) and r <= BIE_RESID_BAR for r in resids):
        raise SystemExit(f"chip_smoke: BIE host-loop or recycling solve "
                         f"failed: residuals {resids}")
    if not launches["p2p_ulist"] > 0:
        raise SystemExit("chip_smoke: the BIE path did not launch "
                         "p2p_ulist")
    row = dict(crows["Stokes3D-DxU"])
    row.update(main_path_ms=ul_ms, main_path_bound_ms=b_ms,
               main_path_bound_by=b_by, main_path_ops_limit=ops_limit(work),
               launches_per_apply=per_apply, u_stage_ms=stages["U"],
               main_path_max_rel_err_f64=err64,
               main_path_plain_max_rel_err_f64=plain64,
               cases={k: dict(max_rel_err=v["max_rel_err"], ms=v["ms"],
                              plain_ms=v["plain_ms"],
                              bound_ms=v["bound_ms"])
                      for k, v in crows.items()})
    row["f64"] = dict(crows["Stokes3D-DxU[f64]"])
    if kept is not None:
        kept["bie"] = dict(
            pairs=np.asarray(op.near_pairs, np.int64).reshape(-1, 2),
            sig0=sig0.cpu().numpy(),
            u0=op.compute_potential_tensor(sig0).cpu().numpy(),
            b=b.cpu().numpy(), x=x.cpu().numpy(), iters=int(iters),
            spread=spread, peak_gib=peak)
    return launches, row, baseline, af._ops


def rel_resid(torch, A, x, b):
    """|A x - b| / |b|, recomputed with one more apply."""
    return float(torch.linalg.vector_norm(A(x) - b)
                 / torch.linalg.vector_norm(b))


def interior_error(torch, lst, op, x, src, qs, dl=None, sl=None):
    """bench.py's interior check: the double layer `dl` (default
    Stokes3D-DxU) of the solution, through its far-field quadrature in
    float64, at 16 points of a ring inside the torus, against the exact
    field of the sources through `sl` (default the Stokeslet) ->
    relative max error."""
    import numpy as np
    from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FxU,
                                    direct_eval_blocked)
    dl, sl = dl or Stokes3D_DxU, sl or Stokes3D_FxU
    c64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device="cuda")
    th = np.linspace(0, 2 * np.pi, 17)[:-1]
    xt_int = np.stack([(2.0 + 0.15 * np.cos(7 * th)) * np.cos(th),
                       (2.0 + 0.15 * np.cos(7 * th)) * np.sin(th),
                       0.15 * np.sin(7 * th)], 1)
    sigma = x.double().reshape(-1, dl.kdim0).cpu().numpy()
    Ff = lst.get_far_field_density(sigma) * op.wf[:, None]
    u_num = direct_eval_blocked(dl, c64(xt_int), c64(op.Xf),
                                c64(Ff), ns=c64(op.Xnf)).cpu().numpy()
    u_ex = direct_eval_blocked(sl, c64(xt_int), c64(src),
                               c64(qs)).cpu().numpy()
    return float(np.abs(u_num - u_ex).max() / np.abs(u_ex).max())


def phase_bie_f64(torch, counters, ops5):
    """5f: bench.py's bench_bie_f64 (:105-186) on the card in float64:
    the Stokes double layer on torus_patches(nu=16, nv=8, q=6), 13,824
    unknowns, quadrature tolerance 1e-6, the far field through the
    adaptive FMM (cutoff 15,000 far nodes) on phase 5's operator tables,
    solved by the host gmres to a 1e-10 relative residual."""
    import contextlib
    import io
    import numpy as np
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.kernel_cases import rel_max_err, ulist_main_work
    from sctl_tpu_torch.linalg import gmres
    from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FxU,
                                    direct_eval_blocked)
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    f64 = torch.float64
    reset(counters)
    p2p_ulist.launches_f64 = 0
    t = time.perf_counter()
    lst = torus_patches(nu=F64_NU, nv=F64_NV, q=6, R=2.0, r=0.5)
    op = BoundaryIntegralOp(Stokes3D_DxU, device="cuda", dtype=f64)
    op.set_accuracy(BIE_TOL)
    op.add_elem_list(lst)
    op.far_fmm_cutoff = F64_CUTOFF
    shared = (ops5.ker_trans.name == "Stokes3D-FSxU" and ops5.p == op.far_fmm_p
              and ops5.rcond == 1e-9)
    op.far_fmm_operators = ops5 if shared else None
    op.setup()
    setup_s = time.perf_counter() - t
    af = op._far_fmm
    if af is None or af.dtype != f64:
        raise SystemExit("chip_smoke: the float64 BIE far field did not "
                         "take the adaptive FMM in float64")
    log(f"bie f64 setup: {setup_s:.2f} s ("
        + ("phase 5's operator tables" if shared else
           "phase 5's tables are of another (kernel, p, rcond): built")
        + "); by stage s " + ", ".join(
            f"{k} {v:.2f}" for k, v in op.setup_times.items())
        + f"; unknowns {op.dim(0)}, far nodes {len(op.Xf)}, leaves "
        f"{af.n_leaf}, levels {af.L}, near pairs {len(op.near_pairs)}; "
        f"near engine s " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in op._near_prof.items()))

    X, _, _ = lst.get_node_coord()
    src = np.array([[6.0, 0.0, 0.0]])
    qs = np.array([[1.0, -0.5, 0.8]])
    c64 = lambda a: torch.as_tensor(a, dtype=f64, device="cuda")
    b = direct_eval_blocked(Stokes3D_FxU, c64(X), c64(src),
                            c64(qs)).reshape(-1)

    def A(sig):
        return op.compute_potential_tensor(sig).reshape(-1) - 0.5 * sig

    sig0 = torch.randn(b.shape, dtype=f64, device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(1))
    A(sig0)                                                 # warm
    apply_s, apply_all = _median_time(
        torch, lambda rep: A(sig0 * (1.0 + 1e-6 * (rep + 1))), 5)
    n64 = p2p_ulist.launches_f64
    A(sig0)
    per_apply = p2p_ulist.launches_f64 - n64

    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        x, iters = gmres(A, b, tol=F64_TOL, max_iter=F64_MAX_ITER,
                         verbose=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    last = out.getvalue().strip().splitlines()[-1]
    resid_est = float(last.split()[-1]) / float(torch.linalg.vector_norm(b))
    resid = rel_resid(torch, A, x, b)
    launches = read(counters)
    launches_f64 = p2p_ulist.launches_f64
    interior = interior_error(torch, lst, op, x, src, qs)
    log(f"bie f64: apply s {['%.4f' % a for a in apply_all]}, median "
        f"{apply_s:.4f} s; solve {solve_s:.3f} s, {iters} iterations "
        f"(host gmres to {F64_TOL:g}), residual {resid_est:.3e} as "
        f"returned (its last line '{last}'), {resid:.3e} recomputed (bar "
        f"{F64_RESID_BAR:g}); interior rel err vs exact Stokeslet "
        f"{interior:.3e} (bar {BIE_INTERIOR_BAR:g}); p2p_ulist float64 "
        f"launches {launches_f64} ({per_apply} an apply), p2p launches "
        f"{launches['p2p']}")

    # the float64 U-list kernel alone on one apply's inputs
    fp = af.pad_density(torch.randn((len(op.Xf), 3), dtype=f64,
                                    device="cuda"))
    args = af.ulist_args(fp)
    ul_ms = cuda_ms(torch, lambda: p2p_ulist(af.ker_s2t, *args), 10)
    plain_ms = cuda_ms(torch, lambda: p2p_ulist_plain(af.ker_s2t, *args), 3)
    out_k = p2p_ulist(af.ker_s2t, *args)
    ref = p2p_ulist_plain(af.ker_s2t, *args)
    err = rel_max_err(out_k, ref)
    abs_err = float((out_k - ref).abs().max())
    work = ulist_main_work(af)
    b_ms, b_by = bound(work)
    floor = issue_floor("p2p_ulist", "p2p_ulist_kernelIdLi4E",
                        work["pairs"], "bie f64", f64=True) or {}
    log(f"bie f64 U list: p2p_ulist float64 {ul_ms:.4f} ms per apply, "
        f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: operations "
        f"{1e3 * work['pairs'] * work['pair_flops'] / F64_FLOPS:.4f} ms at "
        f"34 TFLOP/s, bytes {1e3 * work['bytes'] / HBM_BPS:.4f} ms), pairs "
        f"{work['pairs']}; against its plain version in float64 {err:.3e} "
        f"(bar {ORACLE_BAR:g})")
    del fp, args, out_k, ref
    if not (np.isfinite(resid) and resid <= F64_RESID_BAR
            and np.isfinite(resid_est) and resid_est <= F64_TOL
            and np.isfinite(interior) and interior <= BIE_INTERIOR_BAR
            and iters < F64_MAX_ITER):
        raise SystemExit(f"chip_smoke: float64 BIE solve failed: residual "
                         f"{resid:.3e} ({resid_est:.3e} returned), interior "
                         f"{interior:.3e}, iterations {iters}")
    if not (per_apply >= 1 and launches_f64 >= iters + 1
            and err < ORACLE_BAR):
        raise SystemExit(f"chip_smoke: float64 BIE U list: {per_apply} "
                         f"launches an apply, {launches_f64} in the phase, "
                         f"error {err:.3e}")
    row = dict(main_path_ms=ul_ms, main_path_plain_ms=plain_ms,
               main_path_bound_ms=b_ms, main_path_bound_by=b_by,
               main_path_max_rel_err=err, main_path_max_abs_err=abs_err,
               launches=launches_f64, launches_per_apply=per_apply,
               pairs=work["pairs"], **floor)
    summary = dict(setup_s=setup_s, setup_by_stage=op.setup_times,
                   near_engine=op._near_prof,
                   shared_tables=shared, apply_s=apply_s, solve_s=solve_s,
                   iterations=iters, resid_returned=resid_est,
                   resid=resid, interior=interior, unknowns=op.dim(0))
    return launches, row, summary


def _stage_ms(torch, fn):
    """CUDA-event milliseconds of each stage fn(marks) records."""
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    return stages


def phase_bie_laplace(torch, counters, smi):
    """5L: the Laplace double-layer BIE at bench_bie's width: the
    interior Dirichlet problem (tests/test_bie.py:89-124) on
    torus_patches(nu=48, nv=20, q=6), 34,560 unknowns, float32, the
    device near engine, the far field through the adaptive FMM (cold
    Laplace tables, p=6), A(s) = D s - s/2, boundary data of a unit
    charge at phase 5's Stokeslet position, gmres_device to 1e-6."""
    import numpy as np
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.kernel_cases import rel_max_err, ulist_main_work
    from sctl_tpu_torch.linalg import gmres_device
    from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU,
                                    direct_eval_blocked)
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    reset(counters)
    t = time.perf_counter()
    lst = torus_patches(nu=48, nv=20, q=6, R=2.0, r=0.5)
    op = BoundaryIntegralOp(Laplace3D_DxU, device="cuda",
                            dtype=torch.float32)
    op.set_accuracy(BIE_TOL)
    op.add_elem_list(lst)
    op.setup()
    setup_s = time.perf_counter() - t
    af = op._far_fmm
    if af is None or op._near_mats_dev is None:
        raise SystemExit("chip_smoke: the Laplace BIE did not take the "
                         "adaptive FMM and the device near engine")
    log(f"bie laplace setup: {setup_s:.2f} s; by stage s " + ", ".join(
        f"{k} {v:.2f}" for k, v in op.setup_times.items())
        + f"; unknowns {op.dim(0)}, far nodes {len(op.Xf)}, leaves "
        f"{af.n_leaf}, levels {af.L}, near pairs {len(op.near_pairs)}, "
        f"fallback pairs {op._near_fallback_count}; near engine s "
        + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in op._near_prof.items()) + f"; on '{smi}'")

    X, _, _ = lst.get_node_coord()
    src, qs = np.array([BIE_SRC2]), np.ones((1, 1))
    c64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    b = direct_eval_blocked(Laplace3D_FxU, c64(X), c64(src),
                            c64(qs)).reshape(-1).float()

    def A(sig, marks=None):
        return (op.compute_potential_tensor(sig, marks).reshape(-1)
                - 0.5 * sig)

    gen = torch.Generator(device="cuda").manual_seed(5)
    sig0 = torch.randn(b.shape, generator=gen, device="cuda")
    A(sig0)                                                 # warm
    apply_s, apply_all = _median_time(
        torch, lambda rep: A(sig0 * (1.0 + 1e-6 * (rep + 1))), 5)
    stages = _stage_ms(torch, lambda marks: A(sig0, marks))
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, iters, err = gmres_device(A, b, tol=BIE_TOL, max_iter=BIE_MAX_ITER)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    resid = rel_resid(torch, A, x, b)
    launches = read(counters)
    interior = interior_error(torch, lst, op, x, src, qs, Laplace3D_DxU,
                              Laplace3D_FxU)
    log(f"bie laplace: apply s {['%.4f' % a for a in apply_all]}, median "
        f"{apply_s:.4f} s; stage ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items())
        + f"; solve {solve_s:.3f} s, {iters} iterations, residual "
        f"{float(err) / float(torch.linalg.vector_norm(b)):.3e} returned, "
        f"{resid:.3e} recomputed (bar {BIE_RESID_BAR:g}); interior rel err "
        f"vs the exact potential {interior:.3e} (bar "
        f"{BIE_INTERIOR_BAR:g}); launches {launches}; on '{smi}'")

    # the U-list kernel (the Laplace3D-DxU formula) on one apply's inputs
    fp = af.pad_density(torch.randn((len(op.Xf), 1), generator=gen,
                                    device="cuda"))
    args = af.ulist_args(fp)
    ul_ms = cuda_ms(torch, lambda: p2p_ulist(af.ker_s2t, *args), 10)
    plain_ms = cuda_ms(torch, lambda: p2p_ulist_plain(af.ker_s2t, *args), 3)
    p2p_ulist.launches = 0
    A(sig0)
    per_apply = p2p_ulist.launches
    u64 = p2p_ulist_plain(af.ker_s2t, *[
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args])
    err64 = rel_max_err(p2p_ulist(af.ker_s2t, *args), u64)
    plain64 = rel_max_err(p2p_ulist_plain(af.ker_s2t, *args), u64)
    del u64, fp, args
    work = ulist_main_work(af)
    b_ms, b_by = bound(work)
    log(f"bie laplace U list: p2p_ulist[{af.ker_s2t.name}] {ul_ms:.4f} ms "
        f"per apply in {per_apply} launch(es), plain {plain_ms:.4f} ms, the "
        f"apply's U stage {stages['U']:.3f} ms; bound {b_ms:.4f} ms "
        f"({b_by}, {ops_limit(work)}), pairs {work['pairs']}; against its "
        f"plain version in float64 {err64:.3e} (the float32 plain version "
        f"{plain64:.3e}, bar twice that); on '{smi}'")
    if not (per_apply == 1 and err64 <= 2 * plain64):
        raise SystemExit(f"chip_smoke: the Laplace BIE U list: {per_apply} "
                         f"launches an apply, float64 error {err64:.3e} "
                         f"(plain {plain64:.3e})")
    if not (int(iters) < BIE_MAX_ITER and np.isfinite(resid)
            and resid <= BIE_RESID_BAR and np.isfinite(interior)
            and interior <= BIE_INTERIOR_BAR):
        raise SystemExit(f"chip_smoke: the Laplace BIE solve failed: "
                         f"{iters} iterations, residual {resid:.3e}, "
                         f"interior {interior:.3e}")
    if not (launches["p2p_ulist"] > 0 and launches["p2p"] > 0):
        raise SystemExit(f"chip_smoke: the Laplace BIE path did not launch "
                         f"p2p_ulist and p2p: {launches}")
    summary = dict(setup_s=setup_s, setup_by_stage=op.setup_times,
                   near_engine=op._near_prof, apply_s=apply_s,
                   apply_stages_ms=stages, solve_s=solve_s,
                   iterations=int(iters), resid=resid, interior=interior,
                   unknowns=op.dim(0), ulist_ms=ul_ms, ulist_plain_ms=plain_ms,
                   ulist_bound_ms=b_ms, ulist_pairs=work["pairs"],
                   ulist_err64=err64, ulist_plain_err64=plain64,
                   ulist_per_apply=per_apply)
    return launches, summary, af._ops


def phase_bie_host(torch, counters, smi):
    """5h: the host near path on the card: torus_patches(nu=12, nv=6,
    q=6), Laplace3D-DxU, tol 1e-6, float32: the device engine and the
    host path on one geometry, the near cache read back by an op over a
    bare ParametricPatchList (no device_geom)."""
    import os
    import tempfile
    import warnings
    import numpy as np
    from sctl_tpu_torch.bie import (BoundaryIntegralOp, ParametricPatchList,
                                    torus_patches)
    from sctl_tpu_torch.ops import Laplace3D_DxU
    reset(counters)
    lst = torus_patches(nu=HOST_NU, nv=HOST_NV, q=6, R=2.0, r=0.5)
    bare = ParametricPatchList(lst.charts, q=6,
                               surface_batch=lst._surface_batch)

    def make(elems, **attrs):
        op = BoundaryIntegralOp(Laplace3D_DxU, device="cuda",
                                dtype=torch.float32)
        op.set_accuracy(BIE_TOL)
        op.add_elem_list(elems)
        for k, v in attrs.items():
            setattr(op, k, v)
        t = time.perf_counter()
        op.setup()
        return op, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "near.npz")
        dev_op, dev_s = make(lst)
        host_op, host_s = make(lst, use_device_near=False, near_cache=path)
        bare_op, bare_s = make(bare, near_cache=path)
    sig = torch.randn(dev_op.dim(0), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(6))
    u_dev = dev_op.compute_potential_tensor(sig)
    u_host = host_op.compute_potential_tensor(sig)
    agree = float((u_dev - u_host).abs().max() / u_host.abs().max())
    # the scatter of the near corrections in its deterministic form for
    # the bit-for-bit comparison (index_add_ on the card sums atomically)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            bit_equal = torch.equal(host_op.compute_potential_tensor(sig),
                                    bare_op.compute_potential_tensor(sig))
        finally:
            torch.use_deterministic_algorithms(False)
    launches = read(counters)
    log(f"bie host: torus {HOST_NU} x {HOST_NV}, {dev_op.dim(0)} unknowns, "
        f"near pairs {len(dev_op.near_pairs)} (device engine) and "
        f"{len(host_op.near_pairs)} (host path); setup s: device engine "
        f"{dev_s:.2f} (near stages "
        f"{dev_op.setup_times['near_assembly']:.2f}, fallback pairs "
        f"{dev_op._near_fallback_count}), host path {host_s:.2f} (near "
        f"stages {host_op.setup_times['near_assembly']:.2f}: "
        + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in host_op._near_prof.items())
        + f"), the bare list from the near cache {bare_s:.2f} (cache read "
        f"{bare_op.setup_times.get('near_cache', float('nan')):.2f}); "
        f"applies of one density: device engine vs host path {agree:.3e} of "
        f"the max (bar {30 * BIE_TOL:g}), host path vs cached bare list "
        f"bit for bit {bit_equal}; launches {launches}; on '{smi}'")
    ok = (dev_op._near_mats_dev is not None
          and host_op._near_mats_dev is None
          and dev_op.near_pairs == host_op.near_pairs
          and not bare_op._device_near_ok()
          and "near_cache" in bare_op.setup_times
          and "near_assembly" not in bare_op.setup_times
          and np.isfinite(agree) and agree <= 30 * BIE_TOL and bit_equal
          and launches["p2p"] > 0)
    if not ok:
        raise SystemExit("chip_smoke: the host near path phase failed")
    summary = dict(unknowns=dev_op.dim(0), near_pairs=len(dev_op.near_pairs),
                   device_engine_setup_s=dev_s, host_path_setup_s=host_s,
                   cached_setup_s=bare_s,
                   device_engine_near_s=dev_op.setup_times["near_assembly"],
                   host_path_near_s=host_op.setup_times["near_assembly"],
                   fallback=[dev_op._near_fallback_count,
                             host_op._near_fallback_count],
                   agree=agree, bit_equal=bit_equal)
    return launches, summary


def _legacy_leg(torch, q64, Xt, rng, setup_s, smi, name):
    """One kernel of 5q: its Gauss identity, eval ms on the card, and
    the card's evals against the CPU's on the same setup: float64 both
    ways; float32 against the float64 CPU eval off the surface, against
    the float32 CPU eval on it."""
    import numpy as np
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    n_e, k0 = q64.elems.n_elem, q64.ker.kdim0
    size = q64.elems.basis.size
    q32 = q64.to("cuda", torch.float32)
    qcpu, qcpu32 = (q64.to("cpu", dt) for dt in (torch.float64,
                                                  torch.float32))
    if k0 == 3:
        u0 = np.array([0.3, -1.1, 0.7])
        dens = np.broadcast_to(u0, (n_e, size, 3)).copy()
        ident = float(np.abs(q64.eval(dens) + 0.5 * u0).max()
                      / np.abs(u0).max())
        ident_bar = 5e-3
    else:
        u = q64.eval(np.ones((n_e, size, 1)))[:, 0]
        exact = -0.5 if Xt is None else np.array([-1.0, -1.0, -1.0, 0.0])
        ident = float(np.abs(u - exact).max())
        ident_bar = 2e-4
    sig = rng.normal(size=(n_e, size, k0))
    d = torch.as_tensor(sig, device="cuda")
    eval_ms = cuda_ms(torch, lambda: q64.eval_tensor(d), 5)
    eval32_ms = cuda_ms(torch, lambda: q32.eval_tensor(d), 5)
    ref, ref32 = qcpu.eval(sig), qcpu32.eval(sig)
    u32 = q32.eval(sig)
    e64, gap32, cpu_gap32 = rel(q64.eval(sig), ref), rel(u32, ref), \
        rel(ref32, ref)
    # on the surface float32 itself is 1e-2 from float64 (the far sum's
    # sources lie a fraction of a node spacing from its targets: r . n
    # cancels), so there the card's float32 eval is held to the CPU's
    e32, bar32 = ((gap32, LEGACY_F32_BAR) if Xt is not None
                  else (rel(u32, ref32), LEGACY_F32_SURFACE_BAR))
    ok = bool(ident <= ident_bar and e64 <= 1e-12 and e32 <= bar32
              and np.isfinite([ident, e64, e32]).all())
    log(f"legacy {name}: eval ms float64 {eval_ms:.4f}, float32 "
        f"{eval32_ms:.4f}; Gauss identity {ident:.3e} (bar {ident_bar:g}); "
        f"card float64 against the float64 CPU eval {e64:.3e} (bar 1e-12); "
        f"card float32 against the "
        f"{'float64' if Xt is not None else 'float32'} CPU eval {e32:.3e} "
        f"(bar {bar32:g}); float32 from float64: card {gap32:.3e}, "
        f"CPU {cpu_gap32:.3e}; on '{smi}'")
    return dict(setup_s=setup_s, pairs=len(q64._pairs), identity=ident,
                identity_bar=ident_bar, eval_ms_f64=eval_ms,
                eval_ms_f32=eval32_ms, err_f64=e64, err_f32=e32,
                f32_from_f64=gap32, f32_from_f64_cpu=cpu_gap32,
                bar_f32=bar32, ok=ok)


def phase_legacy(torch, counters, smi):
    """5q: LegacyQuadrature on the card: 24 elements of order 8 on
    sphere_patches(n_per_face=2), order_singular 12, order_direct 8,
    set up on the card in float64 (the Duffy blocks there, the rest on
    the host); the Gauss identities of tests/test_legacy_quadrature.py
    (Laplace on the surface and at near and deep targets, 2e-4; the
    Stokes double layer of a rigid translation, 5e-3); eval on the card
    in float64 and float32 against the CPU's on the same setup."""
    import numpy as np
    from sctl_tpu_torch.bie import (BasisElemList, LegacyQuadrature,
                                    sphere_patches)
    from sctl_tpu_torch.ops import Laplace3D_DxU, Stokes3D_DxU
    elems = BasisElemList.discretize(8, sphere_patches(n_per_face=2,
                                                       q=6).charts)
    xt = np.array([[0.0, 0.0, 0.9], [0.55, 0.55, 0.55], [0.0, 0.0, 0.2],
                   [0.0, 1.4, 0.0]])
    rng = np.random.default_rng(9)
    reset(counters)
    legs, ok = {}, True
    for Xt, ker in ((None, Laplace3D_DxU), (None, Stokes3D_DxU),
                    (xt, Laplace3D_DxU)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        q64 = LegacyQuadrature(ker, elems, 12, 8, device="cuda",
                               dtype=torch.float64).setup(Xt)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        name = (ker.name.split("3D")[0].lower()
                + ("_surface" if Xt is None else "_targets"))
        log(f"legacy setup {name}: {ker.name} "
            f"{'on the surface' if Xt is None else 'at 4 targets'}: "
            f"{setup_s:.2f} s (the Duffy blocks on the card in float64), "
            f"near pairs {len(q64._pairs)}; on '{smi}'")
        legs[name] = _legacy_leg(torch, q64, Xt, rng, setup_s, smi, name)
        ok &= legs[name].pop("ok")
    launches = read(counters)
    log(f"legacy: launches {launches} (the evals on the card: identities, "
        f"timings, comparisons); on '{smi}'")
    if not (ok and launches["p2p"] > 0):
        raise SystemExit(f"chip_smoke: the legacy quadrature phase failed: "
                         f"{legs}")
    return launches, legs


def _sample_err(u, u_ref):
    """max |u - u_ref| / max |u_ref| of two (n, k) arrays."""
    import numpy as np
    return float(np.abs(u - u_ref).max() / np.abs(u_ref).max())


def phase_direct(torch, counters):
    """6a: ParticleFMM's direct path for every kernel, through p2p."""
    import numpy as np
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.kernel_cases import P2P_S, P2P_T, p2p_cases
    from sctl_tpu_torch.ops import KERNELS, direct_eval_blocked
    from sctl_tpu_torch.ops.p2p import p2p_layout, p2p_plain
    rng = np.random.default_rng(3)
    x = rng.random((DIRECT_N, 3))
    nrm = rng.normal(size=(DIRECT_N, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = rng.choice(DIRECT_N, N_SAMPLE, replace=False)
    # the float64 p2p reads the float32 run's inputs, so the two differ
    # by the float32 arithmetic alone, not by the rounding of points a
    # few 1e-4 apart
    c64 = lambda a: torch.as_tensor(np.float32(a), device="cuda").double()
    x64, n64 = c64(x), c64(nrm)
    total = {k: 0 for k in counters}
    for name, ker in KERNELS.items():
        f = rng.normal(size=(DIRECT_N, ker.kdim0))
        ns = nrm if ker.needs_normal else None
        fmm = ParticleFMM(accuracy=P, device="cuda", dtype=torch.float32)
        fmm.set_kernel_s2t("src", "trg", ker)
        fmm.set_src_coord("src", x, normal=ns)
        fmm.set_src_density("src", f)
        fmm.set_trg_coord("trg", x)
        reset(counters)
        t = time.perf_counter()
        u = fmm.eval("trg")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read(counters)
        for k, v in launches.items():
            total[k] += v
        ns64 = n64 if ker.needs_normal else None
        u64 = direct_eval_blocked(ker, x64[idx], x64, c64(f), ns=ns64)
        u_plain = p2p_plain(ker, x64[idx], x64, ns64, c64(f)) \
            * ker.scale_factor
        err32 = _sample_err(u[idx], u64.cpu().numpy())
        err64 = float((u64 - u_plain).abs().max() / u_plain.abs().max())
        log(f"direct {name}: {DIRECT_N} points, eval {secs:.4f} s, "
            f"float32 p2p vs float64 p2p at {N_SAMPLE} targets {err32:.3e}"
            f" (bar {DIRECT_BAR:g}), float64 p2p vs its plain version "
            f"{err64:.3e} (bar {ORACLE_BAR:g}); launches {launches}")
        if not (launches["p2p"] == 1 and np.isfinite(err32)
                and err32 < DIRECT_BAR and err64 < ORACLE_BAR):
            raise SystemExit(f"chip_smoke: direct path of {name} failed: "
                             f"{err32:.3e}, {err64:.3e}, {launches}")
        if name == "Stokes3D-DxU":
            eval_tensor_check(torch, fmm, {"src": f}, u, f"direct {name}")
    log("direct: p2p's block a formula, float32 / float64: " + ", ".join(
        f"{name} " + " / ".join(
            "{targets_per_thread} targets a thread x {threads}, "
            "{blocks_per_sm} blocks an SM".format(
                **p2p_layout(ker, dt, "cuda"))
            for dt in (torch.float32, torch.float64))
        for name, ker in KERNELS.items()))
    crows = phase_kernels(torch, None, p2p_cases("cuda"))
    row = dict(crows[P2P_CASE])
    lay = p2p_layout(KERNELS["Stokes3D-FxU"], torch.float32, "cuda")
    row.update(blocks_per_sm=lay["blocks_per_sm"],
               targets_per_thread=lay["targets_per_thread"],
               **{"case_" + k: v for k, v in (issue_floor(
                   "p2p", "p2p_direct_kernelIfLi3E", P2P_T * P2P_S,
                   "direct") or {}).items()})
    row["cases"] = {k: dict(max_rel_err=v["max_rel_err"], ms=v["ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                            bound_by=v["bound_by"])
                    for k, v in crows.items()}
    return total, row


def _tree_kernels_launched(kf, launches):
    """The kernels the set-up KIFMM's routes take must have launched."""
    from sctl_tpu_torch.kernel_cases import m2l_kernel, near_kernel
    need = (["surface_pair", "l2t_surface"] if kf.surface_route
            else ["p2p_ulist"])
    need += [near_kernel(kf)] + [k for k in [m2l_kernel(kf)] if k]
    return all(launches[k] > 0 for k in need)


def build_in_background(fn, *args):
    """fn(*args) in a thread of its own, started now -> a future of
    (host seconds, the perf_counter time it ended)."""
    from concurrent.futures import ThreadPoolExecutor

    def timed():
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t, time.perf_counter()

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(timed)
    pool.shutdown(wait=False)
    return fut


def phase_tree(torch, counters, tables):
    """6b: ParticleFMM's tree path for the four other tree kernels.
    `tables`: the future of its cold Stokes table build, which runs in
    the background from phase 5f's setup on (the host float64 SVDs of
    the table use the cores that 5f's per-pair host rule leaves idle)."""
    import numpy as np
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.ops import KERNELS, direct_eval_blocked
    t = time.perf_counter()
    build_s, ended = tables.result()
    log(f"tree: cold Stokes3D-FSxU table build (p={P}, rcond 3e-5) "
        f"{build_s:.2f} s in the background from phase 5f on, ended at "
        f"{ended - T0:.1f} s; 6b waited {time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(4)
    x = rng.random((TREE_N, 3))
    nrm = rng.normal(size=(TREE_N, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = rng.choice(TREE_N, N_SAMPLE, replace=False)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    x64, n64 = c64(x), c64(nrm)
    total = {k: 0 for k in counters}
    for name in ("Laplace3D-DxU", "Laplace3D-FxdU", "Stokes3D-DxU",
                 "Stokes3D-FSxU"):
        ker = KERNELS[name]
        f = rng.normal(size=(TREE_N, ker.kdim0))
        fmm = ParticleFMM(accuracy=P, device="cuda", dtype=torch.float32)
        fmm.set_kernel_s2t("src", "trg", ker)
        fmm.set_src_coord("src", x,
                          normal=nrm if ker.needs_normal else None)
        fmm.set_src_density("src", f)
        fmm.set_trg_coord("trg", x)
        reset(counters)
        t = time.perf_counter()
        u = fmm.eval("trg")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read(counters)
        for k, v in launches.items():
            total[k] += v
        kf = next(iter(fmm._kifmm_cache.values()))
        u64 = direct_eval_blocked(ker, x64[idx], x64, c64(f),
                                  ns=n64 if ker.needs_normal else None)
        err = _sample_err(u[idx], u64.cpu().numpy())
        log(f"tree {name}: {TREE_N} points, depth {kf.depth}, cap_s "
            f"{kf.cap_s}, cap_t {kf.cap_t}, routes "
            f"{'surface' if kf.surface_route else 'ulist'}/"
            f"{kf.near_route}/M2L {kf._ops.m2l_route}; setup and eval "
            f"{secs:.2f} s; rel err at "
            f"{N_SAMPLE} targets vs float64 p2p {err:.3e} (bar "
            f"{FMM_BAR:g}); launches {launches}")
        if not (np.isfinite(err) and err < FMM_BAR and launches["p2p"] == 0
                and _tree_kernels_launched(kf, launches)):
            raise SystemExit(f"chip_smoke: tree path of {name} failed: "
                             f"{err:.3e}, {launches}")
    return total


def m2l_routes_at(torch, kf, lvl, ways):
    """The M2L of the set-up KIFMM at level `lvl` on one random grid in
    each of `ways`, the first the route: "grid" (m2l_grid), "blocked"
    (the blocked kernel), "sweep" (the per-parity sweep), each at the
    capped ranks, and "sweep exact" (the sweep at the exact ranks) ->
    {label: (ms, relative difference from the first)}.  A blocked stack
    the route lacks is built for this and freed."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops.m2l import blocked_m2l_mats, blocked_operands
    ops = kf._ops
    nd = ops.n_surf * ops.k0t
    n = 1 << lvl
    h = n // 2
    r, r2 = ops.m2l_a.shape[1:]
    cr, cr2 = ops.blk_r, ops.blk_r2
    q = torch.randn((n, n, n, nd), device=kf.device)
    own = ops.m2l_blk, ops.m2l_blk_tc
    if "blocked" in ways and own[0] is None:
        ops.m2l_blk = torch.as_tensor(blocked_m2l_mats(
            ops.ca_unit, ops.offsets, ops.parity_valid, cr, cr2),
            dtype=torch.float32, device=kf.device)
        ops.m2l_blk_tc = blocked_operands(ops.m2l_blk)
    fns = {"grid": (f"m2l_grid at capped ranks {cr}/{cr2}",
                    lambda: kf._m2l_grid(q)),
           "blocked": (f"blocked kernel at capped ranks {cr}/{cr2}",
                       lambda: kf._m2l_blocked(q, h)),
           "sweep": (f"sweep at capped ranks {cr}/{cr2}",
                     lambda: kf._m2l_parity_sweep(q, h, cr, cr2)),
           "sweep exact": (f"sweep at exact ranks {r}/{r2}",
                           lambda: kf._m2l_parity_sweep(q, h, r, r2))}
    ref = fns[ways[0]][1]().reshape(-1, nd)
    out = {}
    for way in ways:
        label, fn = fns[way]
        diff = rel_max_err(fn().reshape(-1, nd), ref)
        out[label] = (cuda_ms(torch, fn, 2), diff)
    ops.m2l_blk, ops.m2l_blk_tc = own
    del ref
    torch.cuda.empty_cache()
    return out


def _evals(torch, kf, f_dev, label):
    """Median seconds of 3 evaluations with fresh densities, each fenced
    by synchronize, then one evaluation's stage ms from CUDA events and
    one profiled evaluation."""
    times = []
    for rep in range(3):
        f2 = f_dev * (1.0 + 1e-6 * (rep + 1))      # fresh densities
        torch.cuda.synchronize()
        t = time.perf_counter()
        kf.eval_tensor(f2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = sorted(times)[1]
    log(f"{label}: KIFMM.eval_tensor s {['%.4f' % s for s in times]}, "
        f"median {med:.4f} s, {f_dev.shape[0] / med / 1e6:.2f} Mpts/s")
    fp, fo = kf.pad_density(f_dev)
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    kf._eval_impl(fp, fo, marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    log(f"{label}: stage ms " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in stages.items()))
    profile_eval(torch, kf, fp, fo, med)
    return med, stages


def _describe(kf):
    return (f"depth {kf.depth}, boxes {kf.src_tree.n_boxes}, cap_s "
            f"{kf.cap_s}, cap_t {kf.cap_t}, overflow sources {kf.n_ovf_s}"
            f" targets {kf.n_ovf_t}, routes "
            f"{'surface' if kf.surface_route else 'ulist'}/"
            f"{kf.near_route}/M2L {kf._ops.m2l_route} at ranks "
            f"{kf._ops.blk_r}/{kf._ops.blk_r2}")


def stokes_depths(torch, ops):
    """The Stokeslet's error against size and depth: 4,000 points at
    depth 3 (the JAX package's CPU measurement's shape), then
    STOKES_DEPTH_N points at depths 3 to 6, from default_rng(5), each
    against the float64 p2p at up to 1000 sampled targets."""
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.ops import Stokes3D_FxU, direct_eval_blocked
    rng = np.random.default_rng(5)
    c64 = lambda a: torch.as_tensor(a, device="cuda")
    for n, depths in ((4000, (3,)),
                      (STOKES_DEPTH_N, range(3, DEPTH + 1))):
        x = rng.random((n, 3))
        f = rng.normal(size=(n, 3))
        idx = rng.choice(n, N_SAMPLE, replace=False)
        u_ref = direct_eval_blocked(Stokes3D_FxU, c64(x[idx]), c64(x),
                                    c64(f)).cpu().numpy()
        for depth in depths:
            kf = KIFMM(Stokes3D_FxU, p=P, depth=depth, device="cuda",
                       dtype=torch.float32, operators=ops).setup(x, x)
            err = _sample_err(kf.eval(f)[idx], u_ref)
            log(f"stokes depths: {n} points, depth {depth} ({kf.cap_s} "
                f"source slots a box), rel err at {N_SAMPLE} sampled "
                f"targets vs float64 p2p {err:.3e} (bar {FMM_BAR:g})")
            if not np.isfinite(err) or not err < FMM_BAR:
                raise SystemExit(f"chip_smoke: Stokes KIFMM at {n} points"
                                 f", depth {depth}: error {err:.3e}")
            del kf
            torch.cuda.empty_cache()


def phase_stokes(torch, counters):
    """6c: the Stokeslet at 1e7 points through ParticleFMM at its
    defaults, then KIFMM at bench_fmm's depth 6 on the same data."""
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM, ParticleFMM
    from sctl_tpu_torch.kernel_cases import p2p_work
    from sctl_tpu_torch.ops import Stokes3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.ops._launch_checks import n_sms
    from sctl_tpu_torch.ops.p2p import p2p_grid, p2p_layout, to_halo
    rng = np.random.default_rng(2)
    x = rng.random((STOKES_N, 3))
    f = rng.normal(size=(STOKES_N, 3))
    idx = rng.choice(STOKES_N, N_SAMPLE, replace=False)
    x64 = torch.as_tensor(x, device="cuda")
    f64 = torch.as_tensor(f, device="cuda")
    oracle = lambda: direct_eval_blocked(Stokes3D_FxU, x64[idx], x64, f64)
    u_ref = oracle().cpu().numpy()
    oracle_ms = cuda_ms(torch, oracle, 3)
    work = p2p_work(Stokes3D_FxU, torch.float64, N_SAMPLE, STOKES_N)
    b_ms, b_by = bound(work)
    lay = p2p_layout(Stokes3D_FxU, torch.float64, "cuda")
    nsplit, _ = p2p_grid(N_SAMPLE, STOKES_N,
                         lay["threads"] * lay["targets_per_thread"],
                         lay["tile"], lay["blocks_per_sm"] * n_sms("cuda"))
    log(f"stokes: the float64 p2p oracle ({N_SAMPLE} x {STOKES_N}) "
        f"{oracle_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); "
        f"{lay['targets_per_thread']} targets a thread x {lay['threads']}, "
        f"{lay['blocks_per_sm']} blocks an SM, {nsplit} source splits")
    oracle_row = dict(main_path_ms=oracle_ms, main_path_bound_ms=b_ms,
                      main_path_bound_by=b_by,
                      blocks_per_sm=lay["blocks_per_sm"],
                      targets_per_thread=lay["targets_per_thread"],
                      **(issue_floor("p2p", "p2p_direct_kernelIdLi3E",
                                     work["pairs"], "stokes", f64=True)
                         or {}))
    del x64, f64
    f_dev = torch.as_tensor(f, dtype=torch.float32, device="cuda")

    def check(label, kf, u, launches):
        err = _sample_err(u[idx], u_ref)
        log(f"{label}: rel err at {N_SAMPLE} sampled targets vs float64 "
            f"p2p {err:.3e} (bar {FMM_BAR:g}); launches {launches}")
        if not np.isfinite(err) or not err < FMM_BAR:
            raise SystemExit(f"chip_smoke: {label} error {err:.3e}")
        if launches["p2p"] or not _tree_kernels_launched(kf, launches):
            raise SystemExit(f"chip_smoke: {label}: a kernel of the path "
                             f"was not launched: {launches}")
        return err

    # the facade at its defaults, as a user calls it
    fmm = ParticleFMM(accuracy=P, device="cuda", dtype=torch.float32)
    fmm.set_kernel_s2t("src", "trg", Stokes3D_FxU)
    fmm.set_src_coord("src", x)
    fmm.set_src_density("src", f)
    fmm.set_trg_coord("trg", x)
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t = time.perf_counter()
    kf = fmm._get_kifmm(Stokes3D_FxU, x, fmm.src["src"], "src", "trg")
    torch.cuda.synchronize()
    log(f"stokes facade setup: {time.perf_counter() - t:.2f} s "
        f"({_describe(kf)})")
    t = time.perf_counter()
    u = fmm.eval("trg")
    log(f"stokes facade: ParticleFMM.eval {time.perf_counter() - t:.4f} s"
        f" (host arrays in and out)")
    _evals(torch, kf, f_dev, "stokes facade")
    launches = read(counters)
    st6c = None
    if kf.near_route == "stencil":
        fp, _ = kf.pad_density(f_dev)
        st6c = stencil_times(torch, kf, to_halo(fp, kf.rast_to_mort,
                                                1 << kf.depth),
                             "stokes facade")
        del fp
    log(f"stokes facade: peak device memory of setup and evaluations "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check("stokes facade", kf, u, launches)
    ops = kf._ops
    del fmm, kf, u
    torch.cuda.empty_cache()

    # bench_fmm's shape, depth 6, through KIFMM directly
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t = time.perf_counter()
    kf = KIFMM(Stokes3D_FxU, p=P, depth=DEPTH, device="cuda",
               dtype=torch.float32, operators=ops).setup(x, x)
    torch.cuda.synchronize()
    log(f"stokes depth {DEPTH} setup: {time.perf_counter() - t:.2f} s "
        f"({_describe(kf)})")
    u = kf.eval_tensor(f_dev).cpu().numpy()
    _evals(torch, kf, f_dev, f"stokes depth {DEPTH}")
    l6 = read(counters)
    log(f"stokes depth {DEPTH}: peak device memory of setup and "
        f"evaluations {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        "GiB")
    check(f"stokes depth {DEPTH}", kf, u, l6)
    for k, v in l6.items():
        launches[k] += v
    if not kf.surface_route:
        raise SystemExit(f"chip_smoke: stokes depth {DEPTH} took other "
                         f"routes: {_describe(kf)}")
    spread = rounding_spread(torch, kf, f_dev, idx, u_ref,
                             f"stokes depth {DEPTH}")
    # the same evaluation with the sweep at the exact ranks
    caps = ops.blk_r, ops.blk_r2
    ops.blk_r, ops.blk_r2 = ops.m2l_a.shape[1:]
    u_exact = kf.eval_tensor(f_dev).cpu().numpy()
    log(f"stokes depth {DEPTH}: with the M2L sweep at the exact ranks "
        f"{ops.blk_r}/{ops.blk_r2} rel err "
        f"{_sample_err(u_exact[idx], u_ref):.3e}")
    ops.blk_r, ops.blk_r2 = caps
    for way, (ms, diff) in m2l_routes_at(
            torch, kf, DEPTH, ("sweep", "sweep exact", "blocked")).items():
        log(f"stokes: M2L at level {DEPTH}, {way}: {ms:.3f} ms, relative "
            f"difference from the route {diff:.3e}")
    del kf
    torch.cuda.empty_cache()
    stokes_depths(torch, ops)
    return launches, oracle_row, st6c, spread


def near_ways(torch, kf, fp):
    """The near field of the set-up KIFMM on padded densities fp two
    ways: the halo stencil p2p_stencil on the run's own columns, and
    p2p_ulist over each box's 27 neighbours' real slots as one flat
    list (coordinates as the boxes hold them, densities read through
    the slot index), in one launch, the list built here and not timed
    -> (stencil ms, ulist ms, relative difference, launches of
    p2p_ulist)."""
    from sctl_tpu_torch.kernel_cases import neighbour_lists, rel_max_err
    from sctl_tpu_torch.ops.p2p import p2p_ulist
    args = neighbour_lists(kf, fp)
    ulist = lambda: p2p_ulist(kf.ker_s2t, *args)
    p2p_ulist.launches = 0
    u = ulist()
    launches = p2p_ulist.launches
    diff = rel_max_err(u, kf._p2p_near(fp))
    del u
    out = (cuda_ms(torch, lambda: kf._p2p_near(fp), 3),
           cuda_ms(torch, ulist, 3), diff, launches)
    del args
    torch.cuda.empty_cache()
    return out


def sass_loop(name_part):
    """(instructions, MUFU.RSQ, float64 instructions) of the innermost
    loop with the most MUFU.RSQ in the SASS of the first kernel whose
    mangled name holds `name_part` (cuobjdump -sass of the built
    library, dumped once), or None, also where cuobjdump is missing.
    One MUFU.RSQ is one pair, so the ratio is the issue slots a pair."""
    import shutil
    from sctl_tpu_torch.ops import _build
    if sass_loop.dump is None:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        try:
            sass_loop.dump = subprocess.run(
                [tool, "-sass", str(_build.BUILD_DIR / _build.LIB_NAME)],
                capture_output=True, text=True, check=True,
                timeout=300).stdout.split("Function : ")[1:]
        except (OSError, subprocess.CalledProcessError):
            sass_loop.dump = []
    return _inner_loop(next((b for b in sass_loop.dump
                             if name_part in b.split("\n", 1)[0]), ""))


sass_loop.dump = None


def _inner_loop(fn):
    """(instructions, MUFU.RSQ, float64 instructions) of one kernel's
    SASS listing's innermost loop with the most MUFU.RSQ, or None."""
    import re
    ins, labels = [], {}
    for ln in fn.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            labels[m.group(1)] = None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            addr = int(m.group(1), 16)
            for k, v in labels.items():
                if v is None:
                    labels[k] = addr
            ins.append((addr, m.group(2)))
    loops = []
    for addr, text in ins:
        m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", text)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is None or tgt > addr:
            continue
        body_ins = [t for a, t in ins if tgt <= a <= addr]
        mufu = sum("MUFU.RSQ" in t for t in body_ins)
        dp = sum(bool(re.match(r"(@!?P\d+\s+)?D(ADD|MUL|FMA|SETP|MNMX)",
                               t)) for t in body_ins)
        if mufu:
            loops.append((tgt, addr, len(body_ins), mufu, dp))
    inner = [lp for lp in loops if not any(
        o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return None
    return max(inner, key=lambda lp: lp[3])[2:]


def stencil_times(torch, kf, f_h, label):
    """The halo stencil alone on the set-up KIFMM's own columns, over
    each box's real slots by its counts (the main path) and over every
    padded slot (no counts: the slots PR 7's kernel evaluated), with
    their difference at the real target slots and the bound of the real
    pairs."""
    from sctl_tpu_torch.kernel_cases import main_path_work, rel_max_err
    from sctl_tpu_torch.ops.p2p import p2p_stencil
    n = 1 << kf.depth
    args = (kf.ker_s2t, n, kf.cap_s, kf.cap_t, kf.xt_rast, kf.xs_halo, f_h,
            kf.ns_halo)
    real = lambda: p2p_stencil(*args, kf.cnt_s_rast, kf.cnt_t_rast)
    every = lambda: p2p_stencil(*args)
    live = (torch.arange(kf.cap_t, device=kf.device)
            < kf.cnt_t_rast[..., None])[..., None]
    diff = rel_max_err(every() * live, real())
    ms, every_ms = cuda_ms(torch, real, 3), cuda_ms(torch, every, 3)
    work = main_path_work(kf)["p2p_stencil"]
    b_ms, b_by = bound(work)
    log(f"{label}: p2p_stencil {ms:.4f} ms over the real slots (2 targets "
        f"a thread), {every_ms:.4f} ms over every padded slot, difference "
        f"{diff:.3e}; bound {b_ms:.4f} ms ({b_by}, {ops_limit(work)}), "
        f"pairs {work['pairs']}")
    return dict(ms=ms, every_slot_ms=every_ms, bound_ms=b_ms,
                pairs=work["pairs"])


def stencil9_times(torch, kf, f_s, label):
    """The slab stencil alone on the set-up KIFMM's own compacted slab,
    over each entry's real slots and each box's real targets by their
    counts (the main path) and over every slot (no counts: the slot
    pairs of the JAX function), with their difference at the real
    target slots, the bound of the real pairs and the blocks an SM."""
    from sctl_tpu_torch.kernel_cases import main_path_work, rel_max_err
    from sctl_tpu_torch.ops.p2p import p2p_stencil9, stencil9_layout
    n = 1 << kf.depth
    args = (kf.ker_s2t, n, kf.SL, kf.cap_t, kf.xt_rast, kf.xs_slab, f_s,
            kf.ns_slab)
    real = lambda: p2p_stencil9(*args, kf.cnt9, kf.cnt_t_rast)
    every = lambda: p2p_stencil9(*args)
    live = (torch.arange(kf.cap_t, device=kf.device)
            < kf.cnt_t_rast[..., None])[..., None]
    diff = rel_max_err(every() * live, real())
    ms, every_ms = cuda_ms(torch, real, 5), cuda_ms(torch, every, 3)
    work = main_path_work(kf)["p2p_stencil9"]
    b_ms, b_by = bound(work)
    lay = stencil9_layout(kf.ker_s2t, kf.SL, kf.cap_t, kf.dtype)
    log(f"{label}: p2p_stencil9 {ms:.4f} ms over the real slots "
        f"({lay['lanes_per_target']} lanes a target, {lay['threads']} "
        f"threads a block, {lay['blocks_per_sm']} blocks an SM), "
        f"{every_ms:.4f} ms over "
        f"every slot, difference {diff:.3e}; bound {b_ms:.4f} ms ({b_by}, "
        f"{ops_limit(work)}), pairs {work['pairs']}, real slab slots "
        f"{int(kf.cnt9.sum())} of {kf.cnt9.numel() * kf.SL}")
    return dict(ms=ms, every_slot_ms=every_ms, bound_ms=b_ms,
                pairs=work["pairs"], blocks_per_sm=lay["blocks_per_sm"],
                lanes_per_target=lay["lanes_per_target"])


def surface_times(torch, kf, fp, q_cm, label):
    """The two shared-surface kernels alone on the set-up KIFMM's own
    slots (its S2M and L2T formulas; padded densities fp, L2T densities
    q_cm), over each box's real slots by its counts (the main path) and
    over every padded slot (no counts: the slot pairs of the JAX
    function), with their difference at the real slots, the bound of
    the real pairs, the layout and blocks an SM (occupancy API) and the
    issue-slot floor of the formula's loop -> {name: row}."""
    from sctl_tpu_torch.kernel_cases import main_path_work, rel_max_err
    from sctl_tpu_torch.ops.sl import (l2t_surface, l2t_surface_layout,
                                       surface_pair, surface_pair_layout)
    from sctl_tpu_torch.ops.uker import FORMULA
    ns = kf._ops.n_surf
    km, kl = kf.ker_s2m, kf.ker_l2t
    f64 = kf.dtype == torch.float64
    tc = "d" if f64 else "f"            # the build's Real in the mangling
    s2m = (km, kf.surf_out_L, kf.xs_sl,
           fp.reshape(-1, km.kdim0).T.contiguous(), kf.cap_s, kf.ns_sl)
    l2t = (kl, kf.surf_out_L, kf.xt_sl, q_cm, kf.cap_t)
    live_t = (torch.arange(kf.cap_t, device=kf.device)
              < kf.cnt_t_box[:, None]).reshape(1, -1)
    s_lay = surface_pair_layout(km, ns, kf.dtype)
    ways = {
        "surface_pair": (lambda: surface_pair(*s2m, kf.cnt_s_box),
                         lambda: surface_pair(*s2m), 1, s_lay,
                         f"surface_pair_kernelI{tc}Li{FORMULA[km.name]}ELi"
                         f"{s_lay['points_per_lane']}E"),
        "l2t_surface": (lambda: l2t_surface(*l2t, kf.cnt_t_box),
                        lambda: l2t_surface(*l2t), live_t,
                        l2t_surface_layout(kl, ns, kf.cap_t, kf.dtype),
                        f"l2t_surface_kernelI{tc}Li{FORMULA[kl.name]}E")}
    work = main_path_work(kf)
    rows = {}
    for name, (real, every, live, lay, mangled) in ways.items():
        diff = rel_max_err(every() * live, real())
        ms, every_ms = cuda_ms(torch, real, 5), cuda_ms(torch, every, 3)
        b_ms, b_by = bound(work[name])
        log(f"{label}: {name} {ms:.4f} ms over the real slots, "
            f"{every_ms:.4f} ms over every padded slot, difference "
            f"{diff:.3e}; bound {b_ms:.4f} ms ({b_by}, "
            f"{ops_limit(work[name])}), pairs {work[name]['pairs']}; "
            f"layout {lay}")
        rows[name] = dict(every_slot_ms=every_ms,
                          blocks_per_sm=lay["blocks_per_sm"],
                          **(issue_floor(name, mangled, work[name]["pairs"],
                                         label, f64) or {}))
    return rows


def rounding_spread(torch, kf, f_dev, idx, u_ref, label):
    """The set-up KIFMM's error at the sampled targets idx against the
    float64 p2p (u_ref, numpy) at the densities f_dev scaled by each of
    SPREAD_SCALES, with S2M and L2T through their kernels and through
    their plain versions in float64 (cast back to float32).  The
    function is linear, so within a way the errors differ by float32
    rounding only, which the pinv operators amplify; the kernels'
    median may be at most SPREAD_RATIO times the float64 way's, and
    every error under FMM_BAR.  The module's functions are put back
    after -> dict(errors, medians, ratio)."""
    import numpy as np
    import sctl_tpu_torch.fmm.kifmm as kifmm_mod
    from sctl_tpu_torch.kernel_cases import _cast
    from sctl_tpu_torch.ops.sl import l2t_surface_plain, surface_pair_plain

    def f64(plain):
        return lambda *a: plain(*_cast(a, torch.float64)).float()

    own = kifmm_mod.surface_pair, kifmm_mod.l2t_surface
    ways = {"kernels": own,
            "plain float64": (f64(surface_pair_plain),
                              f64(l2t_surface_plain))}
    it = torch.as_tensor(idx, device=kf.device)
    errs = {}
    try:
        for way, (s2m, l2t) in ways.items():
            kifmm_mod.surface_pair, kifmm_mod.l2t_surface = s2m, l2t
            errs[way] = [_sample_err(
                kf.eval_tensor(f_dev * c)[it].double().cpu().numpy(),
                u_ref * c) for c in SPREAD_SCALES]
    finally:
        kifmm_mod.surface_pair, kifmm_mod.l2t_surface = own
    med = {way: float(np.median(v)) for way, v in errs.items()}
    ratio = med["kernels"] / med["plain float64"]
    log(f"{label}: rounding spread, rel err at {len(idx)} sampled targets "
        f"with the densities scaled by 1 + k 1e-6, k = 0..4, S2M and L2T "
        + "; ".join(f"through the {way} {['%.4e' % e for e in v]} (median "
                    f"{med[way]:.4e})" for way, v in errs.items())
        + f"; ratio of the medians {ratio:.3f} (at most {SPREAD_RATIO})")
    if not (all(np.isfinite(e) and e < FMM_BAR for v in errs.values()
                for e in v) and ratio <= SPREAD_RATIO):
        raise SystemExit(f"chip_smoke: {label} rounding spread: {errs}")
    return dict(errors=errs, medians=med, ratio=ratio)


# lane-operations a second of the whole card: 128 issue slots a clock
# per SM (4 schedulers x 32 lanes), 64 for the float64 pipe, at the
# clock of the rsqrt bound
ISSUE_PER_S = 128 * RSQRT_PER_S / 16
DP_PER_S = 64 * RSQRT_PER_S / 16


def issue_floor(kernel, mangled, pairs, label, f64=False):
    """A pair kernel's issue-slot floor: the SASS instructions a pair of
    the inner loop of the instantiation whose mangled name holds
    `mangled` (one MUFU.RSQ a pair), at 128 lane-instructions a clock
    per SM; with f64, its DP instructions a pair at the DP pipe's 64 ->
    dict, or None without cuobjdump."""
    loop = sass_loop(mangled)
    if loop is None:
        log(f"{label}: {kernel} issue-slot floor not measured (no "
            f"cuobjdump or no loop)")
        return None
    n_ins, mufu, n_dp = loop
    per_pair = n_ins / mufu
    out = dict(sass_per_pair=per_pair, loop_instructions=n_ins,
               loop_rsqrt=mufu,
               issue_floor_ms=1e3 * pairs * per_pair / ISSUE_PER_S)
    msg = (f"{label}: {kernel} issue-slot floor ({mangled}): inner loop "
           f"{n_ins} SASS instructions for {mufu} MUFU.RSQ, "
           f"{per_pair:.2f} a pair -> {out['issue_floor_ms']:.4f} ms for "
           f"{pairs} pairs at 128 lane-instructions a clock per SM")
    if f64:
        out.update(dp_per_pair=n_dp / mufu,
                   dp_floor_ms=1e3 * pairs * n_dp / mufu / DP_PER_S)
        out["issue_floor_ms"] = max(out["issue_floor_ms"],
                                    out["dp_floor_ms"])
        msg += (f"; {n_dp} DP instructions, {n_dp / mufu:.2f} a pair -> "
                f"{out['dp_floor_ms']:.4f} ms at the DP pipe's 64 "
                f"lane-operations a clock per SM")
    else:
        msg += f" (the rsqrt bound {1e3 * pairs / RSQRT_PER_S:.4f} ms)"
    log(msg)
    return out


def phase_p8(torch, counters):
    """7: ParticleFMM(accuracy=8) at 1e7 points, rung 2 of BASELINE.md,
    through m2l_grid and p2p_stencil."""
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM, ParticleFMM
    from sctl_tpu_torch.fmm.kifmm import unit_tables
    from sctl_tpu_torch.kernel_cases import formula_cases, kernel_cases
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.ops.m2l import m2l_grid
    from sctl_tpu_torch.ops.p2p import p2p_stencil, to_halo
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    t = time.perf_counter()
    unit_tables(Laplace3D_FxU.name, P8, 3e-5)
    log(f"p8: cold Laplace3D-FxU table build (p={P8}, rcond 3e-5) "
        f"{time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(7)
    x = rng.random((P8_N, 3))
    f = rng.normal(size=(P8_N, 1))
    idx = rng.choice(P8_N, N_SAMPLE, replace=False)
    x64 = torch.as_tensor(x, device="cuda")
    u_ref = direct_eval_blocked(Laplace3D_FxU, x64[idx], x64,
                                torch.as_tensor(f, device="cuda"),
                                block_t=N_SAMPLE, block_s=1 << 17)
    u_ref = u_ref.cpu().numpy()
    del x64
    f_dev = torch.as_tensor(f, dtype=torch.float32, device="cuda")

    fmm = ParticleFMM(accuracy=P8, device="cuda", dtype=torch.float32)
    fmm.set_kernel_s2t("src", "trg", Laplace3D_FxU)
    fmm.set_src_coord("src", x)
    fmm.set_src_density("src", f)
    fmm.set_trg_coord("trg", x)
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t = time.perf_counter()
    kf = fmm._get_kifmm(Laplace3D_FxU, x, fmm.src["src"], "src", "trg")
    torch.cuda.synchronize()
    ops = kf._ops
    log(f"p8 setup: {time.perf_counter() - t:.2f} s ({_describe(kf)})")
    r_ex, r2_ex = ops.m2l_a.shape[1:]
    log(f"p8 routes: M2L level 2 per-parity sweep at exact ranks "
        f"{r_ex}/{r2_ex}; levels 3-{kf.depth} {ops.m2l_route} at ranks "
        f"{ops.blk_r}/{ops.blk_r2}; near field p2p_{kf.near_route} (cap_s "
        f"{kf.cap_s}, cap_t {kf.cap_t})")
    t = time.perf_counter()
    u = fmm.eval("trg")
    log(f"p8: ParticleFMM.eval {time.perf_counter() - t:.4f} s (host "
        f"arrays in and out)")
    _evals(torch, kf, f_dev, "p8")
    launches = read(counters)
    log(f"p8: peak device memory of setup and evaluations "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    err = _sample_err(u[idx], u_ref)
    log(f"p8: rel err at {N_SAMPLE} sampled targets vs float64 p2p "
        f"{err:.3e} (bar {FMM_BAR:g}); launches {launches}")
    if not (ops.m2l_route == "grid" and kf.near_route == "stencil"
            and kf.depth >= 3):
        raise SystemExit(f"chip_smoke: p8 took other routes: "
                         f"{_describe(kf)}")
    if not np.isfinite(err) or not err < FMM_BAR:
        raise SystemExit(f"chip_smoke: p8 error {err:.3e}")
    if launches["p2p"] or not _tree_kernels_launched(kf, launches):
        raise SystemExit(f"chip_smoke: p8: a kernel of the path was not "
                         f"launched: {launches}")
    if not kf.surface_route:
        raise SystemExit(f"chip_smoke: p8 took other routes: "
                         f"{_describe(kf)}")
    spread = rounding_spread(torch, kf, f_dev, idx, u_ref, "p8")

    # the path's kernels against their plain versions, reduced; the
    # pair kernels also against float64
    cases = kernel_cases(kf)
    rows = phase_kernels(torch, None, {"m2l_grid": cases["m2l_grid"]})
    rows.update(phase_kernels(torch, None, {
        k: cases[k] for k in ("p2p_stencil", "surface_pair",
                              "l2t_surface")}, f64_bar=DIRECT_BAR))
    frows = phase_kernels(torch, None,
                          formula_cases(kf, stages=("p2p_stencil",)),
                          f64_bar=DIRECT_BAR)
    rows["p2p_stencil"]["cases"] = {
        k: dict(max_rel_err=v["max_rel_err"], ms=v["ms"],
                plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                max_rel_err_f64=v["max_rel_err_f64"])
        for k, v in frows.items()}

    # each alone at the run's shapes (level 5 for M2L)
    n = 1 << kf.depth
    qp = torch.zeros((n + 6,) * 3 + (ops.blk_r2,), device="cuda")
    qp[3:-3, 3:-3, 3:-3] = torch.randn((n, n, n, ops.blk_r2),
                                       device="cuda")
    fp, _ = kf.pad_density(f_dev)
    f_h = to_halo(fp, kf.rast_to_mort, n)
    q_cm = torch.randn((1, ops.n_surf, kf.src_tree.n_boxes),
                       device="cuda")
    full = {"m2l_grid": lambda: m2l_grid(qp, ops.m2l_at, ops.m2l_at_tc),
            "p2p_stencil": lambda: p2p_stencil(
                kf.ker_s2t, n, kf.cap_s, kf.cap_t, kf.xt_rast, kf.xs_halo,
                f_h, None, kf.cnt_s_rast, kf.cnt_t_rast),
            "surface_pair": lambda: surface_pair(
                Laplace3D_FxU, kf.surf_out_L, kf.xs_sl, fp.reshape(1, -1),
                kf.cap_s, None, kf.cnt_s_box),
            "l2t_surface": lambda: l2t_surface(
                Laplace3D_FxU, kf.surf_out_L, kf.xt_sl, q_cm, kf.cap_t,
                kf.cnt_t_box)}
    main_rows = alone_rows(torch, kf, full, launches, "p8")
    for name, row in surface_times(torch, kf, fp, q_cm, "p8").items():
        main_rows[name].update(row)
    main_rows["surface_pair"]["rounding_spread"] = spread
    st = stencil_times(torch, kf, f_h, "p8")
    main_rows["p2p_stencil"].update(
        every_slot_ms=st["every_slot_ms"],
        **(issue_floor("p2p_stencil", "p2p_stencil_kernelIfLi0E",
                       st["pairs"], "p8") or {}))
    del qp, f_h, q_cm
    main_rows["m2l_grid"]["levels"] = m2l_levels(torch, kf, "p8")
    for way, (ms, diff) in m2l_routes_at(
            torch, kf, kf.depth, ("grid", "blocked", "sweep")).items():
        log(f"p8: M2L at level {kf.depth}, {way}: {ms:.3f} ms, relative "
            f"difference from the route {diff:.3e}")
    st_ms, ul_ms, diff, n_ul = near_ways(torch, kf, fp)
    log(f"p8: near field through p2p_stencil {st_ms:.3f} ms, through "
        f"p2p_ulist on each box's 27 neighbours' real slots {ul_ms:.3f} ms"
        f" ({n_ul} launch(es)); relative difference {diff:.3e}")
    del fmm, kf, u, fp, f_dev
    torch.cuda.empty_cache()

    # rung 2: p=8, depth 3, 4,000 points against the float64 p2p
    xr = rng.random((RUNG2_N, 3))
    fr = rng.normal(size=(RUNG2_N, 1))
    c64 = lambda a: torch.as_tensor(a, device="cuda")
    reset(counters)
    kr = KIFMM(Laplace3D_FxU, p=P8, depth=3, device="cuda",
               dtype=torch.float32, operators=ops).setup(xr, xr)
    ur = kr.eval(fr)
    lr = read(counters)
    ud = direct_eval_blocked(Laplace3D_FxU, c64(xr), c64(xr),
                             c64(fr)).cpu().numpy()
    err2 = _sample_err(ur, ud)
    log(f"p8 rung 2: {RUNG2_N} points, {_describe(kr)}; rel err vs float64 "
        f"p2p at every target {err2:.3e} (bar {RUNG2_BAR:g}); launches {lr}")
    if (not np.isfinite(err2) or not err2 < RUNG2_BAR
            or not _tree_kernels_launched(kr, lr)):
        raise SystemExit(f"chip_smoke: rung 2 failed: {err2:.3e}, {lr}")
    for k, v in lr.items():
        launches[k] += v
    return launches, rows, main_rows


def f64_launches(fns):
    """The float64 launches of each wrapper of `fns` (name -> wrapper)."""
    return {k: fn.launches_f64 for k, fn in fns.items()}


def reset_f64(fns):
    for fn in fns.values():
        fn.launches_f64 = 0


def once_ms(torch, fn):
    """(fn(), its milliseconds on the card from CUDA events) of one
    call: a plain version at the main path's size takes seconds."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def f64_alone(torch, kf, full, label):
    """Each float64 build of `full` (name -> (kernel call, plain call,
    work)) alone on the set-up float64 KIFMM's own tensors: its ms (5
    launches) against its bound, and its output against the plain
    version in float64 on the same inputs, at most ORACLE_BAR of the
    maximum -> {name: row}."""
    from sctl_tpu_torch.kernel_cases import rel_max_err
    rows = {}
    for name, (run, plain, work) in full.items():
        ms = cuda_ms(torch, run, 5)
        out = run()
        ref, plain_ms = once_ms(torch, plain)
        err = rel_max_err(out, ref)
        abs_err = float((out - ref).abs().max())
        del out, ref
        b_ms, b_by = bound(work)
        log(f"{label}: {name} float64 alone at the run's shapes {ms:.4f} "
            f"ms, plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}: "
            f"operations {1e3 * work['pairs'] * work['pair_flops'] / F64_FLOPS:.4f}"
            f" ms at 34 TFLOP/s, bytes {1e3 * work['bytes'] / HBM_BPS:.4f}"
            f" ms), pairs {work['pairs']}; against its plain version in "
            f"float64 {err:.3e} (bar {ORACLE_BAR:g})")
        if not err < ORACLE_BAR:
            raise SystemExit(f"chip_smoke: {label}: {name} float64 against "
                             f"its plain version: {err:.3e}")
        rows[name] = dict(main_path_ms=ms, main_path_plain_ms=plain_ms,
                          main_path_bound_ms=b_ms, main_path_bound_by=b_by,
                          main_path_max_rel_err=err,
                          main_path_max_abs_err=abs_err, pairs=work["pairs"])
    torch.cuda.empty_cache()
    return rows


def f64_ladder_inputs(torch):
    """tests/test_accuracy_ladder.py's inputs and their float64 p2p sum
    on the card."""
    import numpy as np
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    rng = np.random.default_rng(12)
    x = rng.random((LADDER_N, 3))
    f = rng.normal(size=(LADDER_N, 1))
    c64 = lambda a: torch.as_tensor(a, device="cuda")
    u = direct_eval_blocked(Laplace3D_FxU, c64(x), c64(x), c64(f))
    return x, f, u.cpu().numpy()


def f64_rung(torch, fns, inputs, label, bar, p, **kw):
    """One rung: KIFMM(Laplace3D_FxU, p, depth 3, float64, **kw) on the
    ladder's inputs (x, f, their float64 p2p sum) at every target ->
    (error, float64 launches)."""
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.ops import Laplace3D_FxU
    x, f, u_ref = inputs
    reset_f64(fns)
    t = time.perf_counter()
    kf = KIFMM(Laplace3D_FxU, p=p, depth=3, device="cuda",
               dtype=torch.float64, **kw).setup(x, x)
    setup_s = time.perf_counter() - t
    err = _sample_err(kf.eval(f), u_ref)
    launches = f64_launches(fns)
    log(f"{label}: p={p}, {LADDER_N} points, {_describe(kf)}, setup "
        f"{setup_s:.2f} s (tables included); rel err vs float64 p2p at "
        f"every target {err:.3e} (bar {bar:g}); float64 launches "
        f"{launches}")
    need = ["surface_pair", "l2t_surface", "p2p_stencil9"]
    if (not np.isfinite(err) or not err < bar or kf._ops.m2l_route
            != "parity" or not all(launches[k] > 0 for k in need)):
        raise SystemExit(f"chip_smoke: {label} p={p}: error {err:.3e}, "
                         f"{_describe(kf)}, launches {launches}")
    return err, launches


def phase_f64(torch, smi):
    """8: the float64 ladder on the card: the four float64 builds against
    their plain versions (8a), BASELINE.md's rungs 3 and 4 (8b) and 7
    (8c), the 1e7-point float64 Laplace KIFMM at p = 6, depth 6 (8d)
    and the float64 ParticleFMM(accuracy=8) at 1e7 points (8e) ->
    (f64 rows {name: case row}, {name: main-path row}, launches {name:
    float64 launches summed over 8b-8e}, summary)."""
    import os
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMM, ParticleFMM
    from sctl_tpu_torch.fmm.kifmm import table_path, unit_tables
    from sctl_tpu_torch.kernel_cases import (formula_cases, kernel_cases,
                                             main_path_work,
                                             p2p_ulist_work)
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.ops.p2p import (p2p_stencil, p2p_stencil9,
                                        p2p_stencil9_plain, p2p_stencil_plain,
                                        p2p_ulist, p2p_ulist_plain,
                                        slab_gather, to_halo)
    from sctl_tpu_torch.ops.sl import (l2t_surface, l2t_surface_plain,
                                       surface_pair, surface_pair_plain)
    from sctl_tpu_torch.ops.uker import FORMULA
    LAP, f64 = Laplace3D_FxU, torch.float64
    fns = {"surface_pair": surface_pair, "l2t_surface": l2t_surface,
           "p2p_stencil9": p2p_stencil9, "p2p_stencil": p2p_stencil,
           "p2p_ulist": p2p_ulist}
    total = {k: 0 for k in fns}
    summary = {"device": smi}
    log(f"f64: phase 8, the float64 ladder, on '{smi}'")

    # ---- 8d set-up; 8a at its widths -----------------------------------
    rng = np.random.default_rng(0)
    xs = rng.random((N_POINTS, 3))
    f = rng.normal(size=(N_POINTS, 1))
    t = time.perf_counter()
    kf = KIFMM(LAP, p=P, depth=DEPTH, device="cuda", dtype=f64).setup(xs, xs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    log(f"f64 8d setup: {setup_s:.2f} s, cold float64 tables (p={P}, rcond "
        f"{kf.rcond:g}) included ({_describe(kf)})")
    if not (kf.surface_route and kf.near_route == "stencil9"
            and kf._ops.m2l_route == "parity"):
        raise SystemExit(f"chip_smoke: 8d took other routes: "
                         f"{_describe(kf)}")
    rows = phase_kernels(torch, kf, kernel_cases(kf, dtype=f64))
    frows = phase_kernels(torch, kf, formula_cases(kf, dtype=f64))

    # ---- 8d: the 1e7-point float64 path ---------------------------------
    f_dev = torch.as_tensor(f, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_f64(fns)
    u = kf.eval_tensor(f_dev)                        # warm
    med, stages = _evals(torch, kf, f_dev, "f64 8d")
    launches = f64_launches(fns)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    idx = rng.choice(N_POINTS, N_SAMPLE, replace=False)
    x64 = torch.as_tensor(xs, device="cuda")
    u_ref = direct_eval_blocked(LAP, x64[idx], x64, f_dev,
                                block_t=N_SAMPLE, block_s=1 << 17)
    err = float((u[torch.as_tensor(idx, device="cuda")] - u_ref).abs().max()
                / u_ref.abs().max())
    del x64, u, u_ref
    log(f"f64 8d: rel err at {N_SAMPLE} sampled targets vs float64 p2p "
        f"{err:.3e} (bar {F64_FMM_BAR:g}); peak device memory "
        f"{peak:.2f} GiB; float64 launches {launches}; on '{smi}'")
    need = ("surface_pair", "l2t_surface", "p2p_stencil9")
    if not (np.isfinite(err) and err < F64_FMM_BAR
            and all(launches[k] > 0 for k in need)):
        raise SystemExit(f"chip_smoke: 8d: error {err:.3e}, launches "
                         f"{launches}")
    for k, v in launches.items():
        total[k] += v
    summary["8d"] = dict(setup_s=setup_s, eval_s=med, stage_ms=stages,
                         err=err, peak_gib=peak, launches=launches)

    # each float64 build alone on the run's own tensors
    ns, B, n = kf._ops.n_surf, kf.src_tree.n_boxes, 1 << DEPTH
    fp, _ = kf.pad_density(f_dev)
    q_cm = torch.randn((1, ns, B), dtype=f64, device="cuda")
    f_s = slab_gather(fp, kf.slab_idx)
    work = main_path_work(kf)
    s2m = (LAP, kf.surf_out_L, kf.xs_sl, fp.reshape(1, -1), kf.cap_s, None,
           kf.cnt_s_box)
    l2t = (LAP, kf.surf_out_L, kf.xt_sl, q_cm, kf.cap_t, kf.cnt_t_box)
    s9 = (LAP, n, kf.SL, kf.cap_t, kf.xt_rast, kf.xs_slab, f_s, None,
          kf.cnt9, kf.cnt_t_rast)
    main = f64_alone(torch, kf, {
        "surface_pair": (lambda: surface_pair(*s2m),
                         lambda: surface_pair_plain(*s2m),
                         work["surface_pair"]),
        "l2t_surface": (lambda: l2t_surface(*l2t),
                        lambda: l2t_surface_plain(*l2t),
                        work["l2t_surface"]),
        "p2p_stencil9": (lambda: p2p_stencil9(*s9),
                         lambda: p2p_stencil9_plain(*s9),
                         work["p2p_stencil9"])}, "f64 8d")
    for name, row in surface_times(torch, kf, fp, q_cm, "f64 8d").items():
        main[name].update(row)
    st = stencil9_times(torch, kf, f_s, "f64 8d")
    main["p2p_stencil9"].update(
        every_slot_ms=st["every_slot_ms"], blocks_per_sm=st["blocks_per_sm"],
        **(issue_floor("p2p_stencil9", "p2p_stencil9_kernelIdLi0E",
                       st["pairs"], "f64 8d", f64=True) or {}))
    del kf, fp, q_cm, f_s, s2m, l2t, s9, f_dev, xs, f
    torch.cuda.empty_cache()

    # ---- 8e: the float64 facade at accuracy 8 ----------------------------
    rng = np.random.default_rng(7)
    x = rng.random((P8_N, 3))
    f = rng.normal(size=(P8_N, 1))
    idx = rng.choice(P8_N, N_SAMPLE, replace=False)
    x64 = torch.as_tensor(x, device="cuda")
    f_dev = torch.as_tensor(f, device="cuda")
    u_ref = direct_eval_blocked(LAP, x64[idx], x64, f_dev, block_t=N_SAMPLE,
                                block_s=1 << 17).cpu().numpy()
    del x64
    fmm = ParticleFMM(accuracy=F64_FACADE_ACC, device="cuda", dtype=f64)
    fmm.set_kernel_s2t("src", "trg", LAP)
    fmm.set_src_coord("src", x)
    fmm.set_src_density("src", f)
    fmm.set_trg_coord("trg", x)
    torch.cuda.reset_peak_memory_stats()
    reset_f64(fns)
    t = time.perf_counter()
    kf = fmm._get_kifmm(LAP, x, fmm.src["src"], "src", "trg")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    log(f"f64 8e setup: {setup_s:.2f} s, cold float64 tables (p="
        f"{kf.p}, rcond {kf.rcond:g}) included ({_describe(kf)})")
    t = time.perf_counter()
    u = fmm.eval("trg")
    log(f"f64 8e: ParticleFMM.eval {time.perf_counter() - t:.4f} s (host "
        f"arrays in and out)")
    med, stages = _evals(torch, kf, f_dev, "f64 8e")
    launches = f64_launches(fns)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    err = _sample_err(u[idx], u_ref)
    log(f"f64 8e: rel err at {N_SAMPLE} sampled targets vs float64 p2p "
        f"{err:.3e} (bar {F64_FACADE_BAR:g}); peak device memory "
        f"{peak:.2f} GiB; float64 launches {launches}; on '{smi}'")
    if not (kf.near_route == "stencil" and not kf.surface_route
            and kf._ops.m2l_route == "parity"):
        raise SystemExit(f"chip_smoke: 8e took other routes: "
                         f"{_describe(kf)}")
    if not (np.isfinite(err) and err < F64_FACADE_BAR
            and launches["p2p_stencil"] > 0 and launches["p2p_ulist"] > 0):
        raise SystemExit(f"chip_smoke: 8e: error {err:.3e}, launches "
                         f"{launches}")
    for k, v in launches.items():
        total[k] += v
    summary["8e"] = dict(setup_s=setup_s, eval_s=med, stage_ms=stages,
                         err=err, peak_gib=peak, launches=launches)
    srows = phase_kernels(torch, kf, {
        k: v for k, v in kernel_cases(kf, dtype=f64).items()
        if k.startswith("p2p_stencil")})
    rows.update(srows)
    frows.update(phase_kernels(torch, kf, formula_cases(
        kf, stages=("p2p_stencil",), dtype=f64)))

    # the halo stencil and the two U-list calls alone on the run's tensors
    n = 1 << kf.depth
    fp, _ = kf.pad_density(f_dev)
    f_h = to_halo(fp, kf.rast_to_mort, n)
    ops = kf._ops
    B = kf.src_tree.n_boxes
    st_args = (LAP, n, kf.cap_s, kf.cap_t, kf.xt_rast, kf.xs_halo, f_h,
               None, kf.cnt_s_rast, kf.cnt_t_rast)
    xc_b = kf.surf_out_L.T.expand(B, -1, -1).contiguous()
    s2m = (LAP, xc_b, kf.xs_sl, None, fp.reshape(-1, 1), kf.rng_s)
    q_dn = torch.randn((B * ops.n_surf, 1), dtype=f64, device="cuda")
    l2t = (LAP, kf.xt_sl.reshape(3, B, kf.cap_t).transpose(0, 1)
           .contiguous(), kf.surf_out_L.T.repeat(1, B), None, q_dn,
           kf.rng_e, kf.cnt_t_box)
    cs = np.minimum(kf.src_tree.box_cnt, kf.cap_s)
    ct = np.minimum(kf.trg_tree.box_cnt, kf.cap_t)
    ulist_work = {
        "p2p_ulist S2M": p2p_ulist_work(LAP, int(cs.sum()) * ops.n_surf,
                                        B * ops.n_surf, int(cs.sum()), f64),
        "p2p_ulist L2T": p2p_ulist_work(LAP, int(ct.sum()) * ops.n_surf,
                                        int(ct.sum()), B * ops.n_surf, f64)}
    main8e = f64_alone(torch, kf, {
        "p2p_stencil": (lambda: p2p_stencil(*st_args),
                        lambda: p2p_stencil_plain(*st_args),
                        main_path_work(kf)["p2p_stencil"]),
        "p2p_ulist S2M": (lambda: p2p_ulist(*s2m),
                          lambda: p2p_ulist_plain(*s2m),
                          ulist_work["p2p_ulist S2M"]),
        "p2p_ulist L2T": (lambda: p2p_ulist(*l2t),
                          lambda: p2p_ulist_plain(*l2t),
                          ulist_work["p2p_ulist L2T"])}, "f64 8e")
    st = stencil_times(torch, kf, f_h, "f64 8e")
    main["p2p_stencil"] = dict(
        main8e.pop("p2p_stencil"), every_slot_ms=st["every_slot_ms"],
        **(issue_floor("p2p_stencil", "p2p_stencil_kernelIdLi0E",
                       st["pairs"], "f64 8e", f64=True) or {}))
    summary["8e"]["p2p_ulist"] = main8e
    del fmm, kf, fp, f_h, st_args, s2m, l2t, q_dn, xc_b, f_dev, u
    torch.cuda.empty_cache()

    # ---- 8b: rungs 3 and 4 ----------------------------------------------
    ladder = f64_ladder_inputs(torch)
    for p, bar in RUNG_BARS.items():
        err, launches = f64_rung(torch, fns, ladder, f"f64 8b rung "
                                 f"{3 if p == 6 else 4}", bar, p)
        summary[f"8b_p{p}"] = err
        for k, v in launches.items():
            total[k] += v

    # ---- 8c: rung 7 on the committed hiprec tables ----------------------
    for p in RUNG7_P:
        lite = table_path(LAP.name, p, RUNG7_RCOND, True)[:-4] + "_lite.npz"
        if not os.path.exists(lite):
            raise SystemExit(f"chip_smoke: rung 7 reads the committed "
                             f"table file {lite}, which is missing")
        t = time.perf_counter()
        unit_tables(LAP.name, p, RUNG7_RCOND, True)
        log(f"f64 8c: hiprec tables p={p} read from {lite} and rebuilt in "
            f"{time.perf_counter() - t:.2f} s")
        err, launches = f64_rung(torch, fns, ladder, "f64 8c rung 7",
                                 RUNG7_BAR, p, rcond=RUNG7_RCOND,
                                 hiprec=True)
        summary[f"8c_p{p}"] = err
        for k, v in launches.items():
            total[k] += v
    unit_tables.cache_clear()                 # the hiprec tables' GBs
    torch.cuda.empty_cache()
    log(f"f64: float64 launches over 8b-8e {total}; on '{smi}'")
    return rows, frows, main, total, summary


def _rel(a, b):
    """max |a - b| / max |b| of two tensors or arrays, on the host in
    float64."""
    import numpy as np
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
            for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _host_s(torch, fn):
    """(result, seconds) of fn() ending in a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def sphere_grid(torch, sh):
    """The points (nt np_, 3) of a SphericalHarmonics grid on the unit
    sphere and their quadrature weights (nt np_,), on its device."""
    import numpy as np
    th = torch.as_tensor(sh.theta, device=sh.device)
    ph = 2 * np.pi * torch.arange(sh.np_, dtype=torch.float64,
                                  device=sh.device) / sh.np_
    st, ct = torch.sin(th)[:, None], torch.cos(th)[:, None]
    xs = torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                      ct.expand(sh.nt, sh.np_)], dim=-1).reshape(-1, 3)
    qw = (sh._w[:, None] * (2 * np.pi / sh.np_)).expand(sh.nt, sh.np_)
    return xs, qw.reshape(-1)


def stokes_quadrature(torch, S, p, trg, device):
    """The Stokes single layer (Stokes3D_FxU) and double layer
    (Stokes3D_DxU, the normals the sphere's points) of the density
    vecshc2grid(S) at targets trg (N, 3), as direct sums over a
    (2p+2) x (4p+4) Gauss-Legendre x uniform grid of the unit sphere
    through direct_eval_blocked in float64 (p2p on a card): the oracle
    of tests/test_sph_harm.py's _StokesOracle (:168-228), whose formulas
    these kernels are."""
    from sctl_tpu_torch.linalg import SphericalHarmonics
    from sctl_tpu_torch.ops import (Stokes3D_DxU, Stokes3D_FxU,
                                    direct_eval_blocked)
    sh = SphericalHarmonics(p, 2 * p + 2, 4 * p + 4, device=device)
    xs, qw = sphere_grid(torch, sh)
    f = sh.vecshc2grid(S).reshape(3, -1).T * qw[:, None]
    trg = torch.as_tensor(trg, dtype=torch.float64, device=device)
    return (direct_eval_blocked(Stokes3D_FxU, trg, xs, f),
            direct_eval_blocked(Stokes3D_DxU, trg, xs, f, ns=xs))


def rotated_shc(shc, p, angle):
    """Packed coefficients of u(theta, phi - angle): each (c_lm, s_lm)
    pair rotated by m angle."""
    import numpy as np
    from sctl_tpu_torch.linalg.sph_harm import _packed_index
    _, m, s = _packed_index(p)
    ci = np.where((s == 0) & (m > 0))[0]       # c_lm; s_lm follows it
    c, sn = shc[..., ci], shc[..., ci + 1]
    ca, sa = np.cos(m[ci] * angle), np.sin(m[ci] * angle)
    out = shc.copy()
    out[..., ci] = c * ca - sn * sa
    out[..., ci + 1] = c * sa + sn * ca
    return out


def phase_spectral(torch, smi):
    """9: the spectral layer in float64 on the card (9a scalar
    transforms and the FFT facade, 9b vector transforms and the Stokes
    potentials on the sphere, 9c SDC), each against its bar; the
    Stokes oracles through the float64 p2p."""
    import numpy as np
    from sctl_tpu_torch.linalg import (FFT, SDC, FFTType,
                                       SphericalHarmonics, sh_dim,
                                       stokes_eval_dl, stokes_eval_kl,
                                       stokes_eval_kself, stokes_eval_sl,
                                       stokes_pressure_sl)
    from sctl_tpu_torch.linalg import sph_harm
    from sctl_tpu_torch.linalg.sph_harm import _packed_index
    from sctl_tpu_torch.ops.p2p import p2p
    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    out, fails = {}, []

    def check(name, val, *bars):
        out[name] = val
        bar = min(bars)
        log(f"spectral {name}: {val:.3e} (bars "
            f"{', '.join(f'{b:.0e}' for b in bars)})")
        if not val <= bar:
            fails.append(f"{name} {val:.3e} > {bar:.0e}")

    p2p.launches = p2p.launches_f64 = 0
    dev = "cuda"
    # 9a: the scalar transforms at p = 512
    _, build_s = _host_s(torch, lambda: sph_harm._legendre_tables(
        SH_P, SH_P + 2))
    sh, move_s = _host_s(torch, lambda: SphericalHarmonics(SH_P,
                                                           device=dev))
    shc = torch.as_tensor(rng.normal(size=(SH_BATCH, sh_dim(SH_P))),
                          device=dev)
    torch.cuda.reset_peak_memory_stats()
    grid = sh.shc2grid(shc)
    back = sh.grid2shc(grid)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out["sh512"] = dict(
        table_build_s=build_s, table_to_device_s=move_s, peak_gib=peak,
        shc2grid_ms=cuda_ms(torch, lambda: sh.shc2grid(shc), 5),
        grid2shc_ms=cuda_ms(torch, lambda: sh.grid2shc(grid), 5))
    log(f"spectral 9a p={SH_P}: Legendre table ({SH_P + 1}, {SH_P + 1}, "
        f"{SH_P + 2}) built on the host in {build_s:.2f} s, moved to "
        f"the device in {move_s:.2f} s; {SH_BATCH} vectors: "
        f"{json.dumps(out['sh512'])}; on '{smi}'")
    check(f"sh{SH_P}_roundtrip_abs", float((back - shc).abs().max()), SH_BAR)
    del sh, grid, back
    sph_harm._legendre_tables.cache_clear()
    torch.cuda.empty_cache()
    shc = rng.normal(size=(SH_BATCH, sh_dim(SH_CMP_P)))
    shd = SphericalHarmonics(SH_CMP_P, device=dev)
    shh = SphericalHarmonics(SH_CMP_P, device="cpu")
    g = shh.shc2grid(shc)
    check(f"sh{SH_CMP_P}_shc2grid_vs_cpu", _rel(shd.shc2grid(shc), g),
          CARD_CPU_BAR)
    check(f"sh{SH_CMP_P}_grid2shc_vs_cpu",
          _rel(shd.grid2shc(g), shh.grid2shc(g)), CARD_CPU_BAR)
    del shd, shh, g
    for fwd, bwd in ((FFTType.C2C, FFTType.C2C_INV),
                     (FFTType.R2C, FFTType.C2R)):
        name = f"fft_{fwd.value}"
        pf, pb = (FFT(device=dev).setup(k, FFT_HOWMANY, FFT_DIMS)
                  for k in (fwd, bwd))
        hf, hb = (FFT(device="cpu").setup(k, FFT_HOWMANY, FFT_DIMS)
                  for k in (fwd, bwd))
        x = torch.as_tensor(rng.normal(size=pf.in_size()), device=dev)
        y, yh = pf.execute(x), hf.execute(x.cpu())
        check(f"{name}_vs_cpu", _rel(y, yh), FFT_BAR)
        xb = pb.execute(y)
        check(f"{name}_roundtrip_vs_cpu", _rel(xb, hb.execute(yh)),
              FFT_BAR)
        check(f"{name}_roundtrip", _rel(xb, x), FFT_BAR)
        out[name + "_ms"] = [cuda_ms(torch, lambda: pf.execute(x), 5),
                             cuda_ms(torch, lambda: pb.execute(y), 5)]
        del x, y, yh, xb
    log(f"spectral 9a FFT dims {FFT_DIMS} x {FFT_HOWMANY}: forward and "
        f"inverse ms C2C {out['fft_c2c_ms']}, R2C/C2R "
        f"{out['fft_r2c_ms']}; on '{smi}'")
    # 9b: the vector transforms and the Stokes potentials at p = 128
    sh = SphericalHarmonics(VEC_P, device=dev)
    S = rng.normal(size=(3, sh_dim(VEC_P)))
    S[1, 0] = S[2, 0] = 0.0                    # W_00 = X_00 = 0
    S_d = torch.as_tensor(S, device=dev)
    F = sh.vecshc2grid(S_d)
    check(f"vec{VEC_P}_roundtrip_abs",
          float((sh.grid2vecshc(F) - S_d).abs().max()), VEC_BAR)
    out["vec_ms"] = [cuda_ms(torch, lambda: sh.vecshc2grid(S_d), 3),
                     cuda_ms(torch, lambda: sh.grid2vecshc(F), 3)]
    del sh, F, S_d
    d = rng.normal(size=(SPHERE_N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nor = rng.normal(size=(SPHERE_N, 3))
    nor /= np.linalg.norm(nor, axis=1, keepdims=True)
    Sk = rng.normal(size=(3, sh_dim(KL_P)))
    Sk[1, 0] = Sk[2, 0] = 0.0
    for R in SPHERE_R:
        trg, interior, tag = R * d, R < 1, f"r{R}"
        (sl, dl), sd_s = _host_s(torch, lambda: (
            stokes_eval_sl(S, VEC_P, trg, interior, device=dev),
            stokes_eval_dl(S, VEC_P, trg, interior, device=dev)))
        (sl_q, dl_q), q_s = _host_s(torch, lambda: stokes_quadrature(
            torch, S, VEC_P, trg, dev))
        check(f"sl_{tag}", _rel(sl, sl_q), SL_BAR, SPHERE_TIGHT_BAR)
        check(f"dl_{tag}", _rel(dl, dl_q), DL_BAR, SPHERE_TIGHT_BAR)
        # the second witness: the plain p2p on the CPU
        w = SPHERE_WITNESS_N
        (sl_h, dl_h), h_s = _host_s(torch, lambda: stokes_quadrature(
            torch, S, VEC_P, trg[:w], "cpu"))
        for name, got, q, h in (("sl", sl, sl_q, sl_h),
                                ("dl", dl, dl_q, dl_h)):
            check(f"{name}_{tag}_vs_plain_oracle", _rel(got[:w], h),
                  SPHERE_TIGHT_BAR)
            check(f"oracle_{name}_{tag}_vs_plain", _rel(q[:w], h), ORACLE_BAR)
        out[f"sl_dl_{tag}_s"] = [sd_s, q_s, h_s]
        for fn in (stokes_eval_kself, stokes_pressure_sl):
            got, s_ = _host_s(torch, lambda: fn(Sk, KL_P, trg, interior,
                                                 device=dev))
            check(f"{fn.__name__}_{tag}_vs_cpu",
                  _rel(got, fn(Sk, KL_P, trg, interior, device="cpu")),
                  KL_BAR)
            out[f"{fn.__name__}_{tag}_s"] = s_
        kl, s_ = _host_s(torch, lambda: stokes_eval_kl(
            Sk, KL_P, trg, nor, interior, device=dev))
        check(f"stokes_eval_kl_{tag}_vs_cpu", _rel(kl, stokes_eval_kl(
            Sk, KL_P, trg, nor, interior, device="cpu")), KL_BAR)
        out[f"stokes_eval_kl_{tag}_s"] = s_
    log(f"spectral 9b: p={VEC_P} vector transforms ms "
        f"{out['vec_ms']}; SL and DL at {SPHERE_N} targets against the "
        f"float64 p2p on a {2 * VEC_P + 2} x {4 * VEC_P + 4} grid, "
        f"seconds spectral / oracle / plain oracle at {SPHERE_WITNESS_N}: "
        + ", ".join(f"r={R} {out[f'sl_dl_r{R}_s']}" for R in SPHERE_R)
        + f"; on '{smi}'")
    # 9c: SDC on the rigid rotation of SDC_FIELDS fields at p = 256
    sh = SphericalHarmonics(SDC_P, device=dev)
    lv = _packed_index(SDC_P)[0]
    c0 = rng.normal(size=(SDC_FIELDS, sh_dim(SDC_P))) \
        * np.exp(-lv / SDC_DAMP)
    u0 = sh.shc2grid(c0)
    calls, steps = [0], []

    def rhs(u):
        calls[0] += 1
        return -sh.shc2grid_grad(sh.grid2shc(u))[2]

    sdc = SDC(SDC_ORDER, device=dev)
    (u, t_end, err_acc), wall = _host_s(torch, lambda: sdc.adaptive_solve(
        SDC_DT0, SDC_T, u0, rhs, SDC_TOL,
        monitor=lambda t, dt, u: steps.append(dt)))
    out["sdc"] = dict(t=t_end, accepted_steps=len(steps),
                      f_calls=calls[0], wall_s=wall,
                      dt_min=min(steps), dt_max=max(steps),
                      accumulated_error=err_acc)
    log(f"spectral 9c SDC({SDC_ORDER}) tol {SDC_TOL:.0e} to T={SDC_T}, "
        f"{SDC_FIELDS} fields at p={SDC_P}: {json.dumps(out['sdc'])}; "
        f"on '{smi}'")
    if abs(t_end - SDC_T) > 1e-12:
        fails.append(f"SDC stopped at t={t_end}")
    check("sdc_err", _rel(u, sh.shc2grid(rotated_shc(c0, SDC_P, t_end))),
          10 * SDC_TOL)
    del sh, u, u0
    torch.cuda.empty_cache()
    # every p2p launch of this phase is float64 (the Stokes oracles)
    launches = {"p2p": p2p.launches_f64}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"spectral: float64 launches {launches}, {out['seconds']:.1f} s; "
        f"on '{smi}'")
    if fails or launches["p2p"] == 0:
        raise SystemExit(f"chip_smoke: the spectral phase failed: {fails}"
                         f", launches {launches}")
    return launches, out


# phase 10, the library layer: 10a the native runtime's build, the
# uniform tree of phase 4's points through the native and the numpy
# sort, an adaptive 2:1-balanced PtTree; 10b the profiler around a
# 1e6-point float32 KIFMM eval (depth 5), its block within 10% of CUDA
# events; 10c KIFMMLd's flagship rung (BASELINE.md rung 8,
# tests/test_accuracy_ladder.py:98-112) on the host in a process of its
# own, from the start of the run, against the card's float64 p2p; 10d
# Matrix.pinv on the card against the CPU, a KrylovPrecond checkpoint of
# card tensors restored bit for bit
TREE10_N, TREE10_MAX_PTS = 1_000_000, 64
PROF_N, PROF_DEPTH, PROF_REPS, PROF_BAR = 1_000_000, 5, 5, 0.10
LD_P, LD_DEPTH, LD_N, LD_SEED, LD_RCOND, LD_BAR = 12, 2, 1200, 12, 1e-11, \
    1.5e-9
PINV_SHAPE, PINV_BAR = (400, 300), 1e-12
KRYLOV_N = 2000


def ld_rung_child(out_path):
    """10c's host side, run in a process of its own: KIFMMLd at LD_P on
    LD_N points from default_rng(LD_SEED), sources = targets ->
    out_path (.npz: the potentials, setup and eval seconds, where the
    tables came from)."""
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMMLd
    from sctl_tpu_torch.ops import Laplace3D_FxU
    rng = np.random.default_rng(LD_SEED)
    x = rng.random((LD_N, 3))
    f = rng.normal(size=(LD_N, 1))
    t = time.perf_counter()
    kf = KIFMMLd(Laplace3D_FxU, p=LD_P, depth=LD_DEPTH,
                 rcond=LD_RCOND).setup(x, x)
    setup_s = time.perf_counter() - t
    t = time.perf_counter()
    u = kf.eval(f)
    np.savez(out_path, u=u, setup_s=setup_s,
             eval_s=time.perf_counter() - t,
             tables=json.dumps({str(k): v for k, v in
                                kf.table_source.items()}))


def start_ld_rung(tmpdir):
    """Start 10c's host side in a child process now -> (process, its
    output path, its start time).  The process is killed at exit if it
    still runs."""
    import atexit
    import os
    out = os.path.join(tmpdir, "ld_rung.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke as c; "
         "c.ld_rung_child(sys.argv[1])", out], cwd=here)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, time.perf_counter()


def _report_blocks(report):
    """(name, seconds) of each row of Profile.print_report(fields=("t",
    "f"))."""
    return [(ln[:40].strip(), float(ln[40:54]))
            for ln in report.splitlines()[2:]]


def phase_library(torch, counters, smi, ld):
    """10: the library layer (see the constants above)."""
    import io
    import tempfile
    import numpy as np
    from sctl_tpu_torch import Matrix, config, native
    from sctl_tpu_torch.fmm import KIFMM
    from sctl_tpu_torch.linalg import KrylovPrecond, gmres
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.ops.p2p import p2p
    from sctl_tpu_torch.profile import Profile
    from sctl_tpu_torch.tree import PtTree, UniformTree
    from sctl_tpu_torch.utils import checkpoint
    t_phase = time.perf_counter()
    reset(counters)
    p2p.launches_f64 = 0
    out = {}

    # ---- 10a: the native runtime and the trees ----
    t = time.perf_counter()
    so = native.build(force=True)
    out["native_build_s"] = time.perf_counter() - t
    if not native.available():
        raise SystemExit("chip_smoke: the native runtime did not load")
    xs = np.random.default_rng(0).random((N_POINTS, 3))
    t = time.perf_counter()
    tree = UniformTree(xs, DEPTH)
    out["uniform_tree_s"] = time.perf_counter() - t
    keys, bits = tree.box_of_point, 3 * DEPTH
    t = time.perf_counter()
    _, perm_n = native.argsort_small(keys, bits)
    out["sort_native_s"] = time.perf_counter() - t
    t = time.perf_counter()
    _, perm_p = native.argsort_small_plain(keys, bits)
    out["sort_numpy_s"] = time.perf_counter() - t
    same = bool(np.array_equal(perm_n, perm_p)
                and np.array_equal(tree.perm, perm_p))
    log(f"library native: built {so.name} in {out['native_build_s']:.2f} "
        f"s; UniformTree of phase 4's {N_POINTS} points at depth {DEPTH} "
        f"{out['uniform_tree_s']:.3f} s; its box sort native "
        f"{out['sort_native_s']:.3f} s, numpy {out['sort_numpy_s']:.3f} s, "
        f"permutations identical {same}")
    del xs, keys, perm_n, perm_p, tree
    rng = np.random.default_rng(10)
    x10 = sphere_cloud(TREE10_N, rng)
    t = time.perf_counter()
    pt = PtTree(3).update_refinement(x10, TREE10_MAX_PTS, balance21=True)
    out["pttree_s"] = time.perf_counter() - t
    ok21 = pt.check_2to1()
    out.update(pttree_leaves=pt.n_leaves(), pttree_2to1=ok21,
               pttree_levels=[int(pt.leaf_levels.min()),
                              int(pt.leaf_levels.max())])
    log(f"library PtTree: {TREE10_N} points (80% on a sphere), max_pts "
        f"{TREE10_MAX_PTS}, balance21: {out['pttree_s']:.3f} s, "
        f"{pt.n_leaves()} leaves at levels {out['pttree_levels']}, "
        f"check_2to1 {ok21}")
    del pt, x10

    # ---- 10b: the profiler around a KIFMM eval ----
    x = rng.random((PROF_N, 3))
    f = torch.as_tensor(rng.normal(size=(PROF_N, 1)), dtype=torch.float32,
                        device="cuda")
    t = time.perf_counter()
    kf = KIFMM(Laplace3D_FxU, p=P, depth=PROF_DEPTH, device="cuda",
               dtype=torch.float32).setup(x, x)
    torch.cuda.synchronize()
    out["kifmm_setup_s"] = time.perf_counter() - t
    kf.eval_tensor(f)                                      # warm
    level0 = config.profile_level
    config.profile_level = 0
    Profile.reset()
    ev_ms = []
    try:
        for rep in range(PROF_REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            u = kf.eval_tensor(f * (1.0 + 1e-6 * rep))
            e1.record()
            torch.cuda.synchronize()
            ev_ms.append(e0.elapsed_time(e1))
        report = Profile.print_report(fields=("t", "f", "f/s"),
                                      out=io.StringIO())
        flop = Profile.get_counter("FLOP")
    finally:
        config.profile_level = level0
    for ln in report.splitlines():
        log(f"library profile report: {ln}")
    rows = _report_blocks(report)
    blk_ms = [1e3 * s for name, s in rows if name == "KIFMM::Eval"]
    model = kf._flop_model()
    med_blk, med_ev = float(np.median(blk_ms)), float(np.median(ev_ms))
    ratio = med_blk / med_ev
    out.update(profile_block_ms=blk_ms, profile_events_ms=ev_ms,
               profile_ratio=ratio, flop_counter=flop, flop_model=model,
               kifmm_routes=dict(surface=kf.surface_route,
                                 near=kf.near_route,
                                 m2l=kf._ops.m2l_route))
    log(f"library profile: KIFMM(p={P}, depth {PROF_DEPTH}, float32) on "
        f"{PROF_N} points, setup {out['kifmm_setup_s']:.2f} s; the "
        f"KIFMM::Eval block (sync) median {med_blk:.3f} ms of "
        f"{['%.3f' % b for b in blk_ms]}, CUDA events over eval_tensor "
        f"median {med_ev:.3f} ms of {['%.3f' % e for e in ev_ms]}, ratio "
        f"{ratio:.4f} (bar 1 +- {PROF_BAR:g}); FLOP counter {flop:.6e}, "
        f"{PROF_REPS} x _flop_model {PROF_REPS * model:.6e}; on '{smi}'")
    if not (len(blk_ms) == PROF_REPS and abs(ratio - 1) <= PROF_BAR
            and flop == PROF_REPS * model and len(rows) == PROF_REPS):
        raise SystemExit(f"chip_smoke: the profiler: blocks {rows}, ratio "
                         f"{ratio:.4f}, FLOP {flop} against "
                         f"{PROF_REPS * model}")
    # where the 1e6-point eval's time goes: its stages and the card's
    # busy share
    fp, fo = kf.pad_density(f)
    out["stage_ms"] = _stage_ms(torch, lambda marks: kf._eval_impl(
        fp, fo, marks))
    log("library profile: stage ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["stage_ms"].items()))
    out["busy_ms"] = profile_eval(torch, kf, fp, fo, med_ev / 1e3)
    del kf, f, u, x, fp, fo
    torch.cuda.empty_cache()

    # ---- 10d: Matrix.pinv and a KrylovPrecond checkpoint ----
    g = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn(PINV_SHAPE, generator=g, dtype=torch.float64,
                    device="cuda")
    t = time.perf_counter()
    pc = Matrix(A).pinv().data
    torch.cuda.synchronize()
    out["pinv_card_s"] = time.perf_counter() - t
    ph = Matrix(A.cpu()).pinv().data
    out["pinv_err"] = float((pc.cpu() - ph).abs().max() / ph.abs().max())
    M = (torch.eye(KRYLOV_N, dtype=torch.float64, device="cuda")
         + torch.randn((KRYLOV_N, KRYLOV_N), generator=g,
                       dtype=torch.float64, device="cuda") / KRYLOV_N)
    kp = KrylovPrecond()
    b = torch.randn(KRYLOV_N, generator=g, dtype=torch.float64,
                    device="cuda")
    _, it_kp = gmres(lambda s: M @ s, b, tol=1e-10, krylov_precond=kp)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_krylov_precond(tmp + "/kp", kp)
        kp2 = checkpoint.restore_krylov_precond(tmp + "/kp")
        state = {"b": b, "pairs": [list(p) for p in kp._pairs]}
        checkpoint.save(tmp + "/state", state)
        back = checkpoint.restore(tmp + "/state", like=state)
    same_kp = (kp2.size() == kp.size() and len(kp2._pairs) == len(kp._pairs)
               and all(torch.equal(a, c) and c.is_cuda
                       for p, q in zip(kp._pairs, kp2._pairs)
                       for a, c in zip(p, q))
               and torch.equal(back["b"], b) and back["b"].is_cuda)
    out.update(krylov_rank=kp.rank(), krylov_iters=it_kp,
               krylov_restored=same_kp)
    log(f"library containers: Matrix.pinv {PINV_SHAPE} float64 on the card "
        f"{out['pinv_card_s']:.3f} s, against the CPU's "
        f"{out['pinv_err']:.3e} (bar {PINV_BAR:g}); KrylovPrecond of rank "
        f"{kp.rank()} ({it_kp} iterations) saved and restored on the card "
        f"bit for bit {same_kp}")
    del A, pc, ph, M, kp, kp2, back, state

    # ---- 10c: KIFMMLd's rung against the card's float64 p2p ----
    proc, path, t_start = ld
    t = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t
    if rc:
        raise SystemExit(f"chip_smoke: the KIFMMLd rung's process failed "
                         f"with code {rc}")
    z = np.load(path)
    rng = np.random.default_rng(LD_SEED)
    xl = rng.random((LD_N, 3))
    fl = rng.normal(size=(LD_N, 1))
    c64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    ud = direct_eval_blocked(Laplace3D_FxU, c64(xl), c64(xl),
                             c64(fl)).cpu().numpy()
    ld_err = float(np.abs(z["u"] - ud).max() / np.abs(ud).max())
    out.update(ld_p=LD_P, ld_depth=LD_DEPTH, ld_setup_s=float(z["setup_s"]),
               ld_eval_s=float(z["eval_s"]), ld_tables=str(z["tables"]),
               ld_waited_s=waited, ld_err=ld_err)
    log(f"library KIFMMLd: p={LD_P}, depth {LD_DEPTH}, {LD_N} points, "
        f"rcond {LD_RCOND:g}, in a host process from {t_start - T0:.1f} s: "
        f"setup {out['ld_setup_s']:.2f} s (tables {out['ld_tables']}), "
        f"eval {out['ld_eval_s']:.2f} s; waited {waited:.2f} s; rel err "
        f"against the card's float64 p2p {ld_err:.3e} (bar {LD_BAR:g})")
    launches = read(counters)
    launches["p2p_f64"] = p2p.launches_f64
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"library: phase 10 {out['phase_s']:.1f} s; launches {launches}; "
        f"on '{smi}'")
    fails = []
    if not same:
        fails.append("native and numpy tree sorts differ")
    if not ok21:
        fails.append("PtTree not 2:1 balanced")
    if not out["pinv_err"] <= PINV_BAR:
        fails.append(f"pinv {out['pinv_err']:.3e}")
    if not same_kp:
        fails.append("KrylovPrecond checkpoint")
    if not ld_err < LD_BAR:
        fails.append(f"KIFMMLd rung {ld_err:.3e}")
    if not (launches["p2p_f64"] > 0 and launches["surface_pair"] > 0
            and launches["l2t_surface"] > 0):
        fails.append(f"launches {launches}")
    if fails:
        raise SystemExit("chip_smoke: phase 10 failed: " + "; ".join(fails))
    return launches, out


def phase_bie_laplace_f64(torch, counters, smi, ops5L):
    """5L-f64: the Laplace double layer in float64 on the card on phase
    5f's 16 x 8 torus (4,608 unknowns, one a node), tolerance 1e-6, the far field through the adaptive FMM
    (cutoff 15,000 far nodes; its U list the float64 p2p_ulist's
    Laplace3D-DxU formula), A(s) = D s - s/2, boundary data of a unit
    charge at phase 5's Stokeslet position through the float64 p2p,
    solved by the host gmres to a 1e-10 relative residual.  The far
    field's tables are phase 5L's where they are of the same (kernel, p,
    rcond)."""
    import contextlib
    import io
    import numpy as np
    from sctl_tpu_torch.bie import BoundaryIntegralOp, torus_patches
    from sctl_tpu_torch.kernel_cases import rel_max_err, ulist_main_work
    from sctl_tpu_torch.linalg import gmres
    from sctl_tpu_torch.ops import (Laplace3D_DxU, Laplace3D_FxU,
                                    direct_eval_blocked)
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    f64 = torch.float64
    reset(counters)
    p2p_ulist.launches_f64 = 0
    t = time.perf_counter()
    lst = torus_patches(nu=F64_NU, nv=F64_NV, q=6, R=2.0, r=0.5)
    op = BoundaryIntegralOp(Laplace3D_DxU, device="cuda", dtype=f64)
    op.set_accuracy(BIE_TOL)
    op.add_elem_list(lst)
    op.far_fmm_cutoff = F64_CUTOFF
    shared = (ops5L.ker_trans.name == "Laplace3D-FxU"
              and ops5L.p == op.far_fmm_p and ops5L.rcond == 1e-9)
    op.far_fmm_operators = ops5L if shared else None
    op.setup()
    setup_s = time.perf_counter() - t
    af = op._far_fmm
    if af is None or af.dtype != f64:
        raise SystemExit("chip_smoke: the float64 Laplace BIE far field did "
                         "not take the adaptive FMM in float64")
    log(f"bie laplace f64 setup: {setup_s:.2f} s ("
        + ("phase 5L's operator tables" if shared else
           "phase 5L's tables are of another (kernel, p, rcond): built")
        + "); by stage s " + ", ".join(
        f"{k} {v:.2f}" for k, v in op.setup_times.items())
        + f"; unknowns {op.dim(0)}, far nodes {len(op.Xf)}, leaves "
        f"{af.n_leaf}, levels {af.L}, near pairs {len(op.near_pairs)}, "
        f"host per-pair fallback pairs {op._near_fallback_count}; near "
        f"engine s " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in op._near_prof.items()) + f"; on '{smi}'")

    X, _, _ = lst.get_node_coord()
    src, qs = np.array([BIE_SRC2]), np.ones((1, 1))
    c64 = lambda a: torch.as_tensor(a, dtype=f64, device="cuda")
    b = direct_eval_blocked(Laplace3D_FxU, c64(X), c64(src),
                            c64(qs)).reshape(-1)

    def A(sig):
        return op.compute_potential_tensor(sig).reshape(-1) - 0.5 * sig

    sig0 = torch.randn(b.shape, dtype=f64, device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(3))
    A(sig0)                                                 # warm
    apply_s, apply_all = _median_time(
        torch, lambda rep: A(sig0 * (1.0 + 1e-6 * (rep + 1))), 5)
    n64 = p2p_ulist.launches_f64
    A(sig0)
    per_apply = p2p_ulist.launches_f64 - n64
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        x, iters = gmres(A, b, tol=F64_TOL, max_iter=F64_MAX_ITER,
                         verbose=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    last = buf.getvalue().strip().splitlines()[-1]
    resid_est = float(last.split()[-1]) / float(torch.linalg.vector_norm(b))
    resid = rel_resid(torch, A, x, b)
    launches = read(counters)
    launches_f64 = p2p_ulist.launches_f64
    interior = interior_error(torch, lst, op, x, src, qs, Laplace3D_DxU,
                              Laplace3D_FxU)
    log(f"bie laplace f64: apply s {['%.4f' % a for a in apply_all]}, "
        f"median {apply_s:.4f} s; solve {solve_s:.3f} s, {iters} iterations "
        f"(host gmres to {F64_TOL:g}), residual {resid_est:.3e} as returned, "
        f"{resid:.3e} recomputed (bar {F64_RESID_BAR:g}); interior rel err "
        f"vs the exact potential {interior:.3e} (bar {BIE_INTERIOR_BAR:g}); "
        f"p2p_ulist float64 launches {launches_f64} ({per_apply} an "
        f"apply); on '{smi}'")

    # the float64 U-list kernel (Laplace3D-DxU) on one apply's inputs
    fp = af.pad_density(torch.randn((len(op.Xf), 1), dtype=f64,
                                    device="cuda"))
    args = af.ulist_args(fp)
    ul_ms = cuda_ms(torch, lambda: p2p_ulist(af.ker_s2t, *args), 10)
    plain_ms = cuda_ms(torch, lambda: p2p_ulist_plain(af.ker_s2t, *args), 3)
    out_k = p2p_ulist(af.ker_s2t, *args)
    err = rel_max_err(out_k, p2p_ulist_plain(af.ker_s2t, *args))
    work = ulist_main_work(af)
    b_ms, b_by = bound(work)
    log(f"bie laplace f64 U list: p2p_ulist[{af.ker_s2t.name}] float64 "
        f"{ul_ms:.4f} ms per apply, plain {plain_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), pairs {work['pairs']}; against its plain "
        f"version in float64 {err:.3e} (bar {ORACLE_BAR:g}); on '{smi}'")
    del fp, args, out_k
    if not (np.isfinite(resid) and resid <= F64_RESID_BAR
            and np.isfinite(resid_est) and resid_est <= F64_TOL
            and np.isfinite(interior) and interior <= BIE_INTERIOR_BAR
            and iters < F64_MAX_ITER):
        raise SystemExit(f"chip_smoke: float64 Laplace BIE solve failed: "
                         f"residual {resid:.3e} ({resid_est:.3e} returned), "
                         f"interior {interior:.3e}, iterations {iters}")
    if not (per_apply >= 1 and launches_f64 >= iters + 1
            and err < ORACLE_BAR):
        raise SystemExit(f"chip_smoke: float64 Laplace BIE U list: "
                         f"{per_apply} launches an apply, {launches_f64} in "
                         f"the phase, error {err:.3e}")
    summary = dict(setup_s=setup_s, setup_by_stage=op.setup_times,
                   near_engine=op._near_prof, shared_tables=shared,
                   fallback_pairs=op._near_fallback_count, apply_s=apply_s,
                   solve_s=solve_s, iterations=iters,
                   resid_returned=resid_est, resid=resid, interior=interior,
                   unknowns=op.dim(0), ulist_f64_ms=ul_ms,
                   ulist_f64_plain_ms=plain_ms, ulist_bound_ms=b_ms,
                   ulist_pairs=work["pairs"], ulist_err=err,
                   ulist_f64_launches=launches_f64,
                   ulist_f64_per_apply=per_apply)
    return launches, summary


# phase 11, the distributed layer: 11a one rank over NCCL against the
# self-communicator, bit for bit; 11b-11f four gloo ranks sharing the
# card (NCCL refuses two ranks of one communicator on one device: "Duplicate
# GPU detected"), each on its own tensors on the card: 11b every verb,
# then KIFMMDist at bench_fmm's width (phase 4's field and depth), 11c
# the ring direct sum, 11d DistPtTree and AdaptiveFMM.eval_sharded, 11e
# the row-sharded GMRES and SDC(comm=), 11f the distributed BIE at
# bench_bie's width
DIST_RANKS, DIST_DEVICE = 4, "cuda"
DIST_TIMEOUT = 480
NCCL_N = 20_000
RING_N, RING_SEED = 100_000, 13
SHARDED_N, SHARDED_P, SHARDED_MAX_PTS, SHARDED_BAR = 200_000, 4, 128, 1e-10
DIST_GMRES_N, DIST_GMRES_TOL, DIST_RESID_BAR = 4096, 1e-10, 1e-12
DIST_SDC_P, DIST_SDC_T = 64, 0.25
DIST_CHECK_BOXES = 1024
# 11f: phase 5's problem over the four ranks: the sharded apply against
# phase 5's within 30 tol (the bar of the reference's own comparison of
# two engines, tests/test_near_device.py:111-126, as 5h), the iterations
# within 2 of phase 5's; the direct-regime case (sphere_patches(1),
# Laplace3D-DxU) against its single-process apply
BIE_TORUS = dict(nu=48, nv=20, q=6, R=2.0, r=0.5)      # phase 5's surface
BIE_DIST_APPLY_BAR, BIE_DIST_ITER_SLACK = 3e-5, 2
BIE_DIST_DIRECT_TOL, BIE_DIST_DIRECT_BAR = 1e-6, 1e-5


def sphere_cloud(n, rng):
    """10a's point cloud: 80% on a sphere of radius 0.3 about (0.5, 0.5,
    0.5), 20% uniform, drawn from the generator rng (10a's is
    default_rng(10))."""
    import numpy as np
    n_sph = int(0.8 * n)
    v = rng.normal(size=(n_sph, 3))
    return np.concatenate([0.5 + 0.3 * v / np.linalg.norm(v, axis=1)[:, None],
                           rng.random((n - n_sph, 3))])


def _dist_counters():
    from sctl_tpu_torch.ops.p2p import p2p, p2p_ulist
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    return {"surface_pair": surface_pair, "l2t_surface": l2t_surface,
            "p2p_ulist": p2p_ulist, "p2p": p2p}


def verb_outputs(torch, comm, dev):
    """Every Comm method and verb on deterministic inputs on `dev` ->
    {name: tensor or tuple}: rank r's x is arange(4) + r."""
    from sctl_tpu_torch.comm import verbs as V
    r, p = comm.rank(), comm.size()
    x = torch.arange(4, dtype=torch.float32, device=dev) + r
    out = {"sum": comm.allreduce(x), "max": comm.allreduce(x, "max"),
           "min": comm.allreduce(x, "min"),
           "scan": comm.scan(x, exclusive=True),
           "bcast": comm.bcast(x, p - 1),
           "allgather": comm.allgather(x, tiled=True),
           "alltoall": comm.alltoall(
               torch.arange(2 * p, dtype=torch.float32, device=dev) + 10 * r),
           "shift": comm.send_recv_shift(x, 1),
           "pairs": comm.send_recv(x, [(0, p - 1)], fill=-1.0)}
    comm.barrier()
    g = torch.Generator().manual_seed(100 + r)
    n = 8 + 2 * r
    keys = torch.rand(16, generator=g, dtype=torch.float64).to(dev)
    data = torch.rand(16, generator=g, dtype=torch.float64).to(dev)
    dest = torch.randint(0, p, (16,), generator=g).to(dev)
    total = sum(8 + 2 * q for q in range(p))
    tgt = torch.tensor([total // p + (q < total % p) for q in range(p)],
                       device=dev)
    out["route"] = V.route(comm, data, n, dest, 16 * p)
    out["route_ring"] = V.route(comm, data, n, dest, 16 * p, impl="ring")
    out["alltoallv"] = V.alltoallv(comm, data,
                                   torch.bincount(dest[:n], minlength=p)
                                   if p > 1 else torch.tensor([n]), 16 * p)
    out["sort"] = V.global_sort(comm, keys, n, payload=data,
                                capacity=16 * p)
    out["partition_n"] = V.partition_n(comm, data, n, tgt, 16 * p)
    out["partition_w"] = V.partition_w(comm, data, n, data + 0.5, 16 * p)
    idx = V.sort_scatter_index(comm, keys, n, capacity=16 * p)
    fwd, fc = V.scatter_forward(comm, data, n, idx, capacity=16 * p)
    rev, _ = V.scatter_reverse(comm, fwd, fc, idx, n, capacity=16 * p)
    out["scatter"] = (idx, fwd, fc, rev)
    return out


def _flat(torch, v):
    return [t.detach().cpu() for t in (v if isinstance(v, tuple) else (v,))]


def _unequal(torch, a, b):
    """Names of the outputs of two verb_outputs that differ bit for
    bit."""
    bad = []
    for k in a:
        for x, y in zip(_flat(torch, a[k]), _flat(torch, b[k])):
            if x.shape != y.shape or not torch.equal(x, y):
                bad.append(k)
                break
    return bad


def _rank_11a(comm, cfg):
    """11a on a one-rank NCCL group: each verb, KIFMMDist and the ring
    through the group against the self-communicator, bit for bit."""
    import numpy as np
    import torch
    from sctl_tpu_torch.comm import Comm
    from sctl_tpu_torch.fmm import ParticleFMM
    from sctl_tpu_torch.fmm.kifmm_dist import KIFMMDist
    from sctl_tpu_torch.ops import Laplace3D_FxU
    dev = torch.device(DIST_DEVICE)
    counters = _dist_counters()
    reset(counters)
    one = Comm.self_()
    out = {"backend": comm.backend, "size": comm.size()}
    out["verbs_unequal"] = _unequal(torch, verb_outputs(torch, comm, dev),
                                    verb_outputs(torch, one, dev))
    rng = np.random.default_rng(5)
    x = rng.random((NCCL_N, 3))
    f = rng.normal(size=(NCCL_N, 1))
    u = [KIFMMDist(Laplace3D_FxU, c, p=P, depth=3, device=dev).setup(x, x)
         .eval(f) for c in (comm, one)]
    out["kifmm_equal"] = bool(np.array_equal(u[0], u[1]))
    xt, ft = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (x, f))
    ur = [ParticleFMM(c, device=dev).eval_direct_ring(Laplace3D_FxU, xt, xt,
                                                      ft) for c in (comm, one)]
    out["ring_equal"] = bool(torch.equal(ur[0], ur[1]))
    out["launches"] = read(counters)
    return out


def _timed(torch, comm, fn):
    """(result, seconds) of fn() ending in a synchronize and a barrier,
    started after one."""
    torch.cuda.synchronize()
    comm.barrier()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    comm.barrier()
    return res, time.perf_counter() - t


def _slab_kernel_rows(torch, fmm, fp, fp_h):
    """11b's kernels on this rank's own slab (fp its densities, fp_h
    with the halo planes): each against its plain version on the slab's
    DIST_CHECK_BOXES fullest boxes (bar KERNEL_BAR), and alone at the
    slab's full shapes against its bound."""
    from sctl_tpu_torch.kernel_cases import (l2t_surface_work,
                                             p2p_ulist_work, rel_max_err,
                                             surface_pair_work)
    from sctl_tpu_torch.ops import Laplace3D_FxU as K
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    from sctl_tpu_torch.ops.sl import (l2t_surface, l2t_surface_plain,
                                       surface_pair, surface_pair_plain)
    ns, B, cs, ct = fmm._ops.n_surf, fmm.B, fmm.cap_s, fmm.cap_t
    g = DIST_CHECK_BOXES
    surf = fmm.surf_out_L
    f_l = fp.reshape(1, -1)
    sel = torch.argsort(fmm.cnt_s_box + fmm.cnt_t_box, descending=True)[:g]
    pick = lambda a, cap: a.reshape(a.shape[0], B, cap)[:, sel] \
        .reshape(a.shape[0], -1).contiguous()
    head = lambda a, n: pick(a, n // g)
    q_cm = torch.randn((1, ns, B), device=fp.device)
    fp_h = fp_h.reshape(-1, 1)
    ul = lambda b: (K, fmm.near_xt[b].contiguous(), fmm.near_xs, None, fp_h,
                    fmm.near_rng[b].contiguous(),
                    fmm.cnt_t_box[b].contiguous(), fmm.near_fidx)
    calls = {
        "surface_pair": (
            lambda: surface_pair(K, surf, head(fmm.xs_sl, g * cs),
                                 head(f_l, g * cs), cs, None,
                                 fmm.cnt_s_box[sel]),
            lambda: surface_pair_plain(K, surf, head(fmm.xs_sl, g * cs),
                                       head(f_l, g * cs), cs, None,
                                       fmm.cnt_s_box[sel]),
            lambda: surface_pair(K, surf, fmm.xs_sl, f_l, cs, None,
                                 fmm.cnt_s_box),
            surface_pair_work(K, ns, B, int(fmm.cnt_s_box.sum()))),
        "l2t_surface": (
            lambda: l2t_surface(K, surf, head(fmm.xt_sl, g * ct),
                                q_cm[:, :, sel].contiguous(), ct,
                                fmm.cnt_t_box[sel]),
            lambda: l2t_surface_plain(K, surf, head(fmm.xt_sl, g * ct),
                                      q_cm[:, :, sel].contiguous(), ct,
                                      fmm.cnt_t_box[sel]),
            lambda: l2t_surface(K, surf, fmm.xt_sl, q_cm, ct, fmm.cnt_t_box),
            l2t_surface_work(K, ns, B, ct, int(fmm.cnt_t_box.sum()))),
        "p2p_ulist": (
            lambda: p2p_ulist(*ul(sel)), lambda: p2p_ulist_plain(*ul(sel)),
            lambda: p2p_ulist(*ul(slice(None))),
            p2p_ulist_work(K, fmm.n_near_pairs, int(fmm.cnt_t_box.sum()),
                           int(fmm.near_fidx.shape[0]))),
    }
    rows = {}
    for name, (run, plain, full, work) in calls.items():
        err = rel_max_err(run(), plain())
        ms = cuda_ms(torch, full, 5)
        b_ms, b_by = bound(work)
        rows[name] = dict(max_rel_err=err, ms=ms, bound_ms=b_ms,
                          bound_by=b_by, pairs=work["pairs"],
                          case=f"the {g} fullest of the slab's {B} boxes")
    return rows


def save_tables(ops, path):
    """A KIFMMOperators' unit tables as .npy files under `path` (the
    ranks of 11f map them, so that each does not build them cold)."""
    import os
    import numpy as np
    for name in ops.TABLES:
        np.save(os.path.join(path, name + ".npy"), getattr(ops, name))
    np.save(os.path.join(path, "p_rcond.npy"), np.array([ops.p, ops.rcond]))


def load_tables(path) -> dict:
    import os
    import numpy as np
    from sctl_tpu_torch.fmm import KIFMMOperators
    t = {name: np.load(os.path.join(path, name + ".npy"), mmap_mode="c")
         for name in KIFMMOperators.TABLES}
    p, rcond = np.load(os.path.join(path, "p_rcond.npy"))
    t.update(p=int(p), rcond=float(rcond))
    return t


def _stage_events(torch, comm, fn):
    """fn(marks) once, after a synchronize and a barrier -> {stage: ms}
    from its CUDA events."""
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    comm.barrier()
    start.record()
    fn(marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = stages.get(name, 0.0) + prev.elapsed_time(ev)
        prev = ev
    return stages


def _rank_11f(torch, comm, bie, counters):
    """11f on each rank: phase 5's bench_bie over the ranks (see the
    module docstring).  bie: phase 5's pairs, density and apply, right-
    hand side, solution, iterations and the directory of its tables."""
    import numpy as np
    from sctl_tpu_torch.bie import (BoundaryIntegralOp, sphere_patches,
                                    torus_patches)
    from sctl_tpu_torch.fmm import operators_from_numpy
    from sctl_tpu_torch.kernel_cases import (p2p_ulist_work, p2p_work,
                                             rel_max_err)
    from sctl_tpu_torch.linalg import gmres_device
    from sctl_tpu_torch.ops import Laplace3D_DxU, Stokes3D_DxU, Stokes3D_FSxU
    from sctl_tpu_torch.ops.p2p import (p2p, p2p_plain, p2p_ulist,
                                        p2p_ulist_plain)
    dev = torch.device(DIST_DEVICE)
    r = comm.rank()
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t_phase = time.perf_counter()

    # ---- setup: the distributed near search and the shared assembly,
    # then the sharded apply's tables and AdaptiveFMMDist ----
    def setup():
        lst = torus_patches(**BIE_TORUS)
        op = BoundaryIntegralOp(Stokes3D_DxU, comm=comm, device=dev,
                                dtype=torch.float32)
        op.set_accuracy(BIE_TOL)
        op.add_elem_list(lst)
        op.far_fmm_operators = operators_from_numpy(
            load_tables(bie["tables"]), dev, torch.float64, Stokes3D_FSxU)
        op.setup()
        t = time.perf_counter()
        sh = op.sharded_apply(comm)
        torch.cuda.synchronize()
        op.setup_times["sharded_apply"] = time.perf_counter() - t
        return lst, op, sh

    (lst, op, sh), out["setup_s"] = _timed(torch, comm, setup)
    fm = sh._fmm
    out.update(setup_stages=dict(op.setup_times), near_prof={
        k: v for k, v in op._near_prof.items() if isinstance(v, float)},
        pairs_equal=bool(np.array_equal(
            np.asarray(op.near_pairs, np.int64).reshape(-1, 2), bie["pairs"])),
        caps_grown=op._near_caps_grown, Crg=fm.Crg, Cb=fm.Cb,
        n_leaf=fm.n_leaf, n_own=sh.n_own, n_near=sh.n_near,
        ulist_pairs=fm.n_ulist_pairs, ulist_sources=int(fm.ul_xs.shape[1]),
        setup_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # ---- the sharded apply: warm, three timed with fresh densities,
    # the stages by CUDA events, the gathered apply against phase 5's ----
    sig_loc = sh.pack(bie["sig0"])
    _timed(torch, comm, lambda: sh.apply(sig_loc))
    out["apply_s"] = [_timed(torch, comm, lambda k=k: sh.apply(
        sig_loc * (1.0 + 1e-6 * (k + 1))))[1] for k in range(3)]
    out["stage_ms"] = _stage_events(torch, comm,
                                    lambda marks: sh.apply(sig_loc, marks))
    u = sh.unpack(sh.apply(sig_loc))
    out["apply_err"] = float(np.abs(u - bie["u0"]).max()
                             / np.abs(bie["u0"]).max())

    # ---- the row-sharded solve ----
    b_loc = sh.pack(bie["b"])
    A_sh = lambda s: sh.apply(s).reshape(-1) - 0.5 * s
    (x_loc, it, _), out["solve_s"] = _timed(torch, comm, lambda: gmres_device(
        A_sh, b_loc, tol=BIE_TOL, max_iter=BIE_MAX_ITER, comm=comm))
    out["iters"] = int(it)
    x = sh.unpack(x_loc).reshape(-1)

    # ---- the direct regime: each rank's far nodes through p2p ----
    op_d = BoundaryIntegralOp(Laplace3D_DxU, comm=comm, device=dev,
                              dtype=torch.float32)
    op_d.set_accuracy(BIE_DIST_DIRECT_TOL)
    op_d.add_elem_list(sphere_patches(n_per_face=1, q=6))
    sh_d = op_d.sharded_apply(comm)
    sig_d = np.random.default_rng(17).normal(size=op_d.dim(0))
    u_d = sh_d.unpack(sh_d.apply(sh_d.pack(sig_d)))
    torch.cuda.synchronize()
    out["launches"] = read(counters)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["direct_fmm"] = sh_d._fmm is not None

    # ---- p2p_ulist on rank 0's block: own targets, ghost sources (the
    # far route and the ghost exchange are collective) ----
    ext = fm._ghost_exchange(sh.leaf_density(sig_loc))
    if r == 0:
        K = fm._afmm.ker_s2t
        args = fm.ulist_args(ext)
        out["ulist_err"] = rel_max_err(p2p_ulist(K, *args),
                                       p2p_ulist_plain(K, *args))
        out["ulist_ms"] = cuda_ms(torch, lambda: p2p_ulist(K, *args), 5)
        out["ulist_plain_ms"] = cuda_ms(torch,
                                        lambda: p2p_ulist_plain(K, *args), 1)
        work = p2p_ulist_work(K, fm.n_ulist_pairs, int(fm.ul_tcnt.sum()),
                              int(fm.ul_xs.shape[1]))
        out["ulist_bound_ms"], out["ulist_bound_by"] = bound(work)
        out["direct_err"] = _rel(u_d, op_d.compute_potential(sig_d))
        # p2p at the direct regime's shapes: the replicated targets, rank
        # 0's far nodes and normals, its far densities
        K = op_d.kernel
        pa = (sh_d.Xt_rep, sh_d.Xf_own, sh_d.Xnf_own, sh_d._far_density(
            sh_d.pack(sig_d).reshape(-1, sh_d.k0)))
        out["p2p_err"] = rel_max_err(p2p(K, *pa), p2p_plain(K, *pa))
        out["p2p_ms"] = cuda_ms(torch, lambda: p2p(K, *pa), 5)
        out["p2p_plain_ms"] = cuda_ms(torch, lambda: p2p_plain(K, *pa), 1)
        out["p2p_shape"] = (pa[0].shape[0], pa[1].shape[0])
        out["p2p_bound_ms"], out["p2p_bound_by"] = bound(p2p_work(
            K, pa[3].dtype, *out["p2p_shape"]))
        # the solution through the single-process op on this rank
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        bt = torch.as_tensor(bie["b"], device=dev)
        out["resid"] = rel_resid(torch, lambda s: op.compute_potential_tensor(
            s).reshape(-1) - 0.5 * s, xt, bt)
        out["interior"] = interior_error(
            torch, lst, op, xt, np.array([[6.0, 0.0, 0.0]]),
            np.array([[1.0, -0.5, 0.8]]))
        out["x_diff"] = float(np.linalg.norm(x - bie["x"])
                              / np.linalg.norm(bie["x"]))
    comm.barrier()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _rank_ulist_ghosts(comm, cfg):
    """A rank's U-list block of a 4-rank AdaptiveFMMDist on the card
    (its own target leaves, ghost sources among them) against the plain
    version: (max rel error, ghost leaves).  cfg: "f32" or "f64"."""
    import numpy as np
    import torch
    from sctl_tpu_torch.fmm import AdaptiveFMMDist
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.ops import Stokes3D_DxU as K
    from sctl_tpu_torch.ops.p2p import p2p_ulist, p2p_ulist_plain
    dt = torch.float32 if cfg == "f32" else torch.float64
    x = sphere_cloud(20_000, np.random.default_rng(42))
    nrm = np.random.default_rng(45).normal(size=x.shape)
    fm = AdaptiveFMMDist(K, comm, p=4, max_pts=128, device="cuda",
                         dtype=dt).setup(x, x, n_src=nrm)
    f = np.random.default_rng(43).normal(size=(len(x), 3))
    ext = fm._ghost_exchange(fm.pad_density(torch.as_tensor(
        f[fm.src_index], device="cuda")))
    args = fm.ulist_args(ext)
    return rel_max_err(p2p_ulist(K, *args), p2p_ulist_plain(K, *args)), \
        fm.Crg


def _rank_dist(comm, cfg):
    """11b-11f on each of the four gloo ranks (see the constants); cfg:
    phase 5's figures that 11f reads (`_rank_11f`)."""
    import numpy as np
    import torch
    from sctl_tpu_torch.fmm import AdaptiveFMM, ParticleFMM
    from sctl_tpu_torch.fmm.kifmm_dist import KIFMMDist
    from sctl_tpu_torch.kernel_cases import rel_max_err
    from sctl_tpu_torch.linalg import SDC, SphericalHarmonics, gmres, sh_dim
    from sctl_tpu_torch.linalg.sph_harm import _packed_index
    from sctl_tpu_torch.ops import Laplace3D_FxU
    from sctl_tpu_torch.ops.p2p import p2p, p2p_plain, p2p_ulist, \
        p2p_ulist_plain
    from sctl_tpu_torch.tree.dist_tree import DistPtTree
    dev = torch.device(DIST_DEVICE)
    r, p = comm.rank(), comm.size()
    counters = _dist_counters()
    out = {}
    t_rank = time.perf_counter()

    # ---- 11b: the verbs on CUDA tensors, then on CPU tensors ----
    got, cpu = verb_outputs(torch, comm, dev), verb_outputs(
        torch, comm, torch.device("cpu"))
    a4 = torch.arange(4, dtype=torch.float32)
    want = {"sum": p * a4 + p * (p - 1) / 2, "max": a4 + p - 1, "min": a4,
            "scan": r * a4 + r * (r - 1) / 2, "bcast": a4 + p - 1,
            "allgather": torch.cat([a4 + q for q in range(p)]),
            "alltoall": torch.tensor([v for q in range(p)
                                      for v in (2 * r + 10 * q,
                                                2 * r + 1 + 10 * q)],
                                     dtype=torch.float32),
            "shift": a4 + (r - 1) % p,
            "pairs": a4 if r == p - 1 else torch.full((4,), -1.0)}
    out["verbs_wrong"] = [k for k, v in want.items()
                          if not torch.equal(got[k].cpu(), v)]
    out["verbs_cuda_vs_cpu"] = _unequal(torch, got, cpu)
    del got, cpu

    # ---- 11b: KIFMMDist at bench_fmm's width ----
    rng = np.random.default_rng(0)
    xs = rng.random((N_POINTS, 3))
    f = rng.normal(size=(N_POINTS, 1))
    fmm, out["setup_s"] = _timed(torch, comm, lambda: KIFMMDist(
        Laplace3D_FxU, comm, p=P, depth=DEPTH, device=dev,
        dtype=torch.float32).setup(xs, xs))
    out.update(planes=fmm.planes, cap_s=fmm.cap_s, cap_t=fmm.cap_t,
               l_shard_min=fmm.l_shard_min,
               surface_route=fmm.surface_route,
               near_pairs=fmm.n_near_pairs,
               near_sources=int(fmm.near_fidx.shape[0]))
    f_loc = torch.as_tensor(f[fmm.src_index], dtype=torch.float32,
                            device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    _timed(torch, comm, lambda: fmm.eval_tensor(f_loc))          # warm
    times = [_timed(torch, comm, lambda k=k: fmm.eval_tensor(
        f_loc * (1.0 + 1e-6 * (k + 1))))[1] for k in range(3)]
    out["launches_b"] = read(counters)
    out["eval_s"] = times
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    marks = []
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    comm.barrier()
    start.record()
    fmm.eval_tensor(f_loc, marks)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in marks:
        stages[name] = stages.get(name, 0.0) + prev.elapsed_time(ev)
        prev = ev
    out["stage_ms"] = stages
    fp = fmm.pad_density(f_loc)
    fp_h = fmm._halo_x(fp.reshape(fmm.planes, -1, fmm.cap_s, 1), 1)
    comm.barrier()
    if r == 0:
        out["kernels"] = _slab_kernel_rows(torch, fmm, fp, fp_h)
    comm.barrier()
    u = fmm.eval(f)
    out["u"] = u.astype(np.float32) if r == 0 else None
    del fmm, f_loc, u, xs, f, fp, fp_h
    torch.cuda.empty_cache()

    # ---- 11c: the ring direct sum, RING_N points ----
    rng = np.random.default_rng(RING_SEED)
    X = rng.random((RING_N, 3))
    F = rng.normal(size=(RING_N, 1))
    m = RING_N // p
    blk = lambda a: torch.as_tensor(a[r * m:(r + 1) * m],
                                    dtype=torch.float32, device=dev)
    xr, fr = blk(X), blk(F)
    reset(counters)
    ring = ParticleFMM(comm, device=dev)
    out["ring_u"], out["ring_s"] = _timed(torch, comm, lambda: ring
                                          .eval_direct_ring(Laplace3D_FxU,
                                                            xr, xr, fr))
    out["launches_c"] = read(counters)
    if r == 0:
        sub = slice(0, 1024)
        out["ring_p2p_err"] = rel_max_err(
            p2p(Laplace3D_FxU, xr[sub], xr, None, fr),
            p2p_plain(Laplace3D_FxU, xr[sub], xr, None, fr))

    # ---- 11d: DistPtTree of 10a's cloud, AdaptiveFMM.eval_sharded ----
    x10 = sphere_cloud(TREE10_N, np.random.default_rng(10))
    C = TREE10_N // p
    tree = DistPtTree(comm, leaf_cap=1 << 18, pt_cap=2 * C, max_level=15)
    (lk, ll, nl, _, oc), out["tree_s"] = _timed(torch, comm, lambda: tree
                                                .build_fn(TREE10_MAX_PTS,
                                                          balance21=True)(
        torch.as_tensor(x10[r * C:(r + 1) * C], device=dev), C))
    out.update(tree_points=oc, tree_leaves=nl)
    out["tree"] = ((lk[:nl].cpu().numpy(), ll[:nl].cpu().numpy())
                   if r == 0 else None)
    del x10, lk, ll
    xa = sphere_cloud(SHARDED_N, np.random.default_rng(14))
    fa = np.random.default_rng(15).normal(size=(SHARDED_N, 1))
    af, out["adaptive_setup_s"] = _timed(torch, comm, lambda: AdaptiveFMM(
        Laplace3D_FxU, p=SHARDED_P, max_pts=SHARDED_MAX_PTS, device=dev,
        dtype=torch.float64).setup(xa, xa))
    reset(counters)
    u_sh, out["sharded_s"] = _timed(torch, comm,
                                    lambda: af.eval_sharded(fa, comm))
    out["launches_d"] = read(counters)
    if r == 0:
        u1, out["single_s"] = _host_s(torch, lambda: af.eval(fa))
        out["sharded_err"] = float(np.abs(u_sh - u1).max()
                                   / np.abs(u1).max())
        b = slice(0, 256)
        fp = af.pad_density(torch.as_tensor(fa, device=dev))
        out["ulist_block_err"] = rel_max_err(
            p2p_ulist(af.ker_s2t, *af.ulist_args(fp, b)),
            p2p_ulist_plain(af.ker_s2t, *af.ulist_args(fp, b)))
    comm.barrier()
    del af

    # ---- 11e: the row-sharded GMRES, SDC over the ranks ----
    rng = np.random.default_rng(3)
    N = DIST_GMRES_N
    A = rng.random((N, N)) / N + np.eye(N)
    b = rng.random(N)
    rows = slice(r * N // p, (r + 1) * N // p)
    A_r = torch.as_tensor(A[rows], device=dev)
    b_r = torch.as_tensor(b[rows], device=dev)
    del A
    op = lambda v: A_r @ comm.allgather(v, tiled=True)
    (x, it), out["gmres_s"] = _timed(torch, comm, lambda: gmres(
        op, b_r, tol=DIST_GMRES_TOL, comm=comm))
    res = op(x) - b_r
    out["gmres_iters"] = it
    out["gmres_resid"] = float(torch.sqrt(comm.allreduce(
        (res * res).sum())) / np.linalg.norm(b))
    sh = SphericalHarmonics(DIST_SDC_P, device=dev)
    lv = _packed_index(DIST_SDC_P)[0]
    c0 = np.random.default_rng(16).normal(
        size=(DIST_RANKS, sh_dim(DIST_SDC_P))) * np.exp(-lv / SDC_DAMP)
    calls, steps = [0], []

    def rhs(u):
        calls[0] += 1
        return -sh.shc2grid_grad(sh.grid2shc(u))[2]

    (u, t_end, _), out["sdc_s"] = _timed(torch, comm, lambda: SDC(
        SDC_ORDER, comm=comm, device=dev).adaptive_solve(
        SDC_DT0, DIST_SDC_T, sh.shc2grid(c0[r:r + 1]), rhs, SDC_TOL,
        monitor=lambda t, dt, uu: steps.append(dt)))
    out.update(sdc_steps=len(steps), sdc_f_calls=calls[0], sdc_t=t_end,
               sdc_u=u.cpu().numpy())
    del A_r, b_r, op, sh, x, u
    torch.cuda.empty_cache()

    # ---- 11f: phase 5's BIE over the ranks ----
    out["f"] = _rank_11f(torch, comm, cfg, counters)
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def _report_11f(rf, bie, smi, fails):
    """11f's figures from the ranks' results rf against phase 5's (bie):
    printed, checked (a failed bar appends to fails), returned."""
    f0 = rf[0]
    fx = dict(setup_s=[x["setup_s"] for x in rf],
              setup_stages=[x["setup_stages"] for x in rf],
              near_prof=[x["near_prof"] for x in rf],
              apply_s=[x["apply_s"] for x in rf],
              stage_ms=[x["stage_ms"] for x in rf],
              peak_gib=[x["peak_gib"] for x in rf],
              setup_peak_gib=[x["setup_peak_gib"] for x in rf],
              phase5_peak_gib=bie["peak_gib"], phase5_spread=bie["spread"],
              Crg=[x["Crg"] for x in rf], Cb=f0["Cb"],
              n_leaf=f0["n_leaf"], n_own=[x["n_own"] for x in rf],
              n_near=[x["n_near"] for x in rf],
              ulist_pairs=[x["ulist_pairs"] for x in rf],
              pairs_equal=[x["pairs_equal"] for x in rf],
              caps_grown=f0["caps_grown"], apply_err=f0["apply_err"],
              iters=[x["iters"] for x in rf], iters5=bie["iters"],
              solve_s=[x["solve_s"] for x in rf],
              resid=f0["resid"], interior=f0["interior"],
              x_diff=f0["x_diff"], direct_err=f0["direct_err"],
              direct_fmm=f0["direct_fmm"],
              launches=[x["launches"] for x in rf],
              phase_s=[x["phase_s"] for x in rf],
              ulist=dict(max_rel_err=f0["ulist_err"], ms=f0["ulist_ms"],
                         plain_ms=f0["ulist_plain_ms"],
                         bound_ms=f0["ulist_bound_ms"],
                         bound_by=f0["ulist_bound_by"],
                         pairs=f0["ulist_pairs"],
                         case="rank 0's U-list block: its own target leaves, "
                              "own and ghost source leaves"),
              p2p=dict(max_rel_err=f0["p2p_err"], ms=f0["p2p_ms"],
                       plain_ms=f0["p2p_plain_ms"],
                       bound_ms=f0["p2p_bound_ms"],
                       bound_by=f0["p2p_bound_by"],
                       case="the direct regime's far sum on rank 0: %d "
                            "replicated targets, %d far nodes with normals "
                            "(Laplace3D_DxU, float32)" % f0["p2p_shape"]))
    fx["apply_median_s"] = sorted(max(x["apply_s"][k] for x in rf)
                                  for k in range(3))[1]
    log(f"dist 11f: bench_bie over {DIST_RANKS} gloo ranks on one card "
        f"(Stokes3D_DxU, float32, tol {BIE_TOL:g}, {len(bie['b'])} unknowns,"
        f" phase 5's far tables): setup s by rank "
        f"{['%.2f' % s for s in fx['setup_s']]}; by stage " + "; ".join(
            f"rank {q} " + ", ".join(f"{k} {v:.2f}" for k, v in st.items())
            for q, st in enumerate(fx["setup_stages"])))
    log(f"dist 11f: near search pairs equal to phase 5's {fx['pairs_equal']} "
        f"({len(bie['pairs'])} pairs; capacity rounds grown "
        f"{fx['caps_grown']}); leaves {fx['n_leaf']}, {fx['Cb']} a block; "
        f"U-list ghost leaves Crg by rank {fx['Crg']}; nodes by rank "
        f"{fx['n_own']}, near pairs by element owner {fx['n_near']}, U-list "
        f"pairs by rank {fx['ulist_pairs']}")
    log(f"dist 11f: sharded apply s by rank "
        f"{[['%.4f' % s for s in x] for x in fx['apply_s']]}, the slowest "
        f"rank's median {fx['apply_median_s']:.4f} s (phase 5's one process "
        f"and its apply above; four processes share one card); peak GiB by "
        f"rank {['%.2f' % g for g in fx['peak_gib']]} (after setup "
        f"{['%.2f' % g for g in fx['setup_peak_gib']]}; phase 5's one "
        f"process {bie['peak_gib']:.2f})")
    for q, st in enumerate(fx["stage_ms"]):
        log(f"dist 11f: rank {q} stage ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()))
    log(f"dist 11f: the gathered apply against phase 5's {fx['apply_err']:.3e}"
        f" of its maximum (bar {BIE_DIST_APPLY_BAR:g}; two applies of one "
        f"density in phase 5 differ by {bie['spread']:.3e}); solve "
        f"iterations {fx['iters']} (phase 5: {bie['iters']}), s "
        f"{['%.3f' % s for s in fx['solve_s']]}; residual through the "
        f"single-process op {fx['resid']:.3e} (bar {BIE_RESID_BAR:g}); "
        f"interior {fx['interior']:.3e} (bar {BIE_INTERIOR_BAR:g}); the "
        f"solution from phase 5's {fx['x_diff']:.3e} (2-norm, relative)")
    u = fx["ulist"]
    log(f"dist 11f: p2p_ulist on rank 0's block (own targets, ghost sources) "
        f"against its plain version {u['max_rel_err']:.3e} (bar "
        f"{KERNEL_BAR:g}); alone {u['ms']:.4f} ms, plain {u['plain_ms']:.4f} "
        f"ms, bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['pairs']} "
        f"pairs; the direct regime (sphere_patches(1), Laplace3D_DxU, its "
        f"far sums through p2p) against its single-process apply "
        f"{fx['direct_err']:.3e} (bar {BIE_DIST_DIRECT_BAR:g})")
    pp = fx["p2p"]
    log(f"dist 11f: p2p on {pp['case']} against its plain version "
        f"{pp['max_rel_err']:.3e} (bar {KERNEL_BAR:g}); alone {pp['ms']:.4f} "
        f"ms, plain {pp['plain_ms']:.4f} ms, bound {pp['bound_ms']:.4f} ms "
        f"({pp['bound_by']}); launches by "
        f"rank {fx['launches']}; phase 11f s by rank "
        f"{['%.1f' % s for s in fx['phase_s']]}; on '{smi}'")
    if not (all(fx["pairs_equal"]) and max(fx["Crg"]) > 0
            and fx["apply_err"] <= BIE_DIST_APPLY_BAR
            and all(abs(i - bie["iters"]) <= BIE_DIST_ITER_SLACK
                    for i in fx["iters"])
            and fx["resid"] <= BIE_RESID_BAR
            and fx["interior"] <= BIE_INTERIOR_BAR
            and u["max_rel_err"] < KERNEL_BAR and not fx["direct_fmm"]
            and pp["max_rel_err"] < KERNEL_BAR
            and fx["direct_err"] < BIE_DIST_DIRECT_BAR
            and all(x["p2p_ulist"] > 0 and x["p2p"] > 0
                    for x in fx["launches"])):
        fails.append("11f: the distributed BIE")
    return fx


def phase_dist(torch, counters, smi, kept):
    """11: the distributed layer (see the constants above).  kept:
    phase 4's sampled targets, their float64 direct sums and its
    potential; phase 5's figures for 11f ("bie")."""
    import numpy as np
    from sctl_tpu_torch.comm import run_ranks, start_ranks
    from sctl_tpu_torch.linalg import SDC, SphericalHarmonics, gmres, sh_dim
    from sctl_tpu_torch.linalg.sph_harm import _packed_index
    from sctl_tpu_torch.ops import Laplace3D_FxU, direct_eval_blocked
    from sctl_tpu_torch.tree import PtTree
    t_phase = time.perf_counter()
    dev = torch.device(DIST_DEVICE)
    out, fails = {}, []

    # ---- 11a ----
    t = time.perf_counter()
    a = run_ranks(_rank_11a, 1, None, backend="nccl", device=dev,
                  timeout=DIST_TIMEOUT)[0]
    out["11a"] = dict(a, wall_s=time.perf_counter() - t)
    log(f"dist 11a: one {a['backend']} rank against the self-communicator: "
        f"verbs unequal {a['verbs_unequal']}, KIFMMDist equal "
        f"{a['kifmm_equal']}, ring equal {a['ring_equal']}, launches "
        f"{a['launches']}, {out['11a']['wall_s']:.1f} s with the rank's "
        f"start")
    if a["verbs_unequal"] or not (a["kifmm_equal"] and a["ring_equal"]):
        fails.append("11a: the NCCL rank differs from the self-communicator")

    # ---- 11b-11e on four gloo ranks ----
    t = time.perf_counter()
    group = start_ranks(_rank_dist, DIST_RANKS, kept["bie"], backend="gloo",
                        device=dev, timeout=DIST_TIMEOUT)
    res = group.join()
    wall = time.perf_counter() - t
    r0 = res[0]
    b = {"setup_s": [x["setup_s"] for x in res],
         "eval_s": [x["eval_s"] for x in res],
         "peak_gib": [x["peak_gib"] for x in res],
         "stage_ms": [x["stage_ms"] for x in res],
         "launches": [x["launches_b"] for x in res],
         **{k: r0[k] for k in ("planes", "cap_s", "cap_t", "l_shard_min",
                               "surface_route", "near_pairs",
                               "near_sources")}}
    b["eval_median_s"] = sorted(max(x["eval_s"][k] for x in res)
                                for k in range(3))[1]
    u = r0["u"]
    idx, u_ref = kept["idx"], kept["u_ref"]
    b["err"] = float(np.abs(u[idx, 0] - u_ref[:, 0]).max()
                     / np.abs(u_ref).max())
    b["err_vs_phase4"] = float(np.abs(u - kept["u"]).max()
                               / np.abs(kept["u"]).max())
    # over all 1e7 targets the largest differences are phase 4's own
    # errors (its near field differences global float32 coordinates);
    # the bar holds at the sampled targets, and KIFMMDist at the worst
    # ones is held to the oracle below
    b["err_vs_phase4_sampled"] = float(
        np.abs(u[idx] - kept["u"][idx]).max() / np.abs(kept["u"][idx]).max())
    b["kernels"] = r0["kernels"]
    top = np.argsort(np.abs(u - kept["u"])[:, 0])[-5:]
    rng = np.random.default_rng(0)
    x64 = torch.as_tensor(rng.random((N_POINTS, 3)), device=dev)
    f64 = torch.as_tensor(rng.normal(size=(N_POINTS, 1)), device=dev)
    ref_top = direct_eval_blocked(Laplace3D_FxU, x64[top], x64, f64,
                                  block_t=len(top), block_s=1 << 17)
    ref_top = ref_top.cpu().numpy()[:, 0]
    scale = np.abs(u_ref).max()
    b["worst_targets"] = dict(
        index=top.tolist(), dist_err=(np.abs(u[top, 0] - ref_top)
                                      / scale).tolist(),
        phase4_err=(np.abs(kept["u"][top, 0] - ref_top) / scale).tolist())
    del x64, f64
    out["11b"] = b
    log(f"dist 11b: verbs wrong {[x['verbs_wrong'] for x in res]}, CUDA "
        f"against CPU tensors unequal "
        f"{[x['verbs_cuda_vs_cpu'] for x in res]}")
    log(f"dist 11b: KIFMMDist(Laplace3D_FxU, p={P}, depth={DEPTH}, float32) "
        f"on {N_POINTS} points over {DIST_RANKS} gloo ranks on one card: "
        f"{b['planes']} planes a rank, cap_s {b['cap_s']}, cap_t "
        f"{b['cap_t']}, sharded levels >= {b['l_shard_min']}, surface route "
        f"{b['surface_route']}; setup s {['%.2f' % s for s in b['setup_s']]};"
        f" eval s by rank {[['%.4f' % s for s in x] for x in b['eval_s']]}, "
        f"the four ranks' median {b['eval_median_s']:.4f} s (phase 4's one "
        f"process: 0.1077 s; not a speed-up: four processes share one card)"
        f"; peak GiB {['%.2f' % g for g in b['peak_gib']]}")
    for q, st in enumerate(b["stage_ms"]):
        log(f"dist 11b: rank {q} stage ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()) + "; sideband: none "
            "(every box's real points by its count)")
    for name, row in b["kernels"].items():
        log(f"dist 11b: {name} on rank 0's slab ({row['case']}) against its "
            f"plain version {row['max_rel_err']:.3e} (bar {KERNEL_BAR:g}); "
            f"alone at the slab's shapes {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {row['pairs']} "
            f"pairs; launches by rank "
            f"{[x['launches_b'][name] for x in res]}")
        if not row["max_rel_err"] < KERNEL_BAR:
            fails.append(f"11b: {name} against its plain version")
    log(f"dist 11b: at the 5 targets where it and phase 4 differ most, "
        f"errors against the float64 p2p (of its max at the sampled "
        f"targets): KIFMMDist {b['worst_targets']['dist_err']}, phase 4 "
        f"{b['worst_targets']['phase4_err']}")
    log(f"dist 11b: error at {N_SAMPLE} sampled targets against the float64 "
        f"p2p {b['err']:.3e} (bar {FMM_BAR:g}); against phase 4's "
        f"single-device result {b['err_vs_phase4']:.3e} over every target, "
        f"{b['err_vs_phase4_sampled']:.3e} at the sampled ones (bar 1e-4); "
        f"on '{smi}'")
    if any(x["verbs_wrong"] or x["verbs_cuda_vs_cpu"] for x in res):
        fails.append("11b: a verb gave the wrong blocks")
    if not (b["err"] < FMM_BAR and b["err_vs_phase4_sampled"] < 1e-4
            and max(b["worst_targets"]["dist_err"]) < FMM_BAR):
        fails.append("11b: KIFMMDist's error")
    for x in res:
        if not all(x["launches_b"][k] > 0 for k in
                   ("surface_pair", "l2t_surface", "p2p_ulist")):
            fails.append(f"11b: a kernel did not launch: {x['launches_b']}")

    # 11c: against the float64 p2p on the card, one process
    # the float64 p2p reads the float32 run's inputs (as phase 6a's)
    rng = np.random.default_rng(RING_SEED)
    c64 = lambda a: torch.as_tensor(np.float32(a), device=dev).double()
    X, F = c64(rng.random((RING_N, 3))), c64(rng.normal(size=(RING_N, 1)))
    ref, ref_s = _host_s(torch, lambda: direct_eval_blocked(
        Laplace3D_FxU, X, X, F, block_t=RING_N, block_s=RING_N))
    ur = np.concatenate([x["ring_u"] for x in res])
    c = dict(err=_rel(ur, ref), ring_s=[x["ring_s"] for x in res],
             oracle_s=ref_s, p2p_case_err=r0["ring_p2p_err"],
             launches=[x["launches_c"]["p2p"] for x in res])
    out["11c"] = c
    log(f"dist 11c: eval_direct_ring of {RING_N} Laplace points, float32, "
        f"over {DIST_RANKS} ranks ({RING_N ** 2:.1e} pairs through p2p): "
        f"{['%.4f' % s for s in c['ring_s']]} s; against the float64 p2p "
        f"in one process {c['err']:.3e} (bar {DIRECT_BAR:g}); p2p on rank "
        f"0's shard against its plain version {c['p2p_case_err']:.3e}; p2p "
        f"launches by rank {c['launches']}; on '{smi}'")
    if not (c["err"] < DIRECT_BAR and c["p2p_case_err"] < KERNEL_BAR
            and all(n > 0 for n in c["launches"])):
        fails.append("11c: the ring direct sum")
    del X, F, ref

    # 11d: against the host PtTree of the same cloud
    x10 = sphere_cloud(TREE10_N, np.random.default_rng(10))
    host, host_s = _host_s(torch, lambda: PtTree(3).update_refinement(
        x10, TREE10_MAX_PTS, balance21=True))
    lk, ll = r0["tree"]
    same = bool(np.array_equal(lk.astype(np.uint64), host.leaf_keys)
                and np.array_equal(ll, host.leaf_levels))
    d = dict(tree_s=[x["tree_s"] for x in res], host_tree_s=host_s,
             leaves=int(r0["tree_leaves"]), host_leaves=host.n_leaves(),
             points=[int(x["tree_points"]) for x in res], same=same,
             adaptive_setup_s=[x["adaptive_setup_s"] for x in res],
             sharded_s=[x["sharded_s"] for x in res],
             single_s=r0["single_s"], sharded_err=r0["sharded_err"],
             ulist_block_err=r0["ulist_block_err"],
             launches=[x["launches_d"]["p2p_ulist"] for x in res])
    out["11d"] = d
    log(f"dist 11d: DistPtTree of {TREE10_N} points (80% on a sphere) over "
        f"{DIST_RANKS} ranks, max_pts {TREE10_MAX_PTS}, balance21: "
        f"{['%.3f' % s for s in d['tree_s']]} s, {d['leaves']} leaves, "
        f"points a rank {d['points']}; identical to the host PtTree's "
        f"({d['host_leaves']} leaves, {host_s:.3f} s): {same}")
    log(f"dist 11d: AdaptiveFMM(p={SHARDED_P}, float64).eval_sharded on "
        f"{SHARDED_N} points: setup s "
        f"{['%.2f' % s for s in d['adaptive_setup_s']]}, sharded eval s {['%.4f' % s for s in d['sharded_s']]}, one "
        f"process {d['single_s']:.4f} s; against the single-device eval "
        f"{d['sharded_err']:.3e} of the maximum (bar {SHARDED_BAR:g}); the "
        f"float64 p2p_ulist on rank 0's block against its plain version "
        f"{d['ulist_block_err']:.3e} (bar {ORACLE_BAR:g}); launches by rank "
        f"{d['launches']}")
    if not (same and d["sharded_err"] < SHARDED_BAR
            and d["ulist_block_err"] < ORACLE_BAR
            and all(n > 0 for n in d["launches"])):
        fails.append("11d: the tree or the sharded adaptive FMM")
    del x10, host

    # 11e: against one process
    rng = np.random.default_rng(3)
    N = DIST_GMRES_N
    A = torch.as_tensor(rng.random((N, N)) / N + np.eye(N), device=dev)
    bv = torch.as_tensor(rng.random(N), device=dev)
    (x1, it1), g_s = _host_s(torch, lambda: gmres(lambda v: A @ v, bv,
                                                   tol=DIST_GMRES_TOL))
    res1 = float(torch.linalg.vector_norm(A @ x1 - bv)
                 / torch.linalg.vector_norm(bv))
    del A
    sh = SphericalHarmonics(DIST_SDC_P, device=dev)
    lv = _packed_index(DIST_SDC_P)[0]
    c0 = np.random.default_rng(16).normal(
        size=(DIST_RANKS, sh_dim(DIST_SDC_P))) * np.exp(-lv / SDC_DAMP)
    calls, steps = [0], []

    def rhs(uu):
        calls[0] += 1
        return -sh.shc2grid_grad(sh.grid2shc(uu))[2]

    (us, _, _), sdc_s = _host_s(torch, lambda: SDC(
        SDC_ORDER, device=dev).adaptive_solve(
        SDC_DT0, DIST_SDC_T, sh.shc2grid(c0), rhs, SDC_TOL,
        monitor=lambda t, dt, uu: steps.append(dt)))
    us = us.cpu().numpy()
    e = dict(gmres_iters=[int(x["gmres_iters"]) for x in res],
             gmres_iters_one=it1, gmres_resid=r0["gmres_resid"],
             gmres_resid_one=res1, gmres_s=[x["gmres_s"] for x in res],
             gmres_one_s=g_s, sdc_steps=[x["sdc_steps"] for x in res],
             sdc_steps_one=len(steps),
             sdc_f_calls=[x["sdc_f_calls"] for x in res],
             sdc_f_calls_one=calls[0], sdc_s=[x["sdc_s"] for x in res],
             sdc_one_s=sdc_s, sdc_diff=max(_rel(res[q]["sdc_u"],
                                                 us[q:q + 1])
                                            for q in range(DIST_RANKS)))
    out["11e"] = e
    log(f"dist 11e: GMRES on the row-sharded N={N} system: iterations "
        f"{e['gmres_iters']} (one process {it1}), residual "
        f"{e['gmres_resid']:.6e} (one process {res1:.6e}), s "
        f"{['%.3f' % s for s in e['gmres_s']]} (one {g_s:.3f}); SDC("
        f"{SDC_ORDER}) over the ranks, one field each at p={DIST_SDC_P}, to "
        f"T={DIST_SDC_T}: steps {e['sdc_steps']}, F calls "
        f"{e['sdc_f_calls']} (one process {len(steps)}, {calls[0]}), s "
        f"{['%.2f' % s for s in e['sdc_s']]} (one {sdc_s:.2f}), fields "
        f"within {e['sdc_diff']:.3e}")
    if not (set(e["gmres_iters"]) == {it1}
            and abs(e["gmres_resid"] - res1) < DIST_RESID_BAR
            and set(e["sdc_steps"]) == {len(steps)}
            and set(e["sdc_f_calls"]) == {calls[0]}):
        fails.append("11e: GMRES or SDC over the ranks")

    # 11f: against phase 5's single process
    out["11f"] = _report_11f([x["f"] for x in res], kept["bie"], smi, fails)

    launches = {k: sum(x[f"launches_{s}"].get(k, 0) for x in res
                       for s in "bcd") + a["launches"].get(k, 0)
                + sum(x["f"]["launches"].get(k, 0) for x in res)
                for k in _dist_counters()}
    out.update(wall_s=wall, rank_s=[x["rank_s"] for x in res],
               phase_s=time.perf_counter() - t_phase, launches=launches)
    log(f"dist: the four ranks' group {wall:.1f} s (ranks "
        f"{['%.1f' % s for s in out['rank_s']]} s after their start); "
        f"phase 11 {out['phase_s']:.1f} s; launches {launches}; on '{smi}'")
    if fails:
        raise SystemExit(f"chip_smoke: the distributed phase failed: "
                         f"{fails}")
    return launches, out



def main():
    import tempfile
    import torch
    smi = phase_device(torch)
    phase_build()
    tmp = tempfile.TemporaryDirectory()
    ld = start_ld_rung(tmp.name)
    from sctl_tpu_torch.ops.m2l import m2l_grid, m2l_grid_blocked
    from sctl_tpu_torch.ops.p2p import (p2p, p2p_stencil, p2p_stencil9,
                                        p2p_ulist)
    from sctl_tpu_torch.ops.sl import l2t_surface, surface_pair
    from sctl_tpu_torch.config import set_precision
    from sctl_tpu_torch.kernel_cases import formula_cases, kernel_cases
    set_precision()
    counters = {"surface_pair": surface_pair, "l2t_surface": l2t_surface,
                "m2l_grid_blocked": m2l_grid_blocked,
                "p2p_stencil9": p2p_stencil9}
    all_counters = dict(counters, p2p_ulist=p2p_ulist, p2p=p2p,
                        m2l_grid=m2l_grid, p2p_stencil=p2p_stencil)
    kf, xs, f, rng = phase_setup(torch)
    # the redesigned pair kernels also against float64 (as phase 7's
    # halo stencil)
    f64 = lambda c: {k: v for k, v in c.items()
                     if k.split("[")[0] in F64_CASES}
    rest = lambda c: {k: v for k, v in c.items() if k not in f64(c)}
    cases, fcases = kernel_cases(kf), formula_cases(kf)
    rows = phase_kernels(torch, kf, rest(cases))
    rows.update(phase_kernels(torch, kf, f64(cases), f64_bar=DIRECT_BAR))
    frows = phase_kernels(torch, kf, rest(fcases))
    frows.update(phase_kernels(torch, kf, f64(fcases), f64_bar=DIRECT_BAR))
    del cases, fcases
    for name in counters:
        rows[name]["cases"] = {
            k: dict(max_rel_err=v["max_rel_err"], ms=v["ms"],
                    plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                    **{x: v[x] for x in ("max_rel_err_f64",) if x in v})
            for k, v in frows.items() if k.startswith(name + "[")}
    kept = {}
    main_rows = phase_main(torch, kf, xs, f, rng, counters, kept)
    del kf, xs, f
    torch.cuda.empty_cache()
    l4b = phase_particle(torch, all_counters)
    l5, rows["p2p_ulist"], bie_baseline, ops5 = phase_bie(torch,
                                                          all_counters, kept)
    tables5 = tempfile.TemporaryDirectory()
    save_tables(ops5, tables5.name)
    kept["bie"]["tables"] = tables5.name
    torch.cuda.empty_cache()
    from sctl_tpu_torch.fmm.kifmm import unit_tables
    tables6b = build_in_background(unit_tables, "Stokes3D-FSxU", P, 3e-5)
    l5f, ulist_f64, bie_f64 = phase_bie_f64(torch, all_counters, ops5)
    del ops5
    rows["p2p_ulist"]["f64"].update(ulist_f64)
    main_rows["p2p_ulist"] = dict(rows["p2p_ulist"], launches=0)
    torch.cuda.empty_cache()
    l5L, bie_laplace, ops5L = phase_bie_laplace(torch, all_counters, smi)
    torch.cuda.empty_cache()
    l5Lf, bie_laplace_f64 = phase_bie_laplace_f64(torch, all_counters, smi,
                                                  ops5L)
    del ops5L
    rows["p2p_ulist"]["f64"]["laplace_5L_f64"] = {
        k[len("ulist_"):]: v for k, v in bie_laplace_f64.items()
        if k.startswith("ulist_")}
    torch.cuda.empty_cache()
    l5h, bie_host = phase_bie_host(torch, all_counters, smi)
    l5q, legacy = phase_legacy(torch, all_counters, smi)
    torch.cuda.empty_cache()
    l6a, rows["p2p"] = phase_direct(torch, all_counters)
    l6b = phase_tree(torch, all_counters, tables6b)
    l6c, main_rows["p2p"], st6c, spread6c = phase_stokes(torch,
                                                         all_counters)
    main_rows["p2p"]["launches"] = 0
    torch.cuda.empty_cache()
    l7, r7, m7 = phase_p8(torch, all_counters)
    # the shared-surface kernels' phase-7 figures beside phase 4's
    for name in ("surface_pair", "l2t_surface"):
        case = r7.pop(name)
        main_rows[name]["phase7"] = dict(
            m7.pop(name), **{f"case_{k}": case[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "max_rel_err",
                "max_rel_err_f64")})
    main_rows["surface_pair"]["rounding_spread_6c"] = spread6c
    rows.update(r7)
    main_rows.update({k: dict(v, launches=0) for k, v in m7.items()})
    main_rows["p2p_stencil"]["stokes_6c"] = st6c
    for name in ROUTES:
        main_rows[name]["launches"] += sum(
            lc.get(name, 0) for lc in (l4b, l5, l5f, l5L, l5Lf, l5h, l5q,
                                       l6a, l6b, l6c, l7))
    log("kernels: launches over phases 4 to 7: " + ", ".join(
        f"{k} {v['launches']}" for k, v in main_rows.items()))
    if not all(v["launches"] > 0 for v in main_rows.values()):
        raise SystemExit("chip_smoke: a kernel was never launched")
    torch.cuda.empty_cache()
    r8, f8, m8, l8, f64_summary = phase_f64(torch, smi)
    if not all(l8[k] > 0 for k in F64_BUILDS + ("p2p_ulist",)):
        raise SystemExit(f"chip_smoke: a float64 build was never launched "
                         f"in phase 8: {l8}")
    main_rows["p2p_ulist"]["f64"].update(
        phase8_launches=l8["p2p_ulist"],
        phase8e=f64_summary["8e"].pop("p2p_ulist"))
    torch.cuda.empty_cache()
    l9, spectral = phase_spectral(torch, smi)
    # phase 9's float64 p2p launches (the Stokes oracles) join the
    # main path's count
    main_rows["p2p"]["launches"] += l9["p2p"]
    torch.cuda.empty_cache()
    l10, library = phase_library(torch, all_counters, smi, ld)
    tmp.cleanup()
    torch.cuda.empty_cache()
    l11, dist = phase_dist(torch, all_counters, smi, kept)
    del kept
    tables5.cleanup()
    for name in ROUTES:
        main_rows[name]["launches"] += l10.get(name, 0) + l11.get(name, 0)
    for name, row in dist["11b"]["kernels"].items():
        main_rows[name]["phase11"] = dict(
            row, launches=sum(x[name] for x in dist["11b"]["launches"]))
    main_rows["p2p"]["phase11"] = dict(
        ring_launches=dist["11c"]["launches"],
        case_max_rel_err=dist["11c"]["p2p_case_err"])
    main_rows["p2p_ulist"]["phase11"]["sharded_launches"] = \
        dist["11d"]["launches"]
    f11 = dist["11f"]
    main_rows["p2p_ulist"]["phase11f"] = dict(
        f11["ulist"], launches=sum(x["p2p_ulist"] for x in f11["launches"]))
    main_rows["p2p"]["phase11f"] = dict(
        f11["p2p"], direct_max_rel_err=f11["direct_err"],
        launches=sum(x["p2p"] for x in f11["launches"]))
    out = []
    for name, (src, tpu) in ROUTES.items():
        r, m = rows[name], main_rows[name]
        out.append(dict(name=name, route="cuda", source=src, replaces=tpu,
                        launches=m["launches"], max_abs_err=r["max_abs_err"],
                        ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"], case=r["case"],
                        max_rel_err=r["max_rel_err"],
                        main_path_ms=m["main_path_ms"],
                        main_path_bound_ms=m["main_path_bound_ms"],
                        main_path_bound_by=m["main_path_bound_by"],
                        **{k: v for k, v in {**r, **m}.items() if k in (
                            "cases", "launches_per_apply", "u_stage_ms",
                            "max_rel_err_f64", "main_path_max_rel_err_f64",
                            "main_path_plain_max_rel_err_f64",
                            "every_slot_ms", "blocks_per_sm",
                            "targets_per_thread", "lanes_per_target",
                            "dp_per_pair",
                            "dp_floor_ms", "case_sass_per_pair",
                            "case_issue_floor_ms",
                            "sass_per_pair", "issue_floor_ms", "stokes_6c",
                            "main_path_ops_limit", "bound_cuda_core_ms",
                            "bound_tensor_core_ms",
                            "main_path_bound_cuda_core_ms",
                            "main_path_bound_tensor_core_ms", "levels",
                            "phase7", "phase11", "phase11f",
                            "rounding_spread",
                            "rounding_spread_6c", "f64")}))
    # each float64 build: its case at the run's widths, its main path
    # (8d, the halo stencil 8e), its launches over phase 8
    for name in F64_BUILDS:
        src, tpu = ROUTES[name]
        r = r8[name + "[f64]"]
        out.append(dict(
            name=name + "[f64]", route="cuda", source=src, replaces=tpu,
            launches=l8[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, case=r["case"],
            max_rel_err=r["max_rel_err"], **m8[name],
            cases={k: dict(max_rel_err=v["max_rel_err"], ms=v["ms"],
                           plain_ms=v["plain_ms"], bound_ms=v["bound_ms"])
                   for k, v in f8.items() if k.startswith(name + "[")}))
    log("f64 ladder: " + json.dumps(f64_summary))
    log("bie legs: " + json.dumps({"bie": bie_baseline,
                                   "bie_f64": bie_f64,
                                   "bie_laplace": bie_laplace,
                                   "bie_laplace_f64": bie_laplace_f64,
                                   "bie_host": bie_host,
                                   "legacy": legacy}))
    log("spectral: " + json.dumps(spectral))
    log("library: " + json.dumps(library))
    log("dist: " + json.dumps({k: v for k, v in dist.items()
                               if k != "11b"}
                              | {"11b": {k: v for k, v in dist["11b"].items()
                                         if k != "kernels"}}))
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    log(f"chip_smoke: done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
