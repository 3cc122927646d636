"""Run the PyTorch/CUDA port's marker methods and random effects on one NVIDIA GPU
and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc
    python3 chip_smoke.py scans  # phases 1-2 and every scan of phase 3 alone
    python3 chip_smoke.py rc     # phases 1-2 and the annotation scans of phase 3 alone
    python3 chip_smoke.py passes # phases 1-2, phase 3's K1/K2/K1'/K2', the ladder's
                                 # frontier and fused, and the 50k BayesR path alone
    python3 chip_smoke.py graph  # phases 1-2 and phase 7 alone
    python3 chip_smoke.py keyed [DIR ...]  # phases 1-2 and phase 7a alone; with DIRs
                                 # (other trees' csrc/), their R1 timed beside this
                                 # tree's in turns
    python3 chip_smoke.py gathers [DIR ...]  # phases 1-2 and phase 6's S1a, S1b and K1
                                 # alone; with DIRs (other trees' csrc/), theirs
                                 # timed beside this tree's in turns
    python3 chip_smoke.py chains # phases 1-2 and phase 4's default chains, digested
    python3 chip_smoke.py random # phases 1-2 and phase 8 alone
    python3 chip_smoke.py random DIR  # the same, and RE1 against DIR's (another
                                 # tree's csrc/, e.g. a `git archive` of the parent
                                 # under _checkout/) in turns P, C, C, P
    python3 chip_smoke.py corr [DIR]  # phases 1-2 and phase 9 alone, with CM1's ablation
                                 # builds; with DIR (another tree's csrc/ with this
                                 # tree's C interface of RE2 and CM1), RE2 and the BayesR+A2
                                 # replayed sweep also with DIR's RE2, and CM1, its
                                 # rule and the MultiBreed replayed sweeps with DIR's
                                 # CM1, in turns P, C, C, P
    python3 chip_smoke.py runtime  # phases 1-2 and phase 10 alone
    python3 chip_smoke.py storage  # phases 1-2 and phase 11 alone
    python3 chip_smoke.py grn [DIR]  # phases 1-2 and phase 12 alone, with GRN1's ablation
                                 # builds; with DIR (another tree's csrc/, built alone
                                 # with its own C interface), GRN1 and the replayed GRN
                                 # step also with DIR's GRN1, in turns P, C, C, P
    python3 chip_smoke.py shards # phases 1-2 and phase 13 alone
    python3 chip_smoke.py vrule  # phases 1-2 and phase 15: the measurement vshards="auto"
                                 # is read from, and the rule held to it
    python3 chip_smoke.py f64    # phases 1-2 and phase 14 alone
    python3 chip_smoke.py levels [DIR]  # phases 1-2, RE2's phase 9.1 and 14g: RE1 and
                                 # RE2 in float32 and float64 against their plain
                                 # versions; with DIR (another tree's csrc/), RE1 and
                                 # RE2 in float32 also against DIR's, bit for bit
    python3 chip_smoke.py cg [DIR]  # phases 1-2 and phase 8.4 alone at 100,000 and
                                 # 1,000,000 animals, with CG1's ablation builds; with
                                 # DIR (this tree's C interface of CG1), CG1 and the
                                 # replayed A-cg sweep also with DIR's CG1, in turns
                                 # P, C, C, P

Phases (any failed check raises and the script exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
  2. build the kernels from nextgp_tpu_torch/csrc (one nvcc per source, sm_90a)
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with its median time beside the plain version's and the
     least time the card could take (the bytes the function needs over
     3.35 TB/s or its operations over 67 TFLOP/s; a scan needs the Gram's
     lower triangle only): K1 gather, K2 scatter, K3 BayesR scan, K6 Gaussian scan, K8
     B/C scan, K10 weighted B/C scan, K12 BayesRCpi scan, K14 BayesRCplus
     scan, K1 and K2 on a step of the 50,000-individual path (y 200 KB,
     through L1) and at 100,000 individuals (y 400 KB, past L1), K1 with
     four grids (the same bits), K3 with 8, 9
     (the two sides of its two rules' boundary) and 20 classes (past the 16
     it once took), K12 with a chain's
     coefficient rows past shared memory (A = 8, K = 4), K3 with one class
     and K12 and K14 with one annotation and one class (what their skeleton
     costs per locus), K1 and K2 over the whole panel (K1', K2'), and every
     scan again at V = 1, the single-chain launch the V=1 paths make (K4, K5,
     K7, K9, K11, K13).
     A time is the median of event pairs around one call, which holds the
     host's share of a launch; beside it, for K1, K2 and the scans, stands the
     kernels' time on the card alone, from the profiler (`device_ms` in the
     kernels line). A digest of each scan's inputs and outputs (the
     `[3 digests]` line) shows two trees giving the same bits on the same
     inputs. `scans` runs phase 3's scans alone (not K3 at K = 20)
  4. the paths at full size on one simulated 10,000 x 49,152 panel, 2-bit
     packed once and shared, V=96, 100 sweeps of run_lmem each: BayesR with
     estimatePi, BayesC, BayesC with a weighted ("D") residual, BayesPR
     (one whole-genome region), BayesRCpi with estimatePi, BayesRCplus (three
     annotations each) and BayesLV (three variance covariates); per-path
     launch counts, residual drift, finite draws, pi, annotation state,
     EBV correlation with the planted signal, steady sweep time and a
     profiled window; for BayesR also a window under diag.trace with host
     and device time by stage scope, and diag.roofline beside the measured
     sweep. Then all seven again at V=1, the reference-sequential block order: with
     V=96 every step updates half the loci against one residual, which
     overshoots under dense priors (PERF.md), so BayesC's, BayesRCpi's and
     BayesLV's EBV limits (and BayesLV's ceiling on varE) are held at V=1.
     Then BayesLV at V=8 and V=32, and at V=96 and V=1 with a column of
     ones before its covariates, which its design on the main path lacks.
     Last, BayesR (estimatePi, V=96) at 50,000 x 49,152, simulated on the
     card as the 10k panel is: 30 sweeps of run_lmem (10 burn-in, thin 5)
     with launch counts, drift and finite draws, its EBV correlation
     printed, then the steady sweep time and a profiled window (busy share)
  5. kernel chain against plain chain on a small model, from identical
     draws, for all seven methods and BayesC+D; two kernel runs from one
     seed must give bit-identical beta; BayesLV's float32 kernel chain also
     against the float64 plain chain over 20 sweeps
  6. the measurement ladder at the JAX scripts' full sizes: its six kernels
     (read-only pass, 1- and 4-byte-load gathers, dense int8 gather and
     scatter, fused scatter||gather) against their plain versions on the same
     inputs (the gathers, S1a and S1b, also against K1's plain version, the
     same bits twice and on grids of 1 and 7 blocks, their time on the card
     alone beside it, and again at q = 25,088, past the shared memory they
     once staged y in), then `nextgp_tpu_torch.micro` through its entry point, one
     experiment at a time with launch counts: K1 and K2 over 16 fresh steps
     of a 7.4 GB panel beside the read-only roof, the fused step (K1's and
     K2's bodies in one launch, with their bits) against the sequential pair
     of K2 and K1 and at other splits of its blocks between the roles, load
     widths, dense against packed (K1', K2')
  7. the whole chain as CUDA-graph replays with a KeyedStream (draws keyed
     on the card from the state's sweep counter): keyed_rng against its plain
     version at the main path's shapes (uniforms the same bits, normals
     within 1e-6 of scale, gammas within 1e-5 relative where both accepted
     at the same attempt, that share printed, at most 1e-4), then on the card
     alone at n = 1, 4 and 49,152 of each kind and at each of BayesR's six
     draws beside the library call at the same n (torch.rand, torch.randn,
     torch._standard_gamma), with the sum over a BayesR sweep; BayesR at V=96
     and V=1 (100 sweeps), the six other paths at V=96 (20 sweeps) and BayesR
     at 50,000 x 49,152 (30 sweeps), each run eagerly and through run_lmem's
     replays from the same state with the same stream: draws and final ycorr
     the same bits, drift, finite draws, BayesR's EBV limit at V=96; sweeps/s
     and steady ms/sweep of both arms, launches per sweep, device busy (and
     R1's share of it) from a profiled window of replays and the idle share
     without the profiler
  8. random effects: RE1 (the level scan, csrc/level_scan.cu) against its
     plain version at q = 10,000 (the dense A^-1 of a simulated 10,000-animal,
     5-generation pedigree, a second sweep's inputs; within 1e-4 of u's scale,
     two runs bit-identical; beside it torch.linalg.solve_triangular on the
     same system, the one PyTorch call that computes it) and at RE1_EDGES
     (one level, the group and look-ahead edges, 1,025, 3,001); "BayesR+A", the
     main path (V=96) plus an animal effect over the panel's 10,000
     individuals (planted polygenic values by the Henderson recursion added
     to y), and "GBLUP", intercept + a genomic effect with G^-1 of the panel
     (make_g_inverse, float64 on the card, stored in float32): each 100
     sweeps of run_lmem with launch counts (K1, K3, K2, RE1), drift of
     y - Xb - Zu - Mc beta, finite draws, varU > 0 (and for GBLUP the
     correlation of the posterior-mean u with the planted genetic value over
     the first 2,048 individuals, at least 0.8), then eager and replayed from
     one KeyedStream with the same bits, steady ms/sweep, device busy and
     idle share; "A-cg", an animal effect by perturbed CG on a simulated
     100,000-animal pedigree with 60,000 records: CG1 (the whole solve in
     one cooperative launch, csrc/cg_solve.cu) against its plain version at
     a second sweep's system (the same iterations; x within 1e-6 of its
     scale at the plan's tolerance of 1e-8 and within 1e-10 solved to
     1e-12; the same bits twice), its time an iteration beside the plain
     version's and the parent's eager solve (the generic cg_solve on the
     long-form matvec); then 20 sweeps in float64 of run_lmem (PhiloxStream,
     eager; one CG1 launch a sweep), eager and replayed from one KeyedStream
     (the same bits, each replay's CG iterations the eager sweep's; every
     sweep stopped by its tolerance; drift, finite draws, varU > 0), steady
     ms/sweep, device busy and idle share; 5 sweeps in float32 (iterations
     printed: float32 cannot reach the default tolerance of 1e-8). `cg` runs
     the same at 100,000 and 1,000,000 animals, and beside CG1 its ablation
     builds (scratch copies of this tree's csrc/cg_solve.cu: the whole
     solve, and without the matvec, the grid barriers or the totals,
     each for the solve's iterations), the split they give printed
  9. the correlated terms (ROADMAP M9): RE2 (the correlated level scan,
     csrc/level_scan.cu) against its plain version at q = 10,000 on phase
     8's A^-1 for nT = 1, 2, 3 (and at q = 1, 31, 33, 193, 3,001 for nT = 1,
     2, 3, 5), beside RE1 on the same structure and the library's triangular
     solve of the same system; CM1 (the correlated block-step,
     csrc/corr_scan.cu: rows read in place, r0, centres and sum(y) folded
     in, beta written into the sweep's buffer) against its plain version at
     the MultiBreed path's first step at V = 96 and V = 1, beside its byte
     and dependent-chain bounds, K6 on one set's Gram and the library's
     batched solve, and CM1's rule launch against the torch pack;
     "MultiBreed", two 10,000 x 49,152 panels of
     one set of loci (500 causal loci, effects correlated 0.5 between the
     sets) under BayesPR with a 2 x 2 v and regions of 100 loci (492), at
     V = 96 and V = 1, and "BayesR+A2", phase 8's BayesR path plus an
     (intercept, slope) animal group on its 10,000-animal pedigree with one
     shared incidence: each 100 sweeps of run_lmem with launch counts (K1,
     CM1, K2, the rule; K1, K3, K2, RE2), drift, finite draws, every kept covariance
     positive definite, then eager and replayed from one KeyedStream with
     the same bits, steady ms/sweep, kernels a replayed sweep and the idle
     share; EBV and u correlations with the planted values printed; last,
     the kernel chains against the float64 plain chains on small models
 10. the runtime (ROADMAP M10, M11), replayed with KeyedStreams, its output
     folders in a temporary directory removed afterwards: (a) BayesR at
     V=96 through run_lmem without files and with files and a checkpoint
     every 2 kept samples (in turns N, F, F, N), and stopped at 75 sweeps
     and resumed to 100 (files
     byte for byte, draws and final state bit for bit, EBV >= 0.95; ms/sweep
     of each arm, a checkpoint's bytes and seconds); (b) phase 8's A-cg in
     float64, 20 sweeps with a checkpoint every 5, stopped at 17 and
     resumed (every leaf bit for bit, files byte for byte); (c) run_chains,
     two chains of (a) with their own KeyedStreams, each the same bits as
     its run_lmem, R-hat of varE finite, and with per-chain files and a
     checkpoint every 2 kept samples stopped at 75 sweeps and resumed (the
     files byte for byte, draws and the batched state bit for bit); (d) the posterior-mean beta of (a)
     served by genomic_values (host f64) against genomic_values_state (K2
     over the panel, f32) within 1e-5 of scale, and predict on 1,000 panel
     rows within 1e-9 of genomic_values. The kernels line counts K1, K3,
     K2, R1 and CG1 in these runs as the wrappers count a capture (once)
 11. unpacked marker storage and the command line (ROADMAP M7c, M12), in a
     temporary directory removed afterwards: (a) phase 4's panel written as
     a PLINK fileset (encoded on the card) and read back with read_plink
     (timed; the dosages equal); BayesR (estimatePi, V=96) on its int8 rows
     (assemble(pack2=False); replayed by scan_chain, the runner run_lmem
     drives: run_lmem has no pack2 in either package) and on the packed
     rows run_lmem makes of the same data, each 100 sweeps eager (launch
     counts: no K1 or K2 on int8 rows) and replayed from one KeyedStream
     with the same bits, drift, EBV >= 0.95, the peak memory of each arm,
     steady ms/sweep, busy, nodes and idle share; the two chains' first 3
     sweeps held by the packed rule; BayesC+D on int8 rows; on one V=96
     step the product route (the cast, the gather and scatter products, TF32
     off) beside the ladder's S2a/S2b on the same rows, each held to the
     product's output, on the card alone; (b) the panel with 5 % of its
     dosages imputed (fractional, uniform in [0, 2]) through
     from_float_array: BayesR at V=96 as in (a) (float32 rows), serving
     (genomic_values_state, a float32 product, within 1e-5 of scale of
     genomic_values) and MultiBreed on two such panels at V=1 ("auto") as
     phase 9 runs it (drift, every kept covariance positive definite);
     (c) the CLI on a generated 2,000 x 8,192 text panel, a 2,000-animal
     pedigree and a phenotype CSV (y ~ 1 + x + PED(ID) + SNP(M), BayesR):
     `run` with two chains on KeyedStreams, `diag`, `summary`, `predict`
     and `roofline` run as `python -m nextgp_tpu_torch` does (runpy, in
     this process, so that the launch counters show K3, RE1 and R1), each
     returning 0, and `summary` again in a child `python -m`; `run` at the
     V "auto" gives (2) held to phase 15's gate against `run` at vshards 1
 12. the GRN vertical (ROADMAP M13): (a) GRN1 (csrc/grn_scan.cu, the
     per-gene SNP scan, one forward substitution with G right-hand sides
     on one triangle, read from the layout made once a chain) against its
     plain version in float32 (1e-4 of d's scale) and float64 (1e-10), the
     same bits twice, at scripts/bench_grn.py's (G, S) = (10, 20), (30,
     60), (100, 200) and at (100, 1,000), (100, 2,000), (100, 3,000) on
     the Gram of that shape's panel, timed beside its byte and
     dependent-chain bounds and the library's triangular solve, at S = 1,
     31, 32, 33, 63, 64, 65, 2,000, 3,000 for G = 1, 3, 100, either side of
     its shared-memory limit (past it the d's in scratch; a gene the bits
     of a call on it alone) and with a monomorphic SNP, and its SASS
     checked (no LDL/STL, no predicated LDS,
     no SR_CgaCtaId read in a loop); (b) the chains at 100 genes x 200 SNPs
     and at 100 x 1,000, each of 10,000 individuals (bench_grn's generator,
     start_lam1 0.1): float32 eager and replayed from one KeyedStream for
     300 iterations (the same bits; accept > 0; corr(posterior-mean
     Lambda2, planted) >= 0.7; varE within 0.5-2x of 0.25; Lambda1's
     correlation printed), ms/iteration of both arms, busy, idle share and
     nodes of a replayed step and GRN1's share; at 200 SNPs float64 with
     GRN1 against float64 with the plain scan on the card over 20
     iterations (1e-9 relative, the same accept count); (c) est_grn with a
     KeyedStream: its six *Out files in a temporary folder equal to its
     draws, and out_folder=None writing nothing
 13. the chains x shards mesh (ROADMAP M14), its ranks child processes of
     this one (`shard-rank` mode) that each write back a JSON file, the
     kernels built once before: (a) one rank through init_distributed
     (NCCL, a world of one): BayesR at the main path (V=96, estimatePi)
     through make_sharded_sweep on global_mesh(1, 1) and through make_sweep,
     20 eager sweeps each from one PhiloxStream seed, ycorr, beta, delta,
     varE and pi the same bits, K1, K3 and K2 counted on the sharded run;
     (b) four ranks on this card in a gloo world, global_mesh(2, 2): each
     builds the panel from the seed and keeps its share through distribute
     (V = 48 of 96: K1 and K2 on 12,288 rows a step, K3 on 48 blocks), K1,
     K2 and K3 held to their plain versions at the share's shapes, each
     chain's first 3 sweeps (KeyedStream) held to the single-rank V=96 chain
     of its stream by the packed rule, 20 sweeps: drift < 1e-2, finite
     draws, the row's two ranks the same replicated bits (chain_checksum and
     a digest), the chains different; run_chains over the mesh (30 sweeps,
     KeyedStreams): the same draws, R-hat and ESS on every rank, R-hat of
     varE finite, rank 0 writing both chains' files; (c) ranks 0 and 1 of
     (b) on a (1 x 2) mesh: MultiBreed on two 2,000 x 8,192 panels (phase
     9's generator) at V = 8 (4 a rank), CM1 and its rule held at the
     share's shapes, 3 sweeps held by the packed rule, 20 sweeps with every
     covariance positive definite; ms/sweep of each arm and each rank, and
     each rank's psum route. NCCL with two or more ranks needs a card a
     rank, which one card cannot give
 14. float64 on the card through the float64 instances of K1, K2, K3, K6,
     K8 and K10, at bench.py:131-144's configuration (phase 4's panel,
     simulated again and kept as int8 dosages on the card; packed, V=96),
     nothing cut but the V=1 chains' depth: (a) ptxas's registers and
     spills and the SASS's predicated shared loads of K6, K8 and K10 (a
     float64 instance no more than its float32 one); K1, K2 (a V=96 step),
     K1', K2' (the whole panel), K3, K6, K8 and K10 at V=96 and V=1 against
     their plain versions (float64 too) within 1e-12 of scale, delta exact,
     twice the same bits, timed beside their bounds (the vectors, the Gram,
     the rows and the outputs in 8 bytes, operations at 34 TFLOP/s; K6 also
     beside the float64 triangular solve); (b) 20 float64 sweeps of the
     kernel chain against the float64 plain chain (the same sweep with K1,
     K2 and the scans swapped for their plain versions on the card) on one
     KeyedStream, ycorr and beta within 1e-9 of scale, delta identical, for
     BayesR, BayesB, BayesC, BayesC+D and BayesPR, and 3 at V=1 on a 2,000 x
     8,192 panel for BayesR and BayesLV; (c) 100 float64 sweeps eager and
     through run_lmem's replays with one KeyedStream for BayesR, BayesB,
     BayesC+D, BayesPR (V=96), BayesC and BayesLV (V=1): the same bits,
     drift < 1e-9 of max|y|, phase 4's EBV and varE limits (BayesR at V=96,
     BayesC and BayesLV at V=1), ms/sweep, busy and idle share; (d) the
     float32 BayesR kernel chain held to the float64 kernel chain by the
     packed rule after 3 sweeps; (e) float64 on int8 rows (pack2=False: the
     scan alone) held to the packed float64 chain by the same rule, for
     BayesR and BayesC+D; K2' on the float64 state; (f) in turns f32 / f64
     / f64 / f32, K1, K2, K3, K6, K8 and K10 on the card alone on one step,
     and the replayed BayesR sweep's ms, busy and idle share; then the
     float64 level scans (RE1, RE2): (g) ptxas's registers and
     spills and the SASS's LDL/STL and predicated shared loads of every
     instance, RE1 and RE2 (nT = 1 .. 4, and 5 in the generic form) in
     float64 against their float64 plain versions at q = 10,000 on phase 8's
     A^-1 and at phases 8's and 9's edges, within 1e-12 of scale, twice the
     same bits, timed beside the float64 byte bound and the library's
     float64 triangular solve (nT <= 3); (h) BayesR+A and BayesR+A2 (V=96)
     at 2,000 animals: 10 float64 sweeps of the kernel chain against the
     plain chain (RE1 and RE2 swapped for their plain versions too), u,
     beta and ycorr within 1e-9 of scale, delta identical, only float64
     level scans launched; (i) BayesR+A, GBLUP and BayesR+A2 at full width,
     100 float64 sweeps eager and replayed from one KeyedStream: the same
     bits, drift < 1e-9, finite draws, varU > 0 or positive definite, GBLUP's
     u against the planted value >= 0.8, ms/sweep, busy and idle share beside
     the float32 replayed sweep; (j) RE1 and RE2 (nT = 2) on the card alone
     in turns f32 / f64 / f64 / f32
 15. vshards="auto" on the card (engine/plan._card_vshards): (c) run_lmem's
     default for BayesR at the main path (the rule's V, phase 4's limits and
     launch counts) and for BayesC (its prior's cap), each held to the gate
     below against its V = 1 chain, then K1, K2 and K3 at the rule's V and
     the B/C scans at each V "auto" gives them, against their plain
     versions at phase 3's tolerances. `vrule` runs phase 15 alone with what
     the rule was read from: (a) replayed BayesR sweeps at every divisor V
     of the block count at 10,000 and 50,000 x 49,152, 10,000 x 50,000 and
     10,000 x 589,824 (from V = 8) and at the main path in float64 (the
     median of 3 runs of CUDA events around 20 replays, busy, nodes,
     capture seconds), with K1, K2 and K3 at BayesR's V by the rule at the
     other shapes, (b) 100 replayed sweeps of each method and BayesC+D at V
     = 1, 8, 32, 96, 192 on the main path's panel and V = 1-32 on 2,000 x
     8,192 (posterior-mean varE, EBV correlation, admitted where both stay
     within the gate of the V = 1 chain), then (c) with the scans at every V
     below T = 1 the gate admits for B/C; it fails where the V the rule
     gives a method at a gate panel is not admitted there, or at the main
     path is not the largest V admitted below T = 1
The last three lines are the card line, the kernels JSON and the result JSON.
There is no CPU path: without a CUDA device the script fails.
"""
import contextlib
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

import nextgp_tpu_torch as ngt
from nextgp_tpu_torch import diag, micro
from nextgp_tpu_torch.data import pedigree
from nextgp_tpu_torch.engine import rng as keyed
from nextgp_tpu_torch.engine import sweep as engine_sweep
from nextgp_tpu_torch.engine.rng import HostStream, PhiloxStream
from nextgp_tpu_torch.engine.samplers import random_effects
from nextgp_tpu_torch.engine.samplers.markers import _gram_raw_diag
from nextgp_tpu_torch.grn import sampler as tgrn
from nextgp_tpu_torch.ops import _cuda, cg, corr_scan, gibbs_kernels, grn_scan, pack2, random_scan
from nextgp_tpu_torch.ops import micro as mk
from nextgp_tpu_torch.utils import full_f32, replace

N, P, BLOCK, V_MAIN = 10_000, 49_152, 256, 96
N_CHAIN, N_BURN, N_THIN = 100, 50, 5
N_BIG, ROWS_BIG = 100_000, 1000  # K1/K2 where y exceeds L1 and shared memory
N_50K = 50_000  # the wide BayesR path: 50,000 x 49,152, V=96 (q = 12,544)
N_CHAIN_50K, N_BURN_50K, N_THIN_50K = 30, 10, 5
PRIOR_R = dict(pi=[0.9, 0.05, 0.03, 0.02], class_=[0.0, 1e-4, 1e-3, 1e-2], v=1.0, estimatePi=True)
PI_BC, V_BC, V_PR = 0.95, 0.05, 0.05  # scripts/bench_methods.py:43-58
PRIOR_RC = dict(pi=[0.9, 0.05, 0.05], class_=[0.0, 1e-3, 1e-2], v=1.0)  # bench_methods.py:48-50
V_LV, VZETA_LV = 0.01, 0.01  # bench_methods.py:51


def annotations(p, seed=3):
    """Three 0/1 annotations, the first on every locus, and three variance
    covariates per locus (scripts/bench_methods.py:38-40)."""
    rng = np.random.default_rng(seed)
    annot = (rng.integers(0, 2, (p, 3)) | np.array([1, 0, 0])).astype(np.int8)
    return annot, rng.normal(0, 1, (p, 3))


ANNOT, LVCOV = annotations(P)
# path -> (prior, weighted residual, its scan kernel, K1 launches per block-step)
PATHS = {
    "BayesR": (ngt.BayesR(**PRIOR_R), False, "r_block_scan_v", 1),
    "BayesC": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), False, "bc_block_scan_v", 1),
    "BayesC+D": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), True, "bc_block_scan_wv", 2),
    "BayesPR": (ngt.BayesPR(9999, V_PR), False, "gauss_block_scan_v", 1),
    "BayesRCpi": (ngt.BayesRCpi(annot=ANNOT, estimatePi=True, **PRIOR_RC), False,
                  "rcpi_block_scan_v", 1),
    "BayesRCplus": (ngt.BayesRCplus(annot=ANNOT, **PRIOR_RC), False, "rcplus_block_scan_v", 1),
    "BayesLV": (ngt.BayesLV(V_LV, LVCOV, VZETA_LV), False, "gauss_block_scan_v", 1),
}
# Not a main path: BayesLV with a column of ones before its covariates. The
# main path's design has none, so its log-variances are drawn around C c = 0
# and var_beta settles at 1, a hundred times its start; this run shows what
# the same sweep does when the design can carry the mean log-variance.
LV_ONES = "BayesLV+1"
EXTRA_PATHS = {LV_ONES: (ngt.BayesLV(V_LV, np.column_stack([np.ones(P), LVCOV]), VZETA_LV), False,
                         "gauss_block_scan_v", 1),
               # not a main path either: BayesB (scripts/bench_methods.py:44), K8 as BayesC's,
               # run in float64 alone (phase 14)
               "BayesB": (ngt.BayesB(PI_BC, V_BC, estimatePi=True), False, "bc_block_scan_v", 1)}
# (path, V) -> EBV correlation limit; every other run prints its correlation
EBV_LIMITS = {("BayesR", V_MAIN): 0.95, ("BayesC", 1): 0.95, ("BayesRCpi", 1): 0.95,
              ("BayesLV", 1): 0.8, (LV_ONES, 1): 0.85}
# (path, V) -> ceiling on the residual variance (the simulated one is 1): a
# log-variance sweep that went wrong shows here before anywhere else
VAR_E_LIMITS = {("BayesLV", 1): 10.0, (LV_ONES, 1): 3.0}
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12  # the H100 SXM data sheet's peaks
TOL_PASS = 1e-5  # K1, K2: relative to the output's scale (f32 sums in another order)
TOL_SCAN = 1e-4  # K3, K6, K8, K10: beta and u, relative to their scale; delta exact
CDF_MARGIN = 1e-5  # K3 inputs keep every uniform this far from a CDF edge
BC_MARGIN = 1e-4  # K8/K10 inputs keep every w this far (relative) from its threshold
RC_MARGIN = 1e-4  # K12/K14 inputs keep every uniform this far from a CDF edge
DEV = torch.device("cuda")


def digest(*tensors):
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


DIGESTS = {}  # scan name -> digests of its inputs and of its outputs
FITS = {}  # slice_phase's run ("BayesR V=1") -> (posterior-mean varE, EBV correlation)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(fn, reps):
    fn()  # warm up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps, records_per_launch=1, calls=None):
    """Mean time the card spends in the kernels that one call of fn launches,
    from the profiler's device durations. An event pair around one call
    (median_ms) also holds what the host needs to get the launch out, which
    for a kernel of a tenth of a millisecond is much of the reading.

    The profiler now and then hands back a few kernel records more or fewer
    than were launched in the window, most often one short. A short spin
    kernel opens and one closes each window, so that a record lost at either
    end is theirs; they are not counted. A window counts only where it is
    whole: each kernel built from csrc/ has as many records as the wrappers'
    launch counters rose in it (times records_per_launch, where one counted
    call launches each of its kernels that many times), and every other
    kernel (PyTorch's own, for outputs) a multiple of reps.
    records_per_launch=0 times a PyTorch call (a library yardstick): no
    counter may rise, and every kernel's records are a multiple of reps.
    calls: for another tree's kernels, which no counter here counts, a
    function giving the calls fn has made so far, read in place of the
    counters.
    Else the window is taken again; after five the time is left out (None),
    which decides no check."""
    from torch.profiler import ProfilerActivity, profile

    count = calls or (lambda: sum(_cuda.LAUNCHES.values()))
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        before = count()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
        launched = count() - before
        records = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count and "spin_kernel" not in e.key]
        ours = [e.count for e in records if _built_here(e.key)]
        counted = (launched > 0 and ours and all(n == launched * records_per_launch for n in ours)
                   if records_per_launch else launched == 0 and records)
        if counted and all(e.count % reps == 0 for e in records):
            return sum(e.self_device_time_total for e in records) / reps / 1e3
        seen.append(f"{launched} launched, records {sorted(e.count for e in records)}")
    print(f"chip_smoke: note: no whole profiler window of {reps} calls in five ({'; '.join(seen)});"
          " time on the card not measured")
    return None


def _built_here(kernel):
    """Whether a kernel name is one of the port's (csrc/): PyTorch's are in
    at:: (or cub::), or are copies and fills."""
    return not re.search(r"\b(at|cub)::", kernel) and not kernel.startswith(("Memcpy", "Memset"))


def rel_err(out, ref):
    return (out - ref).abs().max().item(), ref.abs().max().item()


TIMINGS = {}  # kernels-line name -> what `report` measured for it


def report(name, err, scale, tol, ms_k, ms_p, work, note="", library_ms=None, phase="3 kernels",
           dev_ms=None, library_dev_ms=None, flops=F32_FLOP_PER_S):
    """Hold one kernel to its plain version and keep its numbers. work: (bytes
    moved with each input read and each output written once, operations) of
    one call, from its shapes. library_ms: the time of the one PyTorch call
    that computes the same function, where there is one (event pair), and
    library_dev_ms its time on the card alone. dev_ms: the kernel's time on
    the card alone (device_ms), where it was taken. flops: the card's peak
    rate for the operations' type (F64_FLOP_PER_S for a float64 instance)."""
    t_bytes, t_ops = 1e3 * work[0] / HBM_BYTES_PER_S, 1e3 * work[1] / flops
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    lib = ("no single PyTorch call computes it" if library_ms is None
           else f"the one PyTorch call {library_ms:.4f} ms"
           + ("" if library_dev_ms is None else f", {library_dev_ms:.4f} ms on the card"))
    on_card = "" if dev_ms is None else f" ({dev_ms:.4f} ms of it on the card)"
    print(f"[{phase}] {name}: max_abs_err {err:.3e} (scale {scale:.3e}, tol {tol:g} x scale), "
          f"kernel {ms_k:.4f} ms{on_card}, plain {ms_p:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
          f"({work[0]:,} bytes, {work[1]:,} operations; {lib}){note}")
    check(err <= tol * scale, f"{name} disagrees with its plain version")
    TIMINGS[name] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, device_ms=dev_ms,
                         library_device_ms=library_dev_ms)


# ------------------------------------------------------------------ phase 1


def device_phase():
    check(torch.cuda.is_available(), "no CUDA device: the port's main path needs the card")
    card = micro.card_line(DEV)
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    print(f"[1 device] {card} | torch {torch.__version__}, CUDA {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]} | cards: {torch.cuda.device_count()}")
    return card


# ------------------------------------------------------------------ phase 2


def build_phase():
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.lib()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {so.relative_to(so.parents[3])}")
    for line in (so.parent / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())


# ------------------------------------------------------------------ data


def simulate_panel(n=N, p=P, chunk=8192):
    """n x p int8 dosages on the card (10,000 x 49,152 unless asked), 500
    expected causal loci with N(0, 0.1^2) effects and N(0, 1) noise (as
    bench.py does). The signal and the column means are taken `chunk`
    individuals at a time (50,000 x 49,152 floats would be 9.8 GB). Returns
    (dosages, effects, y on the host, the planted signal, the column means)."""
    g = torch.Generator(device=DEV).manual_seed(0)
    geno = torch.randint(0, 3, (n, p), generator=g, device=DEV, dtype=torch.int8)
    bt = torch.where(torch.rand(p, generator=g, device=DEV) < 500.0 / p,
                     torch.randn(p, generator=g, device=DEV) * 0.1, 0.0)
    sig = torch.cat([geno[i:i + chunk].float() @ bt for i in range(0, n, chunk)])
    sig = sig - sig.mean()
    y = (sig + torch.randn(n, generator=g, device=DEV)).double().cpu().numpy()
    center = sum(geno[i:i + chunk].sum(0, dtype=torch.int64) for i in range(0, n, chunk)).double() / n
    return geno, bt, y, sig, center


def simulate(n=N, p=P, chunk=8192):
    """simulate_panel's dosages, packed once with the port's packer. Returns
    spec_for(path) and the planted signal (on a panel of other than P loci
    spec_for takes method_priors' paths)."""
    geno, _, y, sig, center = simulate_panel(n, p, chunk)
    md = ngt.from_packed(pack2.pack2(geno), n, center)
    del geno
    weights = np.random.default_rng(3).uniform(0.5, 2.0, n)
    priors = {k: v[:2] for k, v in {**PATHS, **EXTRA_PATHS}.items()} if p == P else method_priors(p)

    def spec_for(path):
        prior, weighted = priors[path]
        return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                             markers=[ngt.MarkerTerm("M1", md, prior)],
                             residual=ngt.RandomEffect(weights, 1.0) if weighted else None,
                             block_size=BLOCK)
    return spec_for, sig


# ------------------------------------------------------------------ phase 3


def pass_work(rows, q, itemsize=4):
    """K1/K2 on a (rows, q) packed step: the packed bytes, the vector of 4q
    elements and the rows elements (one read, one written; itemsize bytes
    each: 8 for the float64 instances); a multiply and an add per
    genotype."""
    return rows * q + itemsize * (4 * q + rows), 2 * rows * 4 * q


def scan_work(V, B, width, grams, out_words, rule_ops, diag=False, itemsize=4):
    """A V-batched scan over `grams` (B, V, B) Gram steps and the (V, B,
    width) coefficient rows, out_words outputs per locus written, in words
    of itemsize bytes (4; 8 for K3's float64 instance, whose int32 delta is
    half a word). u starts at 0 and u[j] is set only once locus j has run,
    so the dot of locus j needs G[j, :j] alone: B(B-1)/2 Gram words per
    chain and Gram, a multiply and an add for each, plus the B diagonal
    words where the rule reads G[j, j] (diag: K14), and rule_ops per
    locus."""
    tri = B * (B - 1) // 2
    words = grams * tri + (B if diag else 0) + B * (width + out_words)
    return int(itemsize * V * words), V * (grams * 2 * tri + B * rule_ops)


def locus_pre(gram_t, pk_t, u, slot):
    """Each locus's pre (slot 0) or pre_raw (slot 7) in a scan that ended
    with correction vector u: u[i] is final once locus i ran, so locus j
    saw u masked to i < j."""
    B = gram_t.shape[0]
    tri = torch.tril(torch.ones(B, B, dtype=gram_t.dtype, device=DEV), diagonal=-1)
    return pk_t[:, :, slot] + torch.einsum("jvi,vi,ji->vj", gram_t, u, tri)


def cdf_near(gram_t, pk_t, u, K):
    """Loci whose uniform lies within CDF_MARGIN of an inner CDF edge (K3)."""
    if K == 1:  # no inner edge
        return torch.zeros(pk_t.shape[:2], dtype=torch.bool, device=DEV)
    pre = locus_pre(gram_t, pk_t, u, 0)
    logl = pk_t[:, :, 8:8 + K] + pk_t[:, :, 8 + K:8 + 2 * K] * (pre * pre)[..., None]
    cum = torch.cumsum(torch.softmax(logl, dim=-1), dim=-1)[..., :K - 1]
    return (cum - pk_t[:, :, 2:3]).abs().min(dim=-1).values < CDF_MARGIN


def bc_near(gram_t, pk_t, u, slot):
    """Loci whose w lies within BC_MARGIN (relative) of the indicator's
    threshold q0 + q1*pre^2 (K8: pre, K10: pre_raw from the raw Gram)."""
    pre = locus_pre(gram_t, pk_t, u, slot)
    quad = pk_t[:, :, 3] * pre * pre
    gap = (pk_t[:, :, 2] + quad - pk_t[:, :, 4]).abs()
    return gap < BC_MARGIN * (1.0 + pk_t[:, :, 2].abs() + quad.abs())


class Step0:
    """Step t = 0 of a marker set, as the sweep drives it: the coefficient
    rows of one step with r0 (and, weighted, r0_raw) from the real data."""

    def __init__(self, st):
        self.ms = st.markers[0]
        self.T, self.V, self.B, q = self.ms.mt.shape
        self.mt_rows = self.ms.mt.view(-1, q)
        n = st.ycorr.shape[0]
        self.y = torch.zeros(4 * q, dtype=st.ycorr.dtype, device=DEV)
        self.y[:n] = st.ycorr
        self.dw = None
        if st.e.d_inv is not None:
            self.dw = torch.zeros_like(self.y)
            self.dw[:n] = st.e.d_inv

    def gather(self, yv):
        r0 = pack2.matvec_step(self.mt_rows, 0, pack2.y_planar(yv), self.V * self.B)
        return r0.view(self.V, self.B) - self.ms.center[0] * yv.sum()

    def rows(self, pk, raw=False):
        pk_t = pk.view(self.V, self.T, self.B, -1)[:, 0].clone()
        pk_t[:, :, 0] += self.gather(self.y if self.dw is None else self.dw * self.y)
        if raw:
            pk_t[:, :, 7] += self.gather(self.y)
        return pk_t

    def redraw(self, unif, near, gen):
        """New uniforms for the step-0 loci flagged in near (V, B)."""
        idx = torch.nonzero(near.reshape(-1))[:, 0]  # (v, b) -> global locus v*T*B + b
        glob = (idx // self.B) * self.T * self.B + idx % self.B
        unif[glob] = torch.rand(glob.numel(), generator=gen, dtype=unif.dtype, device=DEV)


def held_scan(name, kern, plain, make_rows, unif, gen, step, near, work, note, library=None,
              card_alone=True, phase="3 kernels", tol=TOL_SCAN, flops=F32_FLOP_PER_S):
    """Redraw the uniforms of loci near a decision edge until none is, then
    hold the kernel against its plain version: two runs give the same bits,
    delta exact (where the scan draws one; the Gaussian scan has none, and
    no edge), u and beta within tol (TOL_SCAN) of their scale. library(pk_t), where
    given, sets up the one PyTorch call that computes the scan's u (outside
    the timed window) and returns it as a function; its u is held to the
    plain version's at TOL_SCAN and it is timed beside the kernel. card_alone
    False leaves out the time on the card alone (a card other processes
    share)."""
    for _ in range(20):
        pk_t = make_rows(unif)
        ref = plain(pk_t)
        close = near(pk_t, ref[1])
        if not close.any():
            break
        step.redraw(unif, close, gen)
    check(not close.any(), f"{name}: could not keep the inputs away from decision edges")
    got = kern(pk_t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, kern(pk_t))), f"{name}: two runs differ")
    DIGESTS[name] = dict(inputs=digest(pk_t), outputs=digest(*got))
    drawn = ""
    if len(ref) > 2:
        check(torch.equal(got[2], ref[2]), f"{name}: delta differs from the plain version")
        drawn = f"; delta exact, counts {torch.bincount(got[2].reshape(-1)).tolist()}"
    e_u, s_u = rel_err(got[1], ref[1])
    check(e_u <= tol * s_u, f"{name}: u differs by {e_u:.3e} (scale {s_u:.3e})")
    e_b, s_b = rel_err(got[0], ref[0])
    lib_ms = lib_dev = None
    if library is not None:
        solve = library(pk_t)
        e_l, _ = rel_err(solve(), ref[1])
        check(e_l <= TOL_SCAN * s_u, f"{name}: the library call's u differs by {e_l:.3e}")
        lib_ms, lib_dev = median_ms(solve, 20), device_ms(solve, 20, records_per_launch=0)
        note += f"; library u max_abs_err {e_l:.3e}, its system built outside the timed window"
    report(name, e_b, s_b, tol, median_ms(lambda: kern(pk_t), 20), median_ms(lambda: plain(pk_t), 3),
           work, f" (beta; u max_abs_err {e_u:.3e} of scale {s_u:.3e}; {note}{drawn})",
           library_ms=lib_ms, dev_ms=device_ms(lambda: kern(pk_t), 20) if card_alone else None,
           library_dev_ms=lib_dev, phase=phase, flops=flops)


def wide_passes():
    """K1 and K2 at wider panels than the 10k main path's: a 50,000-individual
    step of the BayesR sweep at V=96 (24,576 x 12,544, step t = 1 of two:
    y is 200 KB, read through L1), and 1,000-row steps at 100,000
    individuals (q = 25,088: y is 400 KB, more than L1 and shared memory
    hold, so its reads go to L2)."""
    for n, rows, tag, seed in ((N_50K, V_MAIN * BLOCK, "50k", 6), (N_BIG, ROWS_BIG, "100k", 4)):
        g = torch.Generator(device=DEV).manual_seed(seed)
        q = pack2.packed_q(n)
        pk = micro.panel(3 * rows, q, DEV, g, high=256)
        y = torch.zeros(4 * q, device=DEV)
        y[:n] = torch.randn(n, generator=g, device=DEV)
        y4 = pack2.y_planar(y)
        u = torch.randn(rows, generator=g, device=DEV) * 0.01
        sl = pk[rows:2 * rows]
        for name, kern, plain in (
                (f"pack2_matvec_{tag}", lambda: pack2.matvec_step(pk, 1, y4, rows),
                 lambda: pack2.matvec_plain(sl, y4)),
                (f"pack2_rank_update_{tag}", lambda: pack2.rank_update_step(pk, 1, u),
                 lambda: pack2.rank_update_plain(sl, u))):
            got = kern()
            check(torch.equal(got, kern()), f"{name}: not bit-reproducible")
            DIGESTS[name] = dict(outputs=digest(got))
            e, s = rel_err(got, plain())
            report(name, e, s, TOL_PASS, median_ms(kern, 20), median_ms(plain, 3), pass_work(rows, q),
                   f" ({rows} x {q} step, n = {n:,}; y {16 * q:,} bytes)", dev_ms=device_ms(kern, 20))
        del pk, sl


def k1_grids(st):
    """K1's grid is a parameter: one block, seven and as many as are resident
    give the same bits on a step of the main path."""
    ms = st.markers[0]
    T, V, B, q = ms.mt.shape
    mt_rows = ms.mt.view(-1, q)
    y4 = pack2.y_planar(Step0(st).y)
    ref = pack2._matvec_kernel(mt_rows, V * B, V * B, y4)
    for blocks in (1, 7, 4096):
        check(torch.equal(ref, pack2._matvec_kernel(mt_rows, V * B, V * B, y4, blocks)),
              f"pack2_matvec: {blocks} blocks give other bits than the default grid")
    print("[3 kernels] pack2_matvec: grids of 1, 7, 4096 blocks and the default give the same bits")


def held_rc_scan(name, kern, plain, pk_t, slots, discrete, gen, work, note, tol=TOL_SCAN, phase="3 kernels",
                 flops=F32_FLOP_PER_S):
    """K12/K14 against their plain versions. The plain version runs on the
    rows, on the rows with every uniform (the `slots` of a row) lowered by
    RC_MARGIN and on the rows with every uniform raised by it; a locus whose
    discrete outputs differ between the three has a uniform within the
    margin of a CDF edge, or follows one that has, and gets new uniforms.
    When the three agree everywhere no uniform is near an edge (the draws
    are monotone in the uniform, and equal draws give every later locus and
    component the same edges), so the kernel's discrete outputs must be
    exactly equal and its continuous ones within tol (TOL_SCAN; TOL_F64 for
    a float64 instance) of their scale. A float64 instance is timed on the
    card alone twice, by the profiler (device_ms) and by events around a
    graph of 20 calls (graph_ms), and its plain version by one call."""
    V, B, _ = pk_t.shape

    def shifted(d):
        out = pk_t.clone()
        out[:, :, slots] += d
        return out

    for _ in range(30):
        ref = plain(pk_t)
        close = torch.zeros((V, B), dtype=torch.bool, device=DEV)
        for other in (plain(shifted(-RC_MARGIN)), plain(shifted(RC_MARGIN))):
            for i in discrete:
                close |= (ref[i] != other[i]).reshape(V, B, -1).any(-1)
        if not close.any():
            break
        fresh = torch.rand((V, B, len(slots)), generator=gen, dtype=pk_t.dtype, device=DEV)
        pk_t[:, :, slots] = torch.where(close[..., None], fresh, pk_t[:, :, slots])
    check(not close.any(), f"{name}: could not keep the inputs away from decision edges")
    got = kern(pk_t)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, kern(pk_t))), f"{name}: two runs differ")
    DIGESTS[name] = dict(inputs=digest(pk_t), outputs=digest(*got))
    errs = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in discrete:
            check(torch.equal(g, r), f"{name}: discrete output {i} differs from the plain version")
        else:
            check(g.dtype == pk_t.dtype and torch.isfinite(g).all().item(), f"{name}: output {i} is not finite")
            e, sc = rel_err(g, r)
            check(e <= tol * sc, f"{name}: output {i} differs by {e:.3e} (scale {sc:.3e})")
            errs.append((i, e, sc))
    (_, e_b, s_b), rest = errs[0], errs[1:]
    others = "; ".join(f"output {i} max_abs_err {e:.3e} of scale {sc:.3e}" for i, e, sc in rest)
    f64 = pk_t.dtype == torch.float64
    ms_p = timed_once(lambda: plain(pk_t))[1] if f64 else median_ms(lambda: plain(pk_t), 3)
    report(name, e_b, s_b, tol, median_ms(lambda: kern(pk_t), 20), ms_p, work,
           f" (beta; {others}; {note}; discrete outputs {list(discrete)} exact, delta counts "
           f"{torch.bincount(got[2].reshape(-1)).tolist()})", dev_ms=device_ms(lambda: kern(pk_t), 20),
           phase=phase, flops=flops)
    if f64:
        TIMINGS[name]["graph_ms"] = graph_ms(lambda: kern(pk_t))
        print(f"[{phase}] {name} on the card alone: profiler {TIMINGS[name]['device_ms']} ms, events around a "
              f"graph of 20 calls {TIMINGS[name]['graph_ms']:.4f} ms")
    return pk_t, got


def rc_kernels(spec_for, z, V, tag, dtype=None, full=True):
    """K12 and K14 at step t = 0 of the BayesRCpi model, a first sweep's
    coefficients on the real data (both methods start from the same state);
    then the floors (A = K = 1) and, at the main paths' V, K12 with A = 8,
    K = 4 on the same Gram blocks, where a chain's rows exceed a block's
    shared memory (the kernel holds two rows at a time). dtype float64:
    the float64 instances (`<name>_f64`, within TOL_F64, the bound in 8-byte
    words at the float64 rate); full=False: the first two alone."""
    plan, st = ngt.assemble(spec_for("BayesRCpi"), vshards=V, dtype=dtype)
    ms, mp = st.markers[0], plan.markers[0]
    T, V, B, _ = ms.mt.shape
    A, K = mp.n_annot, mp.n_classes
    step = Step0(st)
    gen = torch.Generator(device=DEV).manual_seed(5)
    dt = st.ycorr.dtype
    f64 = dt == torch.float64
    suf, size = ("_f64", 8) if f64 else ("", 4)
    held = dict(tol=TOL_F64, phase="14 f64", flops=F64_FLOP_PER_S) if f64 else {}
    z = z.to(dt)
    var_e = st.ycorr.var()
    coef = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1), ive=1.0 / var_e, var_e=var_e)
    gram0 = ms.gram[0]

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=dt, device=DEV)

    def rcpi_rows(annot_input, aprob, anz, varc, logpi):
        g1 = torch._standard_gamma(torch.clamp(annot_input, min=1e-6), generator=gen)
        g2 = torch._standard_gamma(annot_input + 1.0, generator=gen)
        check(torch.isfinite(g1).all().item() and torch.isfinite(g2).all().item(),
              "gamma draws at shape 1e-6 are not finite")
        return step.rows(gibbs_kernels.rcpi_block_pack(
            ms.beta, z, rand(mp.p_pad), rand(mp.p_pad), g1, g2, aprob, anz, varc=varc,
            logpi=logpi, **coef))

    def rcpi(a, k, gram_t=(ms.gram, 0)):
        return (lambda pk_t: gibbs_kernels.rcpi_block_scan_v(gram_t, pk_t, a, k),
                lambda pk_t: gibbs_kernels.rcpi_block_scan_v_plain(gram0, pk_t, a, k))

    varc = ms.var_beta[:, None] * ms.v_class[None, :]
    _, got_pi = held_rc_scan(
        f"rcpi_block_scan_v{tag}{suf}", *rcpi(A, K),
        rcpi_rows(ms.annot_input, ms.annot_prob, ms.annot_nz, varc, ms.log_pi), [2, 3], (2, 3),
        gen, scan_work(V, B, 8 + 8 * A * K, 1, 4 + A, 12 * A * K, itemsize=size),
        f"V={V}, B={B}, A={A}, K={K}" + (", float64" if f64 else ""), **held)
    on = ms.mask.view(V, T, B)[:, 0]
    acat, aprob = got_pi[3], got_pi[4]
    picked = ms.annot_nz.view(V, T, B, A)[:, 0].gather(-1, (acat.long() - 1).clamp(min=0)[..., None])
    check((picked[..., 0] | ~on).all().item() and ((acat >= 1) | ~on).all().item(),
          "rcpi_block_scan_v: an annotation that is zero on its locus was drawn")
    check(((aprob.sum(-1) - 1.0).abs() < 1e-5)[on].all().item(),
          "rcpi_block_scan_v: new annotation probabilities do not sum to 1")

    pk_plus = step.rows(gibbs_kernels.rcplus_block_pack(
        ms.beta, torch.randn((mp.p_pad, A), generator=gen, dtype=dt, device=DEV),
        rand(mp.p_pad, A), ms.annot_nz, varc=varc, logpi=ms.log_pi, **coef))
    held_rc_scan(
        f"rcplus_block_scan_v{tag}{suf}",
        lambda pk_t: gibbs_kernels.rcplus_block_scan_v((ms.gram, 0), pk_t, A, K),
        lambda pk_t: gibbs_kernels.rcplus_block_scan_v_plain(gram0, pk_t, A, K),
        pk_plus, [8 + a * K for a in range(A)], (2, 3, 5), gen,
        scan_work(V, B, 8 + 6 * A * K, 1, 3 + 3 * A, 14 * A * K, diag=True, itemsize=size),
        f"V={V}, B={B}, A={A}, K={K}" + (", float64" if f64 else ""), **held)
    if not full:
        return
    # one annotation and one class: nothing left of the rule but its fixed steps,
    # so this is what the scans' skeleton costs per locus
    one = torch.ones((1, 1), dtype=dt, device=DEV)
    on1 = coef["mask"][:, None]
    held_rc_scan(
        f"rcpi_block_scan_v_floor{tag}{suf}", *rcpi(1, 1),
        rcpi_rows(on1.to(dt), on1.to(dt), on1, varc[:1, -1:].contiguous(), 0.0 * one), [2, 3],
        (2, 3), gen, scan_work(V, B, 16, 1, 5, 12, itemsize=size), f"V={V}, B={B}, A=1, K=1", **held)
    held_rc_scan(
        f"rcplus_block_scan_v_floor{tag}{suf}",
        lambda pk_t: gibbs_kernels.rcplus_block_scan_v((ms.gram, 0), pk_t, 1, 1),
        lambda pk_t: gibbs_kernels.rcplus_block_scan_v_plain(gram0, pk_t, 1, 1),
        step.rows(gibbs_kernels.rcplus_block_pack(
            ms.beta, torch.randn((mp.p_pad, 1), generator=gen, dtype=dt, device=DEV),
            rand(mp.p_pad, 1), on1, varc=varc[:1, -1:].contiguous(), logpi=0.0 * one, **coef)),
        [8], (2, 3, 5), gen, scan_work(V, B, 14, 1, 6, 14, diag=True, itemsize=size), f"V={V}, B={B}, A=1, K=1",
        **held)
    if V != V_MAIN:
        return

    A8, K8 = 8, 4
    check(4 * B * (8 + 8 * A8 * K8) > gibbs_kernels.SMEM_BYTES, "A = 8, K = 4 rows fit shared memory")
    anz8 = rand(mp.p_pad, A8) < 0.5
    anz8[:, 0] = True
    anz8 &= coef["mask"][:, None]
    count = anz8.sum(-1, keepdim=True).to(dt)
    logpi8 = torch.log(torch.tensor(PRIOR_R["pi"], dtype=dt, device=DEV)).expand(A8, K8)
    varc8 = ms.var_beta[0] * torch.tensor(PRIOR_R["class_"], dtype=dt, device=DEV).expand(A8, K8)
    held_rc_scan(
        f"rcpi_block_scan_v_wide{suf}", *rcpi(A8, K8),
        rcpi_rows(anz8.to(dt), anz8 / count.clamp(min=1.0), anz8, varc8.contiguous(), logpi8.contiguous()),
        [2, 3], (2, 3), gen, scan_work(V, B, 8 + 8 * A8 * K8, 1, 4 + A8, 12 * A8 * K8, itemsize=size),
        f"V={V}, B={B}, A={A8}, K={K8}: {size * B * (8 + 8 * A8 * K8):,} bytes of rows per chain, "
        f"more than shared memory holds", **held)


def pass_kernels(st):
    """K1, K2 and their whole-panel forms K1' and K2' on the BayesR model's
    panel, then K1 and K2 at 50,000 and 100,000 individuals."""
    ms = st.markers[0]
    T, V, B, q = ms.mt.shape
    rows = V * B
    mt_rows = ms.mt.view(-1, q)
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = st.ycorr.dtype  # float32 on the card
    y4 = pack2.y_planar(Step0(st).y)
    u = torch.randn(rows, generator=g, dtype=dt, device=DEV) * 0.01
    u_all = torch.randn(T * rows, generator=g, dtype=dt, device=DEV) * 0.01
    sl = slice(rows, 2 * rows)  # step t = 1: a real offset into the panel

    for name, kern in (("pack2_matvec", lambda: pack2.matvec_step(mt_rows, 1, y4, rows)),
                       ("pack2_rank_update", lambda: pack2.rank_update_step(mt_rows, 1, u))):
        got = kern()
        check(torch.equal(got, kern()), f"{name}: two runs differ")
        DIGESTS[name] = dict(inputs=digest(mt_rows[sl], y4, u), outputs=digest(got))
    e, s = rel_err(pack2.matvec_step(mt_rows, 1, y4, rows), pack2.matvec_plain(mt_rows[sl], y4))
    report("pack2_matvec", e, s, TOL_PASS,
           median_ms(lambda: pack2.matvec_step(mt_rows, 1, y4, rows), 20),
           median_ms(lambda: pack2.matvec_plain(mt_rows[sl], y4), 5), pass_work(rows, q),
           f" ({rows} x {q} step)", dev_ms=device_ms(lambda: pack2.matvec_step(mt_rows, 1, y4, rows), 20))
    e, s = rel_err(pack2.rank_update_step(mt_rows, 1, u), pack2.rank_update_plain(mt_rows[sl], u))
    report("pack2_rank_update", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update_step(mt_rows, 1, u), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows[sl], u), 5), pass_work(rows, q),
           f" ({rows} x {q} step)", dev_ms=device_ms(lambda: pack2.rank_update_step(mt_rows, 1, u), 20))
    e, s = rel_err(pack2.rank_update(mt_rows, u_all), pack2.rank_update_plain(mt_rows, u_all))
    report("pack2_rank_update_panel", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update(mt_rows, u_all), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows, u_all), 5), pass_work(T * rows, q),
           f" ({T * rows} x {q} whole panel, serving)",
           dev_ms=device_ms(lambda: pack2.rank_update(mt_rows, u_all), 20))
    e, s = rel_err(pack2.matvec(mt_rows, y4), pack2.matvec_plain(mt_rows, y4))
    report("pack2_matvec_panel", e, s, TOL_PASS, median_ms(lambda: pack2.matvec(mt_rows, y4), 20),
           median_ms(lambda: pack2.matvec_plain(mt_rows, y4), 5), pass_work(T * rows, q),
           f" ({T * rows} x {q} whole panel)", dev_ms=device_ms(lambda: pack2.matvec(mt_rows, y4), 20))
    wide_passes()


def r_classes(K):
    """Variance classes and log prior probabilities of a K-class BayesR
    beside the main path's four: 0 and K - 1 classes from 1e-4 to 1e-1
    (one class: the largest of the main path's), with 0.62 on the null class."""
    if K == 1:
        return torch.tensor([PRIOR_R["class_"][-1]], device=DEV), torch.zeros(1, device=DEV)
    varc = torch.tensor([0.0] + list(np.geomspace(1e-4, 1e-1, K - 1)), device=DEV)
    return varc, torch.log(torch.tensor([0.62] + [0.38 / (K - 1)] * (K - 1), device=DEV))


def r_chain_ops(K):
    """The dependent operations of one locus on K3's chain (csrc/r_scan.cu's
    lane rule): the shuffle of pre, pre^2, the K multiply-adds (side by
    side), the maximum tree, the subtraction and expf (~6), the K - 1
    running sums, the threshold and its compare, the K - 1 selects of the
    class, u = beta_old - beta and the next locus's multiply-add into its
    sum."""
    return 14 + (K - 1).bit_length() + 2 * (K - 1)


def r_latency_ms(B, K, mhz):
    """K3's (and K4's) dependent-chain bound for one step: B loci one after
    another, r_chain_ops(K) dependent operations of 4 cycles each, at mhz."""
    return B * r_chain_ops(K) * 4 / (mhz * 1e3)


def scan8_cases(st, z, var_e):
    """The Gaussian and B/C scans at step t = 0 of st's marker set with the
    coefficients of a first sweep on the real data (z, var_e): K6 and K8 on
    an unweighted model, K10 on a weighted one (the weighted and the raw
    Gram). Returns (Step0(st), [(name, kernel(pk_t), plain(pk_t),
    make_rows(unif), near(pk_t, u), work, note, library)]): the names
    without the V=1 tag or `_f64`, the work in 8-byte words (int32 delta
    half a word) where st is float64."""
    ms = st.markers[0]
    _, V, B, _ = ms.mt.shape
    step = Step0(st)
    f64 = st.ycorr.dtype == torch.float64
    isz, kind = (8, ", float64") if f64 else (4, "")
    delta_words = 4 / isz  # an int32 delta in words of isz bytes
    ive = 1.0 / var_e
    flat = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1))
    gram0 = ms.gram[0]
    vb = torch.full_like(ms.beta, V_BC)
    lp0, lp1 = np.log(1.0 - PI_BC), np.log(PI_BC)

    def bc_rows(un, mpm_raw=None):
        return step.rows(gibbs_kernels.bc_block_pack(
            ms.beta, z, un, vb, 1.0 / vb, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
            ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), ive, var_e, lp0, lp1, True,
            mpm_raw=mpm_raw), raw=mpm_raw is not None)

    if st.e.d_inv is not None:
        raw_diag = _gram_raw_diag(ms)
        return step, [(
            "bc_block_scan_wv",
            lambda pk_t: gibbs_kernels.bc_block_scan_wv((ms.gram, 0), (ms.gram_raw, 0), pk_t),
            lambda pk_t: gibbs_kernels.bc_block_scan_wv_plain(gram0, ms.gram_raw[0], pk_t),
            lambda un: bc_rows(un, raw_diag), lambda pk_t, uu: bc_near(ms.gram_raw[0], pk_t, uu, 7),
            scan_work(V, B, 8, 2, 2 + delta_words, 8, itemsize=isz),
            f"V={V}, B={B}, weighted and raw Gram{kind}", None)]

    ivb = torch.full_like(ms.beta, 1.0 / V_PR)

    def gauss_library(pk_t):
        """torch.linalg.solve_triangular on the V unit lower-triangular systems."""
        mat, rhs = gibbs_kernels.gauss_block_system(gram0, pk_t)
        return lambda: torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)[..., 0]

    return step, [(
        "gauss_block_scan_v",
        lambda pk_t: gibbs_kernels.gauss_block_scan_v((ms.gram, 0), pk_t),
        lambda pk_t: gibbs_kernels.gauss_block_scan_v_plain(gram0, pk_t),
        lambda un: step.rows(gibbs_kernels.gauss_block_pack(
            torch.zeros_like(ms.beta), ms.beta, z, ivb, flat["mpm"], flat["lss"], flat["rss"],
            flat["mask"], ive)),
        lambda pk_t, uu: torch.zeros((), dtype=torch.bool, device=DEV),
        scan_work(V, B, 8, 1, 2, 4, itemsize=isz), f"V={V}, B={B}{kind}", gauss_library), (
        "bc_block_scan_v",
        lambda pk_t: gibbs_kernels.bc_block_scan_v((ms.gram, 0), pk_t),
        lambda pk_t: gibbs_kernels.bc_block_scan_v_plain(gram0, pk_t),
        bc_rows, lambda pk_t, uu: bc_near(gram0, pk_t, uu, 0),
        scan_work(V, B, 8, 1, 2 + delta_words, 8, itemsize=isz), f"V={V}, B={B}{kind}", None)]


def scan8_kernels(st, z, var_e, unif, gen, tag, phase="3 kernels", tol=TOL_SCAN, flops=F32_FLOP_PER_S):
    """K6 and K8 (st unweighted) or K10 (st weighted) held to their plain
    versions and timed by held_scan, in st's dtype; the kernels-line name is
    the scan's with the V=1 tag before any `_f64`."""
    step, cases = scan8_cases(st, z, var_e)
    sfx = "_f64" if st.ycorr.dtype == torch.float64 else ""
    for name, kern, plain, make_rows, near, work, note, library in cases:
        held_scan(f"{name}{tag}{sfx}", kern, plain, make_rows, unif, gen, step, near, work, note,
                  library=library, phase=phase, tol=tol, flops=flops)


def r_scan_held(name, st, step, unif, z, gen, varc, logpi, phase="3 kernels"):
    """K3 against its plain version at step t = 0 of st's marker set
    (held_scan), with the coefficients of a first sweep on the real data:
    varc and logpi the K classes' variances and log prior probabilities."""
    ms = st.markers[0]
    _, V, B, _ = ms.mt.shape
    k, gram0, var_e = varc.numel(), ms.gram[0], st.ycorr.var()
    flat = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1))
    held_scan(
        name, lambda pk_t: gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, k),
        lambda pk_t: gibbs_kernels.r_block_scan_v_plain(gram0, pk_t, k),
        lambda un: step.rows(gibbs_kernels.r_block_pack(ms.beta, z, un, **flat, varc=varc, logpi=logpi,
                                                        ive=1.0 / var_e, var_e=var_e)),
        unif, gen, step, lambda pk_t, uu: cdf_near(gram0, pk_t, uu, k),
        scan_work(V, B, 8 + 4 * k, 1, 3, 10 * k), f"V={V}, B={B}, K={k}", phase=phase)


def kernels_phase(spec_for, V=V_MAIN, tag="", full=True):
    """Every kernel of the sweep against its plain version at the paths'
    shapes for this V; with V = 1 (tag "_v1") the single-chain launches of
    the scans, as the V=1 paths make them 192 times per sweep. full = False
    leaves out all but the scans, and K3 at K = 20."""
    plan, st = ngt.assemble(spec_for("BayesR"), vshards=V)
    ms, mp = st.markers[0], plan.markers[0]
    T, V_got, B, q = ms.mt.shape
    K = mp.n_classes
    check(V_got == V and q == pack2.packed_q(N), f"layout (T, V, B, q) = {(T, V_got, B, q)}")
    dt = st.ycorr.dtype
    step = Step0(st)
    if V == V_MAIN and full:
        pass_kernels(st)
        k1_grids(st)

    # the scans at step t=0 with the coefficients of a first sweep on the real data
    gen = torch.Generator(device=DEV).manual_seed(2)
    var_e = st.ycorr.var()
    unif = torch.rand(mp.p_pad, generator=gen, dtype=dt, device=DEV)
    z = torch.randn(mp.p_pad, generator=gen, dtype=dt, device=DEV)

    def r_scan(name, varc, logpi):
        r_scan_held(name, st, step, unif, z, gen, varc, logpi)

    r_scan(f"r_block_scan_v{tag}", ms.var_beta[0] * ms.v_class, ms.log_pi)
    mhz, mhz_max = sm_clocks_mhz()
    lat = r_latency_ms(B, K, mhz)
    TIMINGS[f"r_block_scan_v{tag}"].update(latency_bound_ms=lat, sm_clock_mhz=mhz, sm_clock_max_mhz=mhz_max)
    print(f"[3 kernels] r_block_scan_v{tag}: the dependent-chain bound {lat:.6f} ms ({B} loci x "
          f"{r_chain_ops(K)} operations x 4 cycles at the {mhz:g} MHz SM clock nvidia-smi reports, maximum "
          f"{mhz_max:g}) beside the byte bound {TIMINGS[f'r_block_scan_v{tag}']['bound_ms']:.6f} ms")
    # one class: nothing left of the rule but a multiply-add, so this is what
    # the skeleton costs per locus
    r_scan(f"r_block_scan_v_floor{tag}", *(x.to(dt) for x in r_classes(1)))
    if V == V_MAIN:
        for k in (8, 9, 20) if full else (8, 9):
            r_scan(f"r_block_scan_v_k{k}", *(x.to(dt) for x in r_classes(k)))

    scan8_kernels(st, z, var_e, unif, gen, tag)
    del plan, st, step
    _, st_w = ngt.assemble(spec_for("BayesC+D"), vshards=V)
    scan8_kernels(st_w, z, var_e, unif, gen, tag)
    del st_w
    rc_kernels(spec_for, z, V, tag)


# ------------------------------------------------------------------ phase 4


def slice_phase(path, spec, sig, card, V, n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, tag="",
                ebv_limit=None, auto=False):
    """One path through run_lmem at full size, launch counts read from 0.
    auto: run_lmem's default vshards ("auto"), which must resolve to V;
    ebv_limit: the EBV limit where EBV_LIMITS has none for (path + tag, V)."""
    _, _, scan, gathers = {**PATHS, **EXTRA_PATHS}[path]
    ebv_limit = ebv_limit or EBV_LIMITS.get((path + tag, V))
    var_e_limit = VAR_E_LIMITS.get((path, V))
    _cuda.reset_launches()
    res = ngt.run_lmem(spec, n_chain=n_chain, n_burn=n_burn, n_thin=n_thin, out_folder=None, seed=7,
                       **({} if auto else {"vshards": V}))
    launches = dict(_cuda.LAUNCHES)
    plan, st = res.plan, res.state
    T = plan.markers[0].n_blocks // plan.markers[0].vshards
    check(plan.markers[0].vshards == V,
          f"{path}: V = {plan.markers[0].vshards}, {'auto should give' if auto else 'asked for'} {V}")
    path = f"{path}{tag} V={V}"
    n, p = st.y.shape[0], plan.markers[0].p
    print(f"[4 {path}] {n} x {p}, V={plan.markers[0].vshards} (T={T} block-steps), "
          f"{n_chain} sweeps: {res.sweeps_per_sec:.2f} sweeps/s on {card}")
    print(f"[4 {path}] launches in run_lmem: {launches}")
    expect = {name: 0 for name in launches}
    expect.update({"pack2_matvec": gathers * n_chain * T, "pack2_rank_update": n_chain * T,
                   scan: n_chain * T})
    check(launches == expect, f"{path}: launches {launches}, expected {expect}")
    beta = st.markers[0].beta
    check(torch.isfinite(beta).all().item() and torch.isfinite(st.ycorr).all().item(),
          f"{path}: non-finite beta or ycorr")
    check(res.draws["betaM1"].shape == ((n_chain - n_burn) // n_thin, p), f"{path}: draws shape")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad, f"{path}: kept draws of {bad} are not finite")
    gv = ngt.genomic_values_state(plan, st)
    drift = ((st.ycorr - (st.y - st.fixed[0].b[0] - gv)).abs().max() / st.y.abs().max()).item()

    corr_draw = ebv_corr(gv, sig)
    corr = ebv_corr(ngt.genomic_values_state(plan, st, beta=res.posterior_mean("betaM1")), sig)
    FITS[path] = (float(np.mean(res.draws["varE"])), corr)
    pi = st.markers[0].pi_hat
    limit = "printed only" if ebv_limit is None else f"limit {ebv_limit}"
    print(f"[4 {path}] ycorr drift {drift:.3e} of max|y| (limit 1e-2); EBV corr over 2,048 "
          f"individuals {corr:.4f} from the posterior mean of {res.draws['betaM1'].shape[0]} kept "
          f"draws ({limit}), {corr_draw:.4f} from the last draw; varE {st.e.var_e.item():.4f}"
          f"{'' if var_e_limit is None else f' (limit {var_e_limit})'}; "
          f"pi {None if pi is None else pi.tolist()}; var_beta[:4] "
          f"{st.markers[0].var_beta[:4].tolist()}")
    check(drift < 1e-2, f"{path}: ycorr drifted from y - Xb - Mc beta")
    check(ebv_limit is None or corr >= ebv_limit,
          f"{path}: EBV correlation with the planted signal below {ebv_limit}")
    check(var_e_limit is None or st.e.var_e.item() <= var_e_limit,
          f"{path}: varE {st.e.var_e.item():.4f} above {var_e_limit}")
    check(pi is None or ((pi.sum(-1) - 1.0).abs() < 1e-5).all().item(),
          f"{path}: pi does not sum to 1")
    method_checks(path, plan.markers[0], st.markers[0], res)
    return launches, res


def ebv_corr(g, sig):
    """The correlation of genomic values g with the planted signal over the
    first 2,048 individuals."""
    ebv, tru = g[:2048] - g[:2048].mean(), sig[:2048].to(g.dtype) - sig[:2048].mean()
    return (torch.dot(ebv, tru) / (ebv.norm() * tru.norm())).item()


def method_checks(path, mp, ms, res):
    """What only the annotation and log-variance methods carry."""
    if mp.method == "BayesRCpi":
        acat, nz = ms.annot_cat[:mp.p].long(), ms.annot_nz[:mp.p]
        check(((acat >= 1) & (acat <= mp.n_annot)).all().item(),
              f"{path}: annot_cat outside 1..{mp.n_annot}")
        check(nz.gather(1, (acat - 1).clamp(min=0)[:, None]).all().item(),
              f"{path}: annot_cat points at an annotation that is zero on its locus")
        rows = ms.annot_prob[:mp.p]
        check(((rows.sum(-1) - 1.0).abs() < 1e-5).all().item() and (rows[~nz] == 0).all().item(),
              f"{path}: annot_prob rows do not sum to 1 over the non-zero annotations")
        print(f"[4 {path}] annot_cat counts {torch.bincount(acat)[1:].tolist()}, pi rows "
              f"{ms.pi_hat.tolist()}, var_beta {ms.var_beta.tolist()}")
        check(set(res.draws) >= {"piM1", "annotM1"}, f"{path}: draws lack pi or annot")
    if mp.method == "BayesRCplus":
        check(((ms.delta >= 0) & (ms.delta <= mp.n_classes)).all().item(), f"{path}: delta range")
        print(f"[4 {path}] delta counts {torch.bincount(ms.delta[:mp.p]).tolist()}, var_beta "
              f"{ms.var_beta.tolist()}")
    if mp.method == "BayesLV":
        vb = ms.var_beta[:mp.p]
        check((torch.isfinite(vb) & (vb > 0)).all().item(), f"{path}: var_beta not finite and > 0")
        check(torch.isfinite(ms.lv_c).all().item() and torch.isfinite(ms.log_var).all().item(),
              f"{path}: c or log_var not finite")
        print(f"[4 {path}] var_beta min {vb.min().item():.3e}, median {vb.median().item():.3e}, "
              f"max {vb.max().item():.3e}; c {ms.lv_c.tolist()}; varZeta {ms.var_zeta.item():.4e}")
        check(set(res.draws) >= {"cM1", "varZetaM1"}, f"{path}: draws lack c or varZeta")


def timing_window(path, res, n_timed=50, n_sweeps=10):
    """Steady-state sweep time (each sweep timed to the device finishing
    it), then kernel time by name and the device's busy share over a
    profiled window."""
    from torch.profiler import ProfilerActivity, profile

    sweep = ngt.make_sweep(res.plan)
    stream = PhiloxStream(8, DEV, res.plan.dtype)
    st = sweep(res.state, stream)
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        st = sweep(st, stream)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(times, [25, 50, 75, 90])
    print(f"[4 {path} timing] {n_timed} sweeps timed one by one: median {q[1]:.4f} ms/sweep "
          f"(quartiles {q[0]:.4f}, {q[2]:.4f}; p90 {q[3]:.4f}), {1e3 / q[1]:.2f} sweeps/s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            st = sweep(st, stream)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the sweep's stage scopes are spans, not work: on the device from a stage's
    # first kernel to its last, on the host around everything a stage calls
    events = [e for e in prof.key_averages() if not e.key.startswith("gibbs.")]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    launched = sum(r[2] for r in kernels)
    print(f"[4 {path} profile] {n_sweeps} sweeps, profiler on: wall {wall_ms:.3f} ms "
          f"({wall_ms / n_sweeps:.4f} ms/sweep), {launched / n_sweeps:.1f} kernels/sweep, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for key, ms_, cnt in kernels[:10]:
        print(f"  device {ms_ / n_sweeps:9.4f} ms/sweep  x{cnt / n_sweeps:<5.1f} {key[:80]}")
    for key, ms_, cnt in host[:8]:
        print(f"  host   {ms_ / n_sweeps:9.4f} ms/sweep  x{cnt / n_sweeps:<5.1f} {key[:80]}")
    return dict(median_ms_per_sweep=q[1], profiled_ms_per_sweep=wall_ms / n_sweeps,
                device_busy_ms_per_sweep=busy / n_sweeps, device_busy_share=busy / wall_ms,
                kernels_per_sweep=launched / n_sweeps)


def wide_phase(card):
    """BayesR (estimatePi, V=96) at 50,000 x 49,152, simulated on the card
    as the 10k panel is: a short chain through run_lmem with its launch
    counts, drift and finite draws, then the steady sweep time and a
    profiled window."""
    spec_for, sig = simulate(N_50K)
    launches, res = slice_phase("BayesR", spec_for("BayesR"), sig, card, V_MAIN, N_CHAIN_50K,
                                N_BURN_50K, N_THIN_50K, tag=" 50k")
    window = timing_window("BayesR 50k", res)
    window.update(run_lmem_sweeps_per_s=res.sweeps_per_sec, launches=launches)
    return launches, window


# ------------------------------------------------------------------ phase 5


def method_priors(p):
    """The seven methods' priors, BayesB's and BayesC+D's on a panel of p
    loci: path -> (prior, weighted residual)."""
    annot, lvcov = annotations(p)
    return {"BayesR": (ngt.BayesR(**PRIOR_R), False),
            "BayesB": (ngt.BayesB(PI_BC, V_BC, estimatePi=True), False),
            "BayesC": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), False),
            "BayesC+D": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), True),
            "BayesPR": (ngt.BayesPR(9999, V_PR), False),
            "BayesRCpi": (ngt.BayesRCpi(annot=annot, estimatePi=True, **PRIOR_RC), False),
            "BayesRCplus": (ngt.BayesRCplus(annot=annot, **PRIOR_RC), False),
            "BayesLV": (ngt.BayesLV(V_LV, lvcov, VZETA_LV), False)}


def chain_phase():
    n, p, block, sweeps = 512, 1024, 128, 3
    rng = np.random.default_rng(7)
    g = rng.integers(0, 3, (n, p))
    y = (g - g.mean(0)) @ rng.normal(0, 0.1, p) + rng.normal(0, 1, n)
    weights = rng.uniform(0.5, 2.0, n)

    for name, (prior, weighted) in method_priors(p).items():
        spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                             markers=[ngt.MarkerTerm("M1", ngt.from_array(g), prior)],
                             residual=ngt.RandomEffect(weights, 1.0) if weighted else None,
                             block_size=block)

        def run(device, V, n_sweeps=sweeps, dtype=torch.float32):
            plan, st = ngt.assemble(spec, device=device, dtype=dtype, vshards=V)
            sweep, draws = ngt.make_sweep(plan), HostStream(11, device, dtype)
            for _ in range(n_sweeps):
                st = sweep(st, draws)
            m = st.markers[0]
            return (m.beta.cpu().numpy(), st.ycorr.cpu().numpy(),
                    None if m.log_var is None else m.log_var.cpu().numpy(), st.e.var_e.item())

        for V in (1, 4):
            bk, yk = run(DEV, V)[:2]
            bp, yp = run("cpu", V)[:2]
            cb, cy = np.corrcoef(bk, bp)[0, 1], np.corrcoef(yk, yp)[0, 1]
            dy = np.abs(yk - yp).max() / np.abs(yp).max()
            bk2 = run(DEV, V)[0]
            print(f"[5 chain] {name} V={V}: corr(beta) {cb:.6f}, corr(ycorr) {cy:.6f}, "
                  f"max|dycorr|/scale {dy:.3e} (limits 0.999, 0.999, 0.05); two kernel runs "
                  f"{'bit-identical' if np.array_equal(bk, bk2) else 'DIFFER'}")
            check(cb > 0.999 and cy > 0.999 and dy < 0.05,
                  f"kernel chain departs from plain chain, {name} V={V}")
            check(np.array_equal(bk, bk2), f"two kernel runs from one seed differ, {name} V={V}")
        if name == "BayesLV":
            # float32 on the card against float64 on the CPU over a longer chain: the
            # powers, exponentials and logarithms of the variance draw lose nothing
            # that matters in float32, also where the V=4 schedule inflates varE
            for V in (1, 4):
                k32, p64 = run(DEV, V, 20), run("cpu", V, 20, torch.float64)
                cb, cv = (np.corrcoef(a, b)[0, 1] for a, b in zip(k32[::2], p64[::2]))
                print(f"[5 chain] BayesLV V={V}, 20 sweeps, float32 kernels against float64 plain: "
                      f"corr(beta) {cb:.6f}, corr(log_var) {cv:.6f} (limits 0.999); varE "
                      f"{k32[3]:.4f} against {p64[3]:.4f} (limit 1e-3 relative)")
                check(cb > 0.999 and cv > 0.999 and abs(k32[3] / p64[3] - 1.0) < 1e-3,
                      f"BayesLV V={V}: the float32 kernel chain departs from the float64 plain chain")


# ------------------------------------------------------------------ phase 6

LADDER = dict(rows=36_864, q=12_544, T=16, load_rows=24_576, L=16_384, N=10_240)  # the scripts' sizes
LOAD_Q_BIG = pack2.packed_q(N_BIG)  # 25,088: past the 16 q bytes of shared memory S1 once staged y in


def gather_inputs(rows, q, seed):
    """load32's inputs on the card: bytes uniform in 0..255 and y4 normal.
    {"S1a": (the bytes, y4), "S1b": (their int32 view, y_words(y4, 4))}."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    pk = micro.panel(rows, q, DEV, gen, high=256)
    y4 = torch.randn((4, q), generator=gen, device=DEV)
    return {"S1a": (pk, y4), "S1b": (pk.view(torch.int32), mk.y_words(y4, 4))}


def held_gathers(rows, q, seed):
    """S1a and S1b on a (rows, q) panel: each within TOL_PASS of its plain
    version and of K1's plain version on the same bytes, the same bits from
    a second launch and on grids of 1 and 7 blocks, one launch counted per
    call. Returns the inputs and {case: (max_abs_err, scale)}."""
    cases = gather_inputs(rows, q, seed)
    ref = pack2.matvec_plain(*cases["S1a"])
    errs = {}
    for width, (name, (pkw, yw)) in zip((1, 4), cases.items()):
        before = _cuda.LAUNCHES[f"gather_width{width}"]
        got = mk.gather_width(pkw, yw)
        check(_cuda.LAUNCHES[f"gather_width{width}"] == before + 1, f"{name}: not one launch counted")
        errs[name] = e, s = rel_err(got, mk.gather_width_plain(pkw, yw))
        e_k1, s_k1 = rel_err(got, ref)
        check(e <= TOL_PASS * s and e_k1 <= TOL_PASS * s_k1,
              f"{name} at {rows} x {q}: {e:.3e} of {s:.3e} from its plain version, "
              f"{e_k1:.3e} of {s_k1:.3e} from K1's")
        for blocks in (0, 1, 7):  # 0: as many as are resident, the default
            check(torch.equal(got, mk.gather_width(pkw, yw, blocks=blocks)),
                  f"{name} at {rows} x {q}: other bits on a second launch or another grid")
        print(f"[6 ladder kernels] {name} at {rows} x {q}: max_abs_err {e:.3e} (scale {s:.3e}), "
              f"{e_k1:.3e} from K1's plain version (tol {TOL_PASS:g} x scale); the same bits twice "
              "and on 1 and 7 blocks")
    return cases, errs


def per_launch_ms(walk, launches):
    """Median time of one launch from five walks of `launches` launches each."""
    return statistics.median(micro.walk_ms(walk, DEV, 5)) / launches


def ladder_kernels():
    """The six ladder kernels against their plain versions at the scripts'
    full shapes, on the same inputs: integers exactly equal, floats to
    TOL_PASS of the output's scale, each scatter's two runs bit-identical.
    The S3/S4 kernels are timed over the T fresh steps of the 7.4 GB panel."""
    rows, q, T = LADDER["rows"], LADDER["q"], LADDER["T"]
    ph = "6 ladder kernels"
    pk_all, u, y4 = micro.step_inputs(rows, q, T, DEV, 0)
    got, ref = mk.read_step(pk_all, 1, rows), mk.read_step_plain(pk_all, 1, rows)
    check(torch.equal(got, ref), "read_step: row sums differ from the plain version")
    lib = median_ms(lambda: pk_all[rows:2 * rows].sum(dim=1, dtype=torch.int32), 5)
    report("read_step", 0.0, float(ref.max()), 0.0,
           per_launch_ms(lambda: [mk.read_step(pk_all, t, rows) for t in range(T)], T), lib,
           (rows * q + 4 * rows, rows * q), f" ({rows} x {q} step, T={T} fresh steps; int32 sums "
           f"exactly equal; one addition per byte, taken at the f32 rate; the plain version is "
           f"the one PyTorch call)", library_ms=lib, phase=ph)

    (r0, dy), (ref_r0, ref_dy) = mk.fused_step(pk_all, 0, 1, u, y4), mk.fused_step_plain(pk_all, 0, 1, u, y4)
    again = mk.fused_step(pk_all, 0, 1, u, y4)
    check(torch.equal(r0, again[0]) and torch.equal(dy, again[1]), "fused_step: two runs differ")
    check(torch.equal(r0, pack2.matvec_step(pk_all, 1, y4, rows))
          and torch.equal(dy, pack2.rank_update_step(pk_all, 0, u)),
          "fused_step: r0 lacks K1's bits or dy K2's on the same steps")
    e_d, s_d = rel_err(dy, ref_dy)
    check(e_d <= TOL_PASS * s_d, f"fused_step: dy differs by {e_d:.3e} (scale {s_d:.3e})")
    e_r, s_r = rel_err(r0, ref_r0)
    g_b, g_o = pass_work(rows, q)
    report("fused_step", e_r, s_r, TOL_PASS,
           per_launch_ms(lambda: [mk.fused_step(pk_all, t, (t + 1) % T, u, y4) for t in range(T)], T),
           median_ms(lambda: mk.fused_step_plain(pk_all, 0, 1, u, y4), 3), (2 * g_b, 2 * g_o),
           f" (r0; dy max_abs_err {e_d:.3e} of scale {s_d:.3e}; gather of one {rows} x {q} step "
           f"and scatter of another, T={T} fresh steps, one launch each; r0 K1's bits and dy K2's, "
           "twice)", phase=ph)
    del pk_all, ref_r0, ref_dy

    R = LADDER["load_rows"]
    cases, errs = held_gathers(R, q, 0)
    for width, (name, (pkw, yw)) in zip((1, 4), cases.items()):
        def kern(pkw=pkw, yw=yw):
            return mk.gather_width(pkw, yw)

        report(f"gather_width{width}", *errs[name], TOL_PASS, median_ms(kern, 10),
               median_ms(lambda: mk.gather_width_plain(pkw, yw), 3), pass_work(R, q),
               f" ({name}: {R} x {q} bytes, {width}-byte loads)", phase=ph, dev_ms=device_ms(kern, 20))
    del cases
    held_gathers(ROWS_BIG, LOAD_Q_BIG, 1)

    gen = torch.Generator(device=DEV).manual_seed(0)
    L, Nn = LADDER["L"], LADDER["N"]
    mt = torch.randint(0, 3, (L, Nn), generator=gen, device=DEV, dtype=torch.int8)
    yv, uv = torch.randn(Nn, generator=gen, device=DEV), torch.randn(L, generator=gen, device=DEV)
    mts = micro.copies(mt)  # rotate: 168 MB is not far enough above the 50 MB L2
    work = (L * Nn + 4 * Nn + 4 * L, 2 * L * Nn)
    e, s = rel_err(mk.dense_gather(mt, yv), mk.dense_gather_plain(mt, yv))
    report("dense_gather", e, s, TOL_PASS,
           per_launch_ms(lambda: [mk.dense_gather(m, yv) for m in mts], len(mts)),
           median_ms(lambda: mk.dense_gather_plain(mt, yv), 5), work,
           f" ({L} x {Nn} int8, rotating over {len(mts)} copies)", phase=ph)
    ds = mk.dense_scatter(mt, uv)
    check(torch.equal(ds, mk.dense_scatter(mt, uv)), "dense_scatter: two runs differ")
    e, s = rel_err(ds, mk.dense_scatter_plain(mt, uv))
    report("dense_scatter", e, s, TOL_PASS,
           per_launch_ms(lambda: [mk.dense_scatter(m, uv) for m in mts], len(mts)),
           median_ms(lambda: mk.dense_scatter_plain(mt, uv), 5), work,
           f" ({L} x {Nn} int8, rotating over {len(mts)} copies; two runs bit-identical)", phase=ph)


def ladder_phase(card):
    """The ladder through its entry point at the scripts' sizes, one
    experiment at a time with the launch counts read from 0."""
    ladder_kernels()
    counted = {}
    for name in micro.EXPERIMENTS:
        _cuda.reset_launches()
        print(f"[6 ladder] {name}:")
        rec, = micro.main([name])
        counted[f"ladder {name}"] = dict(_cuda.LAUNCHES)
        check(rec["card"] == card and rec["device"].startswith("cuda"), f"ladder {name}: not on the card")
        times = [c["ms_per_launch"] for c in rec["cases"].values()]
        check(all(np.isfinite(t) and t > 0 for t in times), f"ladder {name}: a case has no time")
    return counted


def other_gathers(srcs):
    """Other trees' S1 and K1: each tree's micro.cu and pack2.cu built alone
    into one library with this tree's nvcc flags, all builds started
    together. {label: (gather(pk, yw), matvec(pk, y4), calls)}: gather runs
    on the grid S1 had before it took K1's rule (gather_blocks, which every
    tree's S1 takes); matvec is K1 on its resident grid; calls() counts
    both."""
    builds = [start_build(src, "gathers", ("micro.cu", "pack2.cu")) for src in srcs]
    arms = {}
    for label, so, proc in builds:
        lib = finish_build(label, so, proc, "gather_width")
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.ngt_gather_width.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        lib.ngt_pack2_matvec.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
        calls = [0]

        def gather(pk, yw, lib=lib, calls=calls, label=label):
            rows, nword = pk.shape
            out = torch.empty(rows, dtype=torch.float32, device=DEV)
            _cuda.check(lib.ngt_gather_width(pk.data_ptr(), yw.data_ptr(), out.data_ptr(), rows, nword,
                                             pk.element_size(), mk.gather_blocks(rows, DEV),
                                             _cuda.stream_of(pk)), f"{label}: ngt_gather_width")
            calls[0] += 1
            return out

        def matvec(pk, y4, lib=lib, calls=calls, label=label):
            rows, q = pk.shape
            out = torch.empty(rows, dtype=torch.float32, device=DEV)
            _cuda.check(lib.ngt_pack2_matvec(pk.data_ptr(), y4.data_ptr(), out.data_ptr(), rows, q, 0,
                                             _cuda.stream_of(pk)), f"{label}: ngt_pack2_matvec")
            calls[0] += 1
            return out

        arms[label] = (gather, matvec, lambda calls=calls: calls[0])
    return arms


def gather_arms(others, reps=20):
    """S1a, S1b and K1 at load32's panel (24,576 x 12,544) for this tree (C)
    and each of others (other_gathers), on the card alone (device_ms, reps
    calls), in turns others, C, C, others reversed. C is first held as phase
    6 holds it, each other arm to the plain versions (whether it has C's bits
    is printed). Last, C is held at q = 25,088 and each other arm tried
    there. Returns the JSON record."""
    R, q = LADDER["load_rows"], LADDER["q"]
    cases, _ = held_gathers(R, q, 0)
    cases["K1"] = cases["S1a"]
    arms = {"C": (mk.gather_width, pack2.matvec, None), **others}
    names = list(others)
    order = names + ["C"] + (["C"] + names[::-1] if names else [])

    def call(arm, case):
        gather, matvec, _ = arms[arm]
        return (matvec if case == "K1" else gather)(*cases[case])

    plain = {case: (pack2.matvec_plain if case == "K1" else mk.gather_width_plain)(*args)
             for case, args in cases.items()}
    mine = {case: call("C", case) for case in cases}
    same = {}
    for arm in names:
        for case in cases:
            got = call(arm, case)
            e, s = rel_err(got, plain[case])
            check(e <= TOL_PASS * s, f"{arm} {case}: {e:.3e} of {s:.3e} from its plain version")
            same[f"{arm} {case}"] = torch.equal(got, mine[case])
    del plain, mine
    ms = {case: {arm: [] for arm in arms} for case in cases}
    for arm in order:
        for case in cases:
            ms[case][arm].append(device_ms(lambda: call(arm, case), reps, calls=arms[arm][2]))
    bound_ms = 1e3 * pass_work(R, q)[0] / HBM_BYTES_PER_S
    for case, by_arm in ms.items():
        print(f"[6 gathers] {case} at {R} x {q}, on the card alone, in turns "
              f"{', '.join(order)}: " + "; ".join(f"{a} {v}" for a, v in by_arm.items())
              + f" ms; byte bound {bound_ms:.6f} ms; "
              + ", ".join(f"{k} {'has' if v else 'lacks'} C's bits" for k, v in same.items()
                          if k.endswith(case)))
    del cases
    held_gathers(ROWS_BIG, LOAD_Q_BIG, 1)
    big = gather_inputs(ROWS_BIG, LOAD_Q_BIG, 1)
    at_big = {}
    for arm in names:  # last: a tree that refuses may leave its runtime's last error set
        for case in ("S1a", "S1b"):
            try:
                e, s = rel_err(arms[arm][0](*big[case]), mk.gather_width_plain(*big[case]))
                at_big[f"{arm} {case}"] = f"max_abs_err {e:.3e} of scale {s:.3e}"
            except (RuntimeError, ValueError) as err:
                at_big[f"{arm} {case}"] = f"refused: {err}"
    print(f"[6 gathers] at {ROWS_BIG} x {LOAD_Q_BIG}: C held; {json.dumps(at_big)}")
    return dict(order=order, ms=ms, bound_ms=bound_ms, same_bits_as_c=same, at_q_25088=at_big)


def gathers_only(card, srcs):
    """`python3 chip_smoke.py gathers [DIR ...]`: S1a, S1b and K1 alone
    (gather_arms), the quick form for work on the ladder's gathers; with
    DIRs (other trees' csrc/, e.g. a `git archive` of the parent under
    _checkout/), theirs in turns beside this tree's. One JSON line, and no
    result line."""
    out = gather_arms(other_gathers(srcs) if srcs else {})
    print(json.dumps({"card": card, "gathers": out}))


def stage_phase(path, res, n_sweeps=10):
    """One profiled window of sweeps through diag.trace: host and device time
    by the sweep's stage scopes, and diag.roofline beside the measured sweep."""
    sweep = ngt.make_sweep(res.plan)
    stream = PhiloxStream(9, DEV, res.plan.dtype)
    st = sweep(res.state, stream)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with diag.trace(log_dir) as prof:
            for _ in range(n_sweeps):
                st = sweep(st, stream)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        trace_bytes = os.path.getsize(os.path.join(log_dir, diag.TRACE_FILE))
    # The scopes appear twice: on the host, and on the device as the span from
    # a stage's first kernel to its last. Kernels launched through ctypes hang
    # on no PyTorch operator, so the profiler's own sums by scope miss them:
    # a stage's busy time is the kernels and copies that lie inside its span.
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    work = [e.time_range for e in on_card if not e.name.startswith("gibbs.")]
    host = {e.key: e for e in prof.key_averages()
            if e.key.startswith("gibbs.") and e.device_type == DeviceType.CPU}
    expect = {"gibbs.var_e", "gibbs.fixed.0", f"gibbs.marker.{res.plan.markers[0].name}"}
    check(set(host) == expect, f"{path}: traced stages {sorted(host)}, expected {sorted(expect)}")
    span, busy = dict.fromkeys(expect, 0.0), dict.fromkeys(expect, 0.0)
    for e in on_card:
        if e.name in expect:
            r = e.time_range
            span[e.name] += r.end - r.start
            busy[e.name] += sum(w.end - w.start for w in work
                                if w.start >= r.start - 0.5 and w.end <= r.end + 0.5)  # microseconds
    all_busy = sum(w.end - w.start for w in work)
    print(f"[6 stages {path}] {n_sweeps} sweeps under diag.trace ({trace_bytes:,} bytes of Chrome "
          f"trace; profiler and export in the wall time: {wall_ms / n_sweeps:.4f} ms/sweep); device "
          f"busy {all_busy / 1e3 / n_sweeps:.4f} ms/sweep in {len(work) / n_sweeps:.1f} kernels and copies")
    for key in sorted(expect):
        check(host[key].count == n_sweeps, f"{path}: stage {key} seen {host[key].count} times")
        print(f"  {key:<20} host {host[key].cpu_time_total / 1e3 / n_sweeps:9.4f} ms/sweep, device busy "
              f"{busy[key] / 1e3 / n_sweeps:9.4f} ms/sweep within a span of "
              f"{span[key] / 1e3 / n_sweeps:9.4f} ms/sweep")
    check(all(b > 0 for b in busy.values()), f"{path}: a stage shows no device time: {busy}")
    check(sum(busy.values()) >= 0.9 * all_busy,
          f"{path}: the stages hold {sum(busy.values()):.0f} of {all_busy:.0f} us of device time")
    st_t = sweep(st, stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        st_t = sweep(st_t, stream)
    torch.cuda.synchronize()
    ms_sweep = (time.perf_counter() - t0) * 1e3 / n_sweeps
    roof = diag.roofline(res.plan, "h100")
    print(f"[6 roofline {path}] {roof} (data sheet: 3,350 GB/s, 67 TFLOP/s f32): least "
          f"{1e3 / roof.sweeps_per_sec_roof:.4f} ms/sweep; measured {ms_sweep:.4f} ms/sweep "
          f"({n_sweeps} sweeps, profiler off), {ms_sweep * roof.sweeps_per_sec_roof / 1e3:.1f}x the roof")


# ------------------------------------------------------------------ phase 7

GAMMA_SHAPES, N_GAMMA = (0.5, 1.0, 3.0, 5000.0, 25_000.0), 4096
TOL_NORMAL, TOL_GAMMA, MAX_ATTEMPT_SHARE = 1e-6, 1e-5, 1e-4
N_CHAIN_OTHERS = 20  # sweeps of each other path in phase 7 (n_keep 4, thin 5)
# operations a keyed draw does per element, counted as 32-bit operations at
# the f32 rate (the data sheet lists no integer or float64 CUDA-core rate):
# ~20 per splitmix64 fold of the key (one per sweep and tail value), ~100 per
# Philox4x32-10 block, ~40 for Box-Muller's logf, cospif and sqrtf in
# float32, ~60 more per gamma attempt for its acceptance test
FOLD_OPS, PHILOX_OPS, BOX_MULLER_OPS, ACCEPT_OPS = 20, 100, 40, 60


def keyed_work(kind, n, n_tail, attempts=None):
    """(bytes, operations) of one keyed draw of n elements: each output
    written once (and a gamma's shapes read once), the operations above;
    a gamma's count follows the attempts this run's data needed."""
    fold = FOLD_OPS * (1 + n_tail)
    if kind == keyed.UNIFORM:
        return 4 * n, n * (fold + PHILOX_OPS)
    if kind == keyed.NORMAL:
        return 4 * n, n * (fold + PHILOX_OPS + BOX_MULLER_OPS)
    tries = int(attempts.sum().item()) + n  # attempt j is the (j + 1)-th
    return 8 * n, n * fold + tries * (PHILOX_OPS + BOX_MULLER_OPS + ACCEPT_OPS)


def keyed_phase(others=None):
    """7a: keyed_rng against its plain version on the card at the main
    path's shapes (p_pad = 49,152 normals and uniforms; gammas at each of
    GAMMA_SHAPES x 4,096): uniforms the same bits, normals within TOL_NORMAL
    of their scale, gammas within TOL_GAMMA relative where both accepted at
    the same attempt, the share of elements whose accepting attempt differs
    printed and at most MAX_ATTEMPT_SHARE; two launches the same bits. The
    normal draw of 49,152 is the kernels line's time (with torch.randn of
    the same size as the library call). Then keyed_arms: R1 on the card
    alone at n = 1, 4 and 49,152 for each kind and at BayesR's six draws,
    beside the library call at the same n (and others' R1, where given)."""
    h0, tail = keyed._splitmix64(7), (4, 0, 4, 0)  # BayesR's z: marker stage, set 0, split(4)[0]
    counter = torch.tensor(50, dtype=torch.int64, device=DEV)
    alpha = torch.tensor(GAMMA_SHAPES, device=DEV).repeat_interleave(N_GAMMA)
    ph = "7 graph keyed_rng"
    out = {}
    for kind, name, n in ((keyed.UNIFORM, "uniform", P), (keyed.NORMAL, "normal", P),
                          (keyed.GAMMA, "gamma", alpha.numel())):
        a = alpha if kind == keyed.GAMMA else None

        def kern():
            return keyed.keyed_draw(kind, h0, counter, tail, n, torch.float32, a)

        def plain():
            return keyed.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, a)

        got, att = keyed.keyed_draw(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        ref, ref_att = keyed.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        check(torch.equal(got, kern()), f"keyed_rng {name}: two launches differ")
        check(torch.isfinite(got).all().item(), f"keyed_rng {name}: not finite")
        ms_k, ms_p, dev_ms = median_ms(kern, 20), median_ms(plain, 3), device_ms(kern, 20)
        bytes_, ops = keyed_work(kind, n, len(tail), att if kind == keyed.GAMMA else None)
        rec = dict(ms=ms_k, plain_ms=ms_p, device_ms=dev_ms, work=(bytes_, ops))
        if kind == keyed.UNIFORM:
            check(torch.equal(got, ref), "keyed_rng uniform: not the plain version's bits")
            rec["max_abs_err"] = 0.0
            print(f"[{ph}] uniform x {n:,}: the plain version's bits; kernel {ms_k:.4f} ms "
                  f"({dev_ms} ms on the card), plain {ms_p:.4f} ms, torch.rand "
                  f"{median_ms(lambda: torch.rand(n, device=DEV), 20):.4f} ms")
        elif kind == keyed.NORMAL:
            draw = lambda: torch.randn(n, device=DEV)  # noqa: E731
            lib, lib_dev = median_ms(draw, 20), device_ms(draw, 20, records_per_launch=0)
            library_moments("torch.randn", draw(), 0.0, 1.0)
            e, sc = rel_err(got, ref)
            report("keyed_rng", e, sc, TOL_NORMAL, ms_k, ms_p, (bytes_, ops),
                   f" (normal x {n:,}, BayesR's z at p_pad; not a TPU kernel: the counterpart of "
                   f"jax.random under fold_in; operations counted at the f32 rate; the library's "
                   "stream is another, so its draws are held to the moments only)",
                   library_ms=lib, phase=ph, dev_ms=dev_ms, library_dev_ms=lib_dev)
            rec["max_abs_err"] = e
        else:
            same = att == ref_att
            check((att >= 0).all().item() and (ref_att >= 0).all().item(),
                  "keyed_rng gamma: an element never accepted")
            rel = ((got - ref).abs() / ref.abs())[same].max().item()
            share = 1.0 - same.float().mean().item()
            draw = lambda: torch._standard_gamma(alpha)  # noqa: E731
            lib, lib_dev = median_ms(draw, 20), device_ms(draw, 20, records_per_launch=0)
            lib_draws = draw()
            for i, s in enumerate(GAMMA_SHAPES):
                library_moments(f"torch._standard_gamma({s:g})",
                                lib_draws[i * N_GAMMA:(i + 1) * N_GAMMA] / s ** 0.5, s ** 0.5, 1.0,
                                6.0 / s)
            per_shape = ", ".join(
                f"{s:g}: mean {got[i * N_GAMMA:(i + 1) * N_GAMMA].mean().item():.4f}, attempts "
                f"{(att[i * N_GAMMA:(i + 1) * N_GAMMA] + 1).float().mean().item():.4f}"
                for i, s in enumerate(GAMMA_SHAPES))
            print(f"[{ph}] gamma x {n:,}: max rel err {rel:.3e} where the attempts agree (tol "
                  f"{TOL_GAMMA:g}); accepting attempt differs for a share {share:.3e} (limit "
                  f"{MAX_ATTEMPT_SHARE:g}); kernel {ms_k:.4f} ms ({dev_ms} ms on the card), plain "
                  f"{ms_p:.4f} ms, torch._standard_gamma {lib:.4f} ms ({lib_dev} ms on the card); "
                  f"by shape {per_shape}")
            check(rel <= TOL_GAMMA and share <= MAX_ATTEMPT_SHARE,
                  "keyed_rng gamma departs from its plain version")
            rec.update(max_abs_err=rel, attempts_differ=share, library_ms=lib, library_device_ms=lib_dev)
        out[name] = rec
    out["sizes"] = keyed_arms(others)
    return out


KEYED_SIZES = (1, 4, P)  # R1 on the card alone at each of these n, for each kind
# The gammas of a BayesR sweep at 10,000 x 49,152: varE's chi2 has shape
# (e_df + n) / 2, the class variance's (df + nonzero loci) / 2 at the prior's
# 10 % of loci, the Dirichlet's the counts + 1 at the prior's shares.
VAR_E_SHAPE, CLASS_VAR_SHAPE, DIRICHLET_SHAPES = (5002.0,), (2459.5,), (44238.0, 2459.0, 1476.0, 983.0)
# A BayesR sweep's six keyed draws in sweep order: (draw, its keyed_cases label)
BAYESR_DRAWS = (("varE chi2", "gamma x 1"), ("intercept", "normal x 1"), ("z", f"normal x {P:,}"),
                ("u", f"uniform x {P:,}"), ("class variance chi2", "gamma x 1 (class variance)"),
                ("Dirichlet", "gamma x 4"))


def keyed_cases():
    """R1's timed cases: (label, kind, n, alpha) for each kind at
    KEYED_SIZES (gammas at n = 1 and 4 take varE's and the Dirichlet's
    shapes, at p_pad GAMMA_SHAPES in turn), then BayesR's class-variance
    draw, the one of its six not among them."""
    def shapes(vals, n):
        return torch.tensor(vals, device=DEV).repeat(-(-n // len(vals)))[:n].contiguous()

    gam = {1: VAR_E_SHAPE, 4: DIRICHLET_SHAPES, P: GAMMA_SHAPES}
    cases = [(f"{name} x {n:,}", kind, n, shapes(gam[n], n) if kind == keyed.GAMMA else None)
             for kind, name in ((keyed.UNIFORM, "uniform"), (keyed.NORMAL, "normal"),
                                (keyed.GAMMA, "gamma")) for n in KEYED_SIZES]
    cases.append(("gamma x 1 (class variance)", keyed.GAMMA, 1, shapes(CLASS_VAR_SHAPE, 1)))
    return cases


def keyed_library(kind, n, alpha):
    """The one PyTorch call that draws what a keyed draw draws (another stream)."""
    if kind == keyed.UNIFORM:
        return lambda: torch.rand(n, device=DEV)
    if kind == keyed.NORMAL:
        return lambda: torch.randn(n, device=DEV)
    return lambda: torch._standard_gamma(alpha)


def start_build(src, kind, sources, patches=(), label=None):
    """Start nvcc on `sources` of another tree's csrc/ directory src, copied
    beside its headers, into one library with this tree's flags: (label,
    the library's path, the process). patches: (old, new) text pairs, each
    found exactly once in the copied sources and replaced there (a scratch
    copy with one part taken out). The label, unless given, is the tree's
    name (src's grandparent, where src is a tree's nextgp_tpu_torch/csrc),
    or src's own name."""
    src = Path(src).resolve()
    if label is None:
        label = src.parent.parent.name if src.parent.name == "nextgp_tpu_torch" else src.name
    out = _cuda.BUILD_ROOT / f"{kind}_{re.sub(r'[^A-Za-z0-9_.-]', '_', label)}"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*src.glob("*.cuh"), *(src / s for s in sources)]:
        shutil.copy(f, out / f.name)
    for old, new in patches:
        hits = [(out / s) for s in sources if (out / s).read_text().count(old)]
        check(len(hits) == 1 and hits[0].read_text().count(old) == 1,
              f"{label}: the patch of {old!r} matches {len(hits)} sources, or more than once")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    so = out / "lib.so"
    return label, so, subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(so),
         *(str(out / s) for s in sources)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(label, so, proc, kernel=None):
    """Wait for start_build's nvcc and load its library; print ptxas's
    register and spill lines for the entries whose names hold `kernel`."""
    log = proc.communicate(timeout=600)[0]
    check(proc.returncode == 0, f"nvcc of {label}'s sources ({proc.returncode}):\n{log[-3000:]}")
    entry = ""
    for line in log.splitlines() if kernel else ():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif kernel in entry and ("Used" in line or "spill" in line):
            print(f"  ptxas {label} {entry}: {line.strip()}")
    return ctypes.CDLL(str(so))


def other_keyed_rng(srcs):
    """Other trees' R1, each built alone from a csrc/ directory with this
    tree's nvcc flags, all builds started together: {label: (draw, calls)}
    with draw(kind, h0, counter, tail, n, alpha) -> float32 out, and calls()
    the draws made so far. The label is the directory's parent's name (the
    tree's), or the directory's where that is `nextgp_tpu_torch`."""
    builds = [start_build(src, "keyed", ("keyed_rng.cu",)) for src in srcs]
    arms = {}
    for label, so, proc in builds:
        lib = finish_build(label, so, proc)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.ngt_keyed_rng.argtypes = [ptr, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong),
                                      i64, i64, ptr, ptr, ptr, i64, ptr]
        lib.ngt_keyed_rng.restype = ctypes.c_int
        calls = [0]

        def draw(kind, h0, counter, tail, n, alpha, lib=lib, calls=calls, label=label):
            out = torch.empty(n, dtype=torch.float32, device=DEV)
            words = (ctypes.c_ulonglong * keyed.MAX_TAIL)(*tail)
            _cuda.check(lib.ngt_keyed_rng(counter.data_ptr(), h0, words, len(tail), kind,
                                          None if alpha is None else alpha.data_ptr(), out.data_ptr(),
                                          None, n, _cuda.stream_of(counter)), f"{label}: ngt_keyed_rng")
            calls[0] += 1
            return out

        arms[label] = (draw, lambda calls=calls: calls[0])
    return arms


def hold_keyed(label, kind, h0, counter, tail, n, alpha):
    """This tree's R1 against its plain version on one case, under phase 7a's
    tolerances, and two launches the same bits."""
    got, att = keyed.keyed_draw(kind, h0, counter, tail, n, torch.float32, alpha, iters=True)
    ref, ref_att = keyed.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, alpha, iters=True)
    check(torch.equal(got, keyed.keyed_draw(kind, h0, counter, tail, n, torch.float32, alpha)),
          f"keyed_rng {label}: two launches differ")
    if kind == keyed.UNIFORM:
        ok = torch.equal(got, ref)
    elif kind == keyed.NORMAL:
        ok = (got - ref).abs().max().item() <= TOL_NORMAL * ref.abs().max().item()
    else:
        same = att == ref_att
        ok = ((att >= 0).all().item() and 1.0 - same.float().mean().item() <= MAX_ATTEMPT_SHARE
              and ((got - ref).abs() / ref.abs())[same].max().item() <= TOL_GAMMA)
    check(ok, f"keyed_rng {label} departs from its plain version")


def keyed_arms(others=None, reps=20):
    """R1 on the card alone (device_ms) at each of keyed_cases, beside the
    library call at the same n. With others (other_keyed_rng), each of them
    and this tree's R1 (C) in turns: others, C, C, others reversed; each
    other's output is also compared with C's (same bits or not: printed,
    not held). Prints one line a case and the sum over BAYESR_DRAWS for
    each arm and the library; returns {case: {arm: [ms...], "library": ms}}."""
    h0, tail = keyed._splitmix64(7), (4, 0, 4, 0)
    counter = torch.tensor(50, dtype=torch.int64, device=DEV)
    arms = {"C": (lambda kind, h0, counter, tail, n, alpha:
                  keyed.keyed_draw(kind, h0, counter, tail, n, torch.float32, alpha), None)}
    names = list(others or ())
    order = names + ["C"] + (["C"] + names[::-1] if names else [])
    if others:
        arms.update(others)
    out = {}
    for label, kind, n, alpha in keyed_cases():
        rec = {arm: [] for arm in arms}
        hold_keyed(label, kind, h0, counter, tail, n, alpha)
        ref = arms["C"][0](kind, h0, counter, tail, n, alpha)
        same = {arm: torch.equal(arms[arm][0](kind, h0, counter, tail, n, alpha), ref) for arm in names}
        for arm in order:
            fn, calls = arms[arm]
            rec[arm].append(device_ms(lambda: fn(kind, h0, counter, tail, n, alpha), reps, calls=calls))
        rec["library"] = device_ms(keyed_library(kind, n, alpha), reps, records_per_launch=0)
        out[label] = rec
        arms_txt = ", ".join(f"{a} {rec[a]}" for a in dict.fromkeys(order))
        bits = "".join(f"; {a} {'has' if same[a] else 'lacks'} C's bits" for a in names)
        print(f"[7 keyed_rng] R1 {label}, on the card alone: {arms_txt} ms; library "
              f"{rec['library']} ms{bits}")
    def med(v):
        return (None if None in v else statistics.median(v)) if isinstance(v, list) else v

    six = [out[label] for _, label in BAYESR_DRAWS]
    sums = {}
    for arm in [*dict.fromkeys(order), "library"]:
        vals = [med(rec[arm]) for rec in six]
        sums[arm] = None if None in vals else sum(vals)
    print("[7 keyed_rng] a BayesR sweep's six keyed draws (" + ", ".join(d[0] for d in BAYESR_DRAWS)
          + "), summed on the card alone: " + ", ".join(f"{a} {v}" for a, v in sums.items()) + " ms")
    out["bayesr_sweep_sum"] = sums
    return out


def library_moments(name, x, mean, var, kurt=0.0):
    """A library's draws, whose stream is not the kernel's, held to the
    distribution's mean and variance (excess kurtosis kurt) within 6
    standard errors."""
    n = x.numel()
    m, v = x.double().mean().item(), x.double().var().item()
    ok = abs(m - mean) <= 6 * (var / n) ** 0.5 and abs(v - var) <= 6 * var * ((2.0 + kurt) / n) ** 0.5
    print(f"[7 graph keyed_rng] {name} x {n:,}: mean {m:.4f} (expected {mean:g}), variance {v:.4f} "
          f"(expected {var:g})")
    check(ok, f"{name}: moments off")


def replay_window(rep, n):
    """Kernels on the card over n replays of the sweep graph, from the
    profiler: (device busy ms per sweep, kernels and copies per sweep, the
    records the profiler missed, kernels per sweep by name, device ms per
    sweep by name). A graph's kernels are
    counted here, not by the wrappers' counters, which count a capture once.
    Every node runs once a replay, so a name's count per sweep is its
    records over n, rounded, and its time its mean record times that count:
    the profiler drops a few records of a window now and then (device_ms
    says so), which this leaves out of both."""
    from torch.profiler import ProfilerActivity, profile

    rep.run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep.run(n)
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
    per = {e.key: round(e.count / n) for e in recs}
    ms_by = {e.key: e.self_device_time_total / e.count * per[e.key] / 1e3 for e in recs}
    missed = n * sum(per.values()) - sum(e.count for e in recs)
    return sum(ms_by.values()), sum(per.values()), missed, per, ms_by


def steady_ms(step, n):
    """ms per sweep over n sweeps, CUDA events around the whole window."""
    step()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        step()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def fit_checks(tag, plan, st, draws, sig, ebv_limit=None, phase="7", drift_limit=1e-2):
    """Drift of ycorr from y - Xb - Mc beta (below drift_limit of max|y|:
    1e-2 in float32, 1e-9 in float64), finite draws, and the EBV
    correlation of the posterior mean of beta with the planted signal."""
    bad = [k for k, a in draws.items() if not torch.isfinite(a.double()).all().item()]
    check(not bad, f"{tag}: kept draws of {bad} are not finite")
    gv = ngt.genomic_values_state(plan, st)
    drift = ((st.ycorr - (st.y - st.fixed[0].b[0] - gv)).abs().max() / st.y.abs().max()).item()
    mean = ngt.genomic_values_state(plan, st, beta=draws["betaM1"].mean(0).cpu().numpy())
    ebv, tru = mean[:2048] - mean[:2048].mean(), sig[:2048].to(mean.dtype) - sig[:2048].mean()
    corr = (torch.dot(ebv, tru) / (ebv.norm() * tru.norm())).item()
    limit = "printed only" if ebv_limit is None else f"limit {ebv_limit}"
    print(f"[{phase} {tag}] ycorr drift {drift:.3e} of max|y| (limit {drift_limit:g}); EBV corr "
          f"{corr:.4f} ({limit})")
    check(drift < drift_limit, f"{tag}: ycorr drifted from y - Xb - Mc beta")
    check(ebv_limit is None or corr >= ebv_limit, f"{tag}: EBV correlation below {ebv_limit}")
    return dict(drift=drift, ebv_corr=corr)


def graph_path(path, spec, sig, V, n_chain, n_burn, n_thin, ebv_limit=None, tag="", n_window=50,
               dtype=None, phase="7", drift_limit=1e-2, var_e_limit=None):
    """One path eagerly and replayed with the same KeyedStream from the same
    state: the eager chain a loop of make_sweep (launches counted by the
    wrappers), the replayed chain run_lmem with the KeyedStream (burn-in and
    thinning as graph replays, CUDA events around it). The kept draws and
    the final ycorr must be the same bits. Then each arm's steady ms/sweep
    (events around n_window sweeps), the replays' device busy per sweep and
    kernels per sweep from a profiled window, and the device's idle share
    without the profiler: 1 - busy / (event ms per sweep). dtype: the
    engine's (float32 unless given; float64 counts the kernels' float64
    instances). var_e_limit: a ceiling on the final residual variance
    (VAR_E_LIMITS), which is printed in any case."""
    name = f"{path}{tag} V={V}"
    n_keep = (n_chain - n_burn) // n_thin
    plan, st0 = ngt.assemble(spec, vshards=V, dtype=dtype)
    f64 = "_f64" if plan.dtype == torch.float64 else ""
    stream = keyed.KeyedStream(7, DEV, plan.dtype)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, kept = st0, []
    for _ in range(n_burn):
        st = sweep(st, stream)
    for _ in range(n_keep):
        for _ in range(n_thin):
            st = sweep(st, stream)
        kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = dict(_cuda.LAUNCHES)
    eager = {k: torch.stack([x[k] for x in kept]) for k in kept[0]}
    _, _, scan, gathers = {**PATHS, **EXTRA_PATHS}[path]
    T = plan.markers[0].n_blocks // V
    expect = {k: 0 for k in eager_launches}
    expect.update({"pack2_matvec" + f64: gathers * n_chain * T, "pack2_rank_update" + f64: n_chain * T,
                   scan + f64: n_chain * T, "keyed_rng": eager_launches["keyed_rng"]})
    check(eager_launches == expect and eager_launches["keyed_rng"] % n_chain == 0
          and eager_launches["keyed_rng"] > 0, f"{name}: eager launches {eager_launches}")

    _cuda.reset_launches()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    res = ngt.run_lmem(spec, n_chain=n_chain, n_burn=n_burn, n_thin=n_thin, out_folder=None, vshards=V,
                       stream=stream, dtype=dtype)
    b.record()
    b.synchronize()
    captured = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    replay_ms = a.elapsed_time(b)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), res.draws[k])]
    check(set(res.draws) == set(eager) and not differ, f"{name}: replayed draws {differ} differ from eager")
    check(torch.equal(res.state.ycorr, st.ycorr), f"{name}: replayed ycorr differs from eager")
    check(res.state.sweep_index == st.sweep_index == n_chain and int(res.state.sweep_counter) == n_chain,
          f"{name}: sweep index {res.state.sweep_index}, counter {int(res.state.sweep_counter)}")
    fit = fit_checks(name, res.plan, res.state, {k: torch.from_numpy(v) for k, v in res.draws.items()},
                     sig, ebv_limit, phase=phase, drift_limit=drift_limit)
    fit["var_e"] = res.state.e.var_e.item()
    print(f"[{phase} {name}] varE {fit['var_e']:.4f}"
          + ("" if var_e_limit is None else f" (limit {var_e_limit})"))
    check(var_e_limit is None or fit["var_e"] <= var_e_limit, f"{name}: varE above {var_e_limit}")
    print(f"[{phase} {name}] {n_chain} sweeps ({n_burn} burn-in, thin {n_thin}), the same KeyedStream: "
          f"kept draws and final ycorr bit-identical eager and replayed; eager {n_chain / eager_s:.2f} "
          f"sweeps/s (host clock), replayed run_lmem {res.sweeps_per_sec:.2f} sweeps/s (host clock; "
          f"CUDA events around it {replay_ms:.3f} ms, capture of two graphs and one warm-up sweep in it)")

    rep = engine_sweep.ReplayedSweep(plan, res.state, stream)
    state = [res.state]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, n_window)
    ms_replay = steady_ms(lambda: rep.run(1), n_window)
    busy, per_sweep, missed, by_name, ms_by = replay_window(rep, 10)
    idle = 1.0 - busy / ms_replay
    r1 = [k for k in by_name if "keyed_rng" in k]
    r1_ms = sum(ms_by[k] for k in r1)
    eager_per_sweep = {k: v / n_chain for k, v in eager_launches.items() if v}
    print(f"[{phase} {name}] steady, {n_window} sweeps between CUDA events: eager {ms_eager:.4f} ms/sweep "
          f"({1e3 / ms_eager:.2f} sweeps/s), replayed {ms_replay:.4f} ms/sweep ({1e3 / ms_replay:.2f} "
          f"sweeps/s); 10 replays under the profiler: device busy {busy:.4f} ms/sweep, {per_sweep} "
          f"kernels and copies per sweep ({missed} records missed); idle share without the profiler "
          f"{idle:.4f}; R1 (keyed_rng) {sum(by_name[k] for k in r1)} launches, {r1_ms:.4f} ms "
          "of the replayed sweep's device time")
    print(f"[{phase} {name}] launches per sweep: eager by the wrappers {eager_per_sweep}; replayed, counted "
          f"by the wrappers at capture (one warm-up sweep and two captured sweeps) {captured}")
    for key, cnt in sorted(by_name.items(), key=lambda r: -r[1])[:6]:
        print(f"  replayed x{cnt:<4} {key[:90]}")
    replay_rate = res.sweeps_per_sec
    del rep, state, res
    return dict(eager_sweeps_per_s=n_chain / eager_s, replay_run_lmem_sweeps_per_s=replay_rate,
                eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay,
                replay_busy_ms_per_sweep=busy, replay_kernels_per_sweep=per_sweep, idle_share=idle,
                replay_keyed_rng_ms_per_sweep=r1_ms, replay_event_ms=replay_ms, eager_launches=eager_launches, **fit)


def graph_phase(spec_for, sig, wide_eager_ms=None):
    """7: keyed_rng against its plain version (7a); BayesR at V=96 and V=1
    (7b) and the other six paths at V=96 (7c, N_CHAIN_OTHERS sweeps each, so
    that every scan runs inside a graph), each eager and replayed with one
    KeyedStream; BayesR at 50,000 x 49,152 replayed (7d), its ms/sweep
    beside phase 4's eager number where phase 4 ran. Returns the numbers
    and the eager launch counts by run."""
    out = {"keyed_rng": keyed_phase()}
    counted = {}
    for V in (V_MAIN, 1):
        rec = graph_path("BayesR", spec_for("BayesR"), sig, V, N_CHAIN, N_BURN, N_THIN,
                         EBV_LIMITS.get(("BayesR", V)))
        counted[f"BayesR keyed V={V}"] = rec.pop("eager_launches")
        out[f"BayesR V={V}"] = rec
    for path in PATHS:
        if path != "BayesR":
            rec = graph_path(path, spec_for(path), sig, V_MAIN, N_CHAIN_OTHERS, 0, N_THIN)
            counted[f"{path} keyed V={V_MAIN}"] = rec.pop("eager_launches")
            out[f"{path} V={V_MAIN}"] = rec
    del spec_for
    spec_wide, sig_wide = simulate(N_50K)
    rec = graph_path("BayesR", spec_wide("BayesR"), sig_wide, V_MAIN, N_CHAIN_50K, N_BURN_50K,
                     N_THIN_50K, tag=" 50k")
    counted[f"BayesR 50k keyed V={V_MAIN}"] = rec.pop("eager_launches")
    rec["phase4_eager_ms_per_sweep"] = wide_eager_ms
    if wide_eager_ms is not None:
        print(f"[7 BayesR 50k V={V_MAIN}] replayed {rec['replay_ms_per_sweep']:.4f} ms/sweep beside "
              f"phase 4's eager {wide_eager_ms:.4f} ms/sweep (sweeps timed one by one) in this call")
    out[f"BayesR 50k V={V_MAIN}"] = rec
    return out, counted


# ------------------------------------------------------------------ phase 8

N_CHAIN_RE, N_BURN_RE, N_THIN_RE = 100, 50, 5
VAR_A = 1.0  # the planted polygenic variance, and the animal effects' prior variance
GEN_SIZE_A, GENS = 2_000, 5  # the 10,000-animal pedigree over the panel's individuals
CG_GEN_SIZE, CG_RECORDED_GENS, MAX_PROGENY = 20_000, 3, 50  # the 100,000-animal pedigree
N_CG_CHAIN, N_CG_BURN, N_CG_THIN, N_CG_F32 = 20, 10, 5, 5
CG_GEN_SIZE_1M = 200_000  # `cg`: 1,000,000 animals
# CG1's x against its plain version's, of x's scale, float64, the same iterations: an
# iterate CG stops on is up to ~cond * tol from the solution, and two solvers whose sums
# round in other orders stop on iterates a fraction of that apart, so at the plan's 1e-8
# x is held to 1e-6 and, solved to 1e-12, to 1e-10
TOL_CG, TOL_CG_TIGHT, CG_TIGHT = 1e-6, 1e-10, 1e-12
GBLUP_EBV_LIMIT = 0.8
TOL_RE1 = 1e-4  # u relative to its scale: float32 sums in the kernel's order and the plain's


def simulate_pedigree(n_gen, size, seed, max_progeny=MAX_PROGENY):
    """A pedigree of n_gen discrete generations of `size` animals, listed
    parents first: generation 0 unrelated founders; in each later one every
    animal has a sire among the first half of the generation before (each
    sire at most max_progeny offspring) and a dam among its second half.
    Returns the ordered Pedigree and the planted polygenic values, drawn by
    the Henderson recursion u_i = (u_sire + u_dam) / 2 + sqrt(d_i VAR_A) e_i
    (d_i the Mendelian-sampling variance, with inbreeding): no Cholesky."""
    rng = np.random.default_rng(seed)
    n = n_gen * size
    sire, dam = np.full(n, -1), np.full(n, -1)
    for gen in range(1, n_gen):
        prev = np.arange((gen - 1) * size, gen * size)
        n_sires = -(-size // max_progeny)
        sires = rng.choice(prev[: size // 2], n_sires, replace=False)
        kids = np.arange(gen * size, (gen + 1) * size)
        sire[kids] = np.repeat(sires, max_progeny)[rng.permutation(n_sires * max_progeny)[:size]]
        dam[kids] = rng.choice(prev[size // 2:], size)
    lbl = [str(i) for i in range(n)]
    ped = ngt.build_pedigree(lbl, [None if s < 0 else lbl[s] for s in sire],
                             [None if d < 0 else lbl[d] for d in dam])
    check(ped.ids == lbl, "the simulated pedigree is listed parents first")
    return ped, henderson_values(ped, n_gen, size, rng)


_PED8 = {}  # phase 8's pedigree, planted values and dense A^-1, made once a process


def phase8_pedigree():
    """Phase 8's 10,000-animal pedigree (GENS generations of GEN_SIZE_A,
    seed 11), its planted polygenic values and its dense A^-1 (host
    float64), made once a process and shared by phases 8, 9 and 14."""
    if not _PED8:
        ped, u = simulate_pedigree(GENS, GEN_SIZE_A, seed=11)
        _PED8.update(ped=ped, u=u, ainv=pedigree.a_inverse(ped))
    return _PED8["ped"], _PED8["u"], _PED8["ainv"]


def henderson_values(ped, n_gen, size, rng):
    """Polygenic values on simulate_pedigree's pedigree by the Henderson
    recursion, Mendelian sampling from rng."""
    _, _, dsq = pedigree.a_inverse_factor(ped)
    u = np.zeros(ped.n)
    for gen in range(n_gen):  # parents are in the generation before
        i = np.arange(gen * size, (gen + 1) * size)
        par = np.where(ped.sire[i] >= 0, u[ped.sire[i]], 0.0) + np.where(ped.dam[i] >= 0, u[ped.dam[i]], 0.0)
        u[i] = 0.5 * par + rng.normal(size=size) * np.sqrt(VAR_A) / dsq[i]
    return u


def residual_drift(plan, st):
    """max |ycorr - (y - Xb - Zu - Mc beta)| / max |y|."""
    fit = sum(fs.x @ fs.b for fs in st.fixed)
    for rs, rp in zip(st.random, plan.random):
        if rp.sampler == "cg":
            fit = fit + torch.where(rs.z_idx >= 0, rs.u[rs.z_idx.clamp(min=0).long()], 0.0)
        else:
            fit = fit + rs.z @ rs.u
    if plan.markers:
        fit = fit + ngt.genomic_values_state(plan, st)
    return ((st.ycorr - (st.y - fit)).abs().max() / st.y.abs().max()).item()


def corr(a, b):
    a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def work_re1(q, itemsize=4):
    """(bytes, operations) of one level scan: the structure's lower triangle
    (all the function needs, by symmetry) and yi, zpz, z, the old u read, the
    new u written, each element `itemsize` bytes (8 for the float64
    instance); a multiply-add per element of the triangle."""
    return itemsize * q * (q + 1) // 2 + 5 * itemsize * q, q * (q + 1)


# RE1's edges beside the main path's q: one level, a group of 32 and one
# either side, the look-ahead's 32 (L + 1) levels and one either side, one
# past the old tile of 1,024, and 3,001 (q not a multiple of 4)
RE1_EDGES = tuple(sorted({1, 31, 33, 1025, 3001} | {32 * (random_scan.LOOKAHEAD + 1) + d for d in (-1, 1)}))


def re1_inputs(q, ive, ivu):
    """RE1's inputs at q on a random positive-definite structure, seeded by q."""
    g = torch.Generator(device=DEV).manual_seed(q)
    m = torch.randn(q, q, generator=g, device=DEV) / q ** 0.5
    yi, z, u = (torch.randn(q, generator=g, device=DEV) for _ in range(3))
    return ((m @ m.T + torch.eye(q, device=DEV)).contiguous(), yi,
            torch.rand(q, generator=g, device=DEV) * 3, z, u, ive, ivu)


def other_level_scan(src):
    """Another tree's RE1, built alone from its csrc/ directory src with this
    tree's nvcc flags: (a function of level_scan_kernel's arguments, a
    function giving its calls so far, the kernel records one call makes at
    q). A tree before the persistent design (no ngt_level_scan_scratch_words)
    takes q words of scratch and launches each of its two kernels once per
    tile of 1,024 levels."""
    out = _cuda.BUILD_ROOT / "re1_other"
    out.mkdir(parents=True, exist_ok=True)
    for f in [*Path(src).glob("*.cuh"), Path(src) / "level_scan.cu"]:
        shutil.copy(f, out / f.name)
    so = out / "lib.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(so),
                          str(out / "level_scan.cu")], capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"nvcc of {src}/level_scan.cu ({res.returncode}):\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.ngt_level_scan.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    persistent = hasattr(lib, "ngt_level_scan_scratch_words")
    if persistent:
        lib.ngt_level_scan_scratch_words.argtypes = [i64]
        lib.ngt_level_scan_scratch_words.restype = i64
    calls = [0]

    def level_scan(ivstr, yi, zpz, z, u, ive, ivu):
        q = u.shape[0]
        out, scratch = u.clone(), torch.empty(
            lib.ngt_level_scan_scratch_words(q) if persistent else q, dtype=torch.float32, device=u.device)
        _cuda.check(lib.ngt_level_scan(ivstr.data_ptr(), q, yi.data_ptr(), zpz.data_ptr(), z.data_ptr(),
                                       out.data_ptr(), scratch.data_ptr(), ive.data_ptr(), ivu.data_ptr(),
                                       _cuda.stream_of(u)), f"{src}: ngt_level_scan")
        calls[0] += 1
        return out

    return level_scan, lambda: calls[0], lambda q: 1 if persistent else -(-q // 1024)


def re1_arms(other, cases):
    """RE1 of another tree (P, other_level_scan) and of this one (C) on the
    same inputs, in turns P, C, C, P: each arm first held to the plain
    version within TOL_RE1 with two runs the same bits, then timed on the
    card alone (device_ms, 20 calls) and by event pair; and the library's
    triangular solve on the same inputs on the card alone. cases: (label,
    args) pairs. Returns the numbers by label."""
    fn_p, calls_p, records_p = other
    arms = {"P": fn_p, "C": random_scan.level_scan_kernel}
    out = {}
    for label, args in cases:
        q = args[4].shape[0]
        ref = random_scan.level_scan_plain(*args)
        outs = {}
        for arm, fn in arms.items():
            o = outs[arm] = fn(*args)
            e, sc = rel_err(o, ref)
            check(torch.isfinite(o).all().item() and e <= TOL_RE1 * sc and torch.equal(o, fn(*args)),
                  f"level_scan {arm} at {label}: max_abs_err {e:.3e} of {sc:.3e}, or two runs differ")
        same = torch.equal(outs["P"], outs["C"])
        print(f"[8 random] level_scan at {label}: P's and C's u {'bit-identical' if same else 'DIFFER'} "
              f"(digests {digest(outs['P'])}, {digest(outs['C'])})")
        rows = []
        for arm in "PCCP":
            fn = arms[arm]
            dev = (device_ms(lambda: fn(*args), 20, records_p(q), calls=calls_p) if arm == "P"
                   else device_ms(lambda: fn(*args), 20))
            ev = median_ms(lambda: fn(*args), 20)
            rows.append(dict(arm=arm, device_ms=dev, event_ms=ev))
        mat, rhs = random_scan.level_scan_system(*args)
        lib_dev = device_ms(lambda: torch.linalg.solve_triangular(
            mat, rhs, upper=False, unitriangular=True), 20, records_per_launch=0)
        del mat, rhs
        print(f"[8 random] level_scan at {label}, arms P, C, C, P on the card alone (event pair): "
              + ", ".join(f"{r['arm']} {r['device_ms']} ({r['event_ms']:.4f})" for r in rows)
              + f" ms; torch.linalg.solve_triangular {lib_dev} ms on the card alone")
        out[label] = dict(arms=rows, library_device_ms=lib_dev, same_bits=same)
    return out


def re1_phase(plan, st, other=None):
    """8.1: RE1 against its plain version on the card at the BayesR+A path's
    shapes (q = 10,000, the dense A^-1 of a 5-generation pedigree), with a
    second sweep's inputs (u from a first level scan), beside the one
    PyTorch call that computes the same function (torch.linalg.solve_triangular
    on the unit lower-triangular system, built outside the timed window,
    held to the plain version too); then at RE1_EDGES on small random
    structures. other: another tree's RE1 (other_level_scan), which re1_arms
    then holds and times beside this tree's at q = 10,000 and 3,001; its
    numbers are returned."""
    rs = st.random[0]
    q = rs.u.shape[0]
    gen = torch.Generator(device=DEV).manual_seed(5)
    var_e = st.ycorr.var()
    ive, ivu = 1.0 / var_e, 1.0 / rs.var_u
    yi = (rs.zp @ st.ycorr) * ive
    z = torch.randn(q, generator=gen, device=DEV)
    u1 = random_scan.level_scan(rs.ivstr, yi, rs.zpz, z, rs.u, ive, ivu)
    z = torch.randn(q, generator=gen, device=DEV)
    args = (rs.ivstr, yi, rs.zpz, z, u1, ive, ivu)

    def kern():
        return random_scan.level_scan_kernel(*args)

    def plain():
        return random_scan.level_scan_plain(*args)

    out, ref = kern(), plain()
    check(torch.equal(out, kern()), "level_scan: two runs differ")
    check(torch.isfinite(out).all().item(), "level_scan: not finite")
    e, sc = rel_err(out, ref)
    mat, rhs = random_scan.level_scan_system(*args)

    def library():
        return torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)[:, 0]

    e_l, _ = rel_err(library(), ref)
    check(e_l <= TOL_RE1 * sc, f"level_scan: torch.linalg.solve_triangular differs by {e_l:.3e}")
    ms_k, ms_p = median_ms(kern, 20), median_ms(plain, 3)
    dev_ms = device_ms(kern, 10)  # a call launches prep and scan once each
    by_kernel(kern, 10, "8 random", "level_scan")
    report("level_scan", e, sc, TOL_RE1, ms_k, ms_p, work_re1(q),
           f" (q = {q:,}, the dense A^-1 of a {GENS}-generation pedigree, a second sweep's inputs, "
           f"2 launches a call; the library call's u max_abs_err {e_l:.3e}, its system built outside "
           "the timed window; not a TPU kernel: the counterpart of the level lax.scan of "
           "sample_random_uni)", phase="8 random", dev_ms=dev_ms, library_ms=median_ms(library, 20),
           library_dev_ms=device_ms(library, 20, records_per_launch=0))
    del mat, rhs
    for qs in RE1_EDGES:
        small = re1_inputs(qs, ive, ivu)
        o, r = random_scan.level_scan_kernel(*small), random_scan.level_scan_plain(*small)
        same = torch.equal(o, random_scan.level_scan_kernel(*small))
        e, sc = rel_err(o, r)
        print(f"[8 random] level_scan at q = {qs:,}: max_abs_err {e:.3e} (scale {sc:.3e}, tol "
              f"{TOL_RE1:g} x scale); two launches {'bit-identical' if same else 'DIFFER'}")
        check(e <= TOL_RE1 * sc and same,
              f"level_scan at q = {qs} disagrees with its plain version or with itself")
    if other is not None:
        return re1_arms(other, [(f"q = {q:,}", args), ("q = 3,001", re1_inputs(3001, ive, ivu))])
    return None


def by_kernel(fn, reps, ph, name, quiet=False):
    """Device ms per call of fn by kernel name, from one profiled window,
    printed unless quiet; returns their sum, or None (not measured) where
    the window came back with no records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
    if not recs:
        print(f"chip_smoke: note: {name}: the profiled window of {reps} calls has no records; not measured")
        return None
    for e in sorted(recs, key=lambda e: -e.self_device_time_total) if not quiet else ():
        print(f"[{ph}] {name} on the card, per call: {e.self_device_time_total / reps / 1e3:.4f} ms in "
              f"{e.count / reps:g} launches of {e.key[:80]}")
    return sum(e.self_device_time_total for e in recs) / reps / 1e3


def random_path(tag, spec, truth, V, truth_name, ebv_limit=None, marker_truth=None):
    """One path with a scan random effect: run_lmem as it runs by default
    (PhiloxStream, eager; launch counts from 0), then a loop of make_sweep
    and run_lmem's replays from one KeyedStream (the same bits), then the
    steady ms/sweep of both arms, the replays' device busy and the idle
    share. Checks drift (y - Xb - Zu - Mc beta), finite draws, varU > 0 in
    every kept draw and, where given, the correlation of the posterior-mean
    u with the planted values over the first 2,048 individuals (and of the
    marker EBV with marker_truth, printed)."""
    ph = f"8 {tag}"
    _cuda.reset_launches()
    res = ngt.run_lmem(spec, n_chain=N_CHAIN_RE, n_burn=N_BURN_RE, n_thin=N_THIN_RE, out_folder=None,
                       seed=7, vshards=V)
    launches = dict(_cuda.LAUNCHES)
    plan, st = res.plan, res.state
    name = plan.random[0].name
    expect = {k: 0 for k in launches}
    expect["level_scan"] = N_CHAIN_RE
    if plan.markers:
        T = plan.markers[0].n_blocks // plan.markers[0].vshards
        expect.update(pack2_matvec=N_CHAIN_RE * T, pack2_rank_update=N_CHAIN_RE * T,
                      r_block_scan_v=N_CHAIN_RE * T)
    check(launches == expect, f"{tag}: launches {launches}, expected {expect}")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad, f"{tag}: kept draws of {bad} are not finite")
    var_u = res.draws[f"varU{name}"]
    check((var_u > 0).all(), f"{tag}: varU not > 0")
    drift = residual_drift(plan, st)
    u_mean = torch.from_numpy(res.posterior_mean(f"u{name}")).to(DEV)
    c = corr(u_mean[:2048], truth[:2048])
    print(f"[{ph}] run_lmem (PhiloxStream, eager) {N_CHAIN_RE} sweeps: {res.sweeps_per_sec:.2f} sweeps/s "
          f"(host clock); launches {({k: v for k, v in launches.items() if v})}; drift {drift:.3e} of "
          f"max|y| (limit 1e-2); varU mean {var_u.mean():.4f}; corr(posterior-mean u, {truth_name}) "
          f"over 2,048 individuals {c:.4f} ({'printed only' if ebv_limit is None else f'limit {ebv_limit}'})"
          f"; varE {st.e.var_e.item():.4f}")
    check(drift < 1e-2, f"{tag}: ycorr drifted from y - Xb - Zu - Mc beta")
    check(ebv_limit is None or c >= ebv_limit, f"{tag}: EBV correlation {c:.4f} below {ebv_limit}")
    if plan.markers:
        gv = ngt.genomic_values_state(plan, st, beta=res.posterior_mean("betaM1"))
        print(f"[{ph}] marker EBV corr with the planted marker signal over 2,048 individuals "
              f"{corr(gv[:2048], marker_truth[:2048]):.4f} (printed only)")
    del res, st

    plan, st0 = ngt.assemble(spec, vshards=V)
    stream = keyed.KeyedStream(7, DEV, plan.dtype)
    sweep = ngt.make_sweep(plan)
    n_keep = (N_CHAIN_RE - N_BURN_RE) // N_THIN_RE
    _cuda.reset_launches()
    st = st0
    kept = []
    t0 = time.perf_counter()
    for i in range(1, N_CHAIN_RE + 1):
        st = sweep(st, stream)
        if i > N_BURN_RE and (i - N_BURN_RE) % N_THIN_RE == 0:
            kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    keyed_launches = dict(_cuda.LAUNCHES)
    check(keyed_launches["level_scan"] == N_CHAIN_RE, f"{tag}: keyed eager launches {keyed_launches}")
    eager = {k: torch.stack([x[k] for x in kept]) for k in kept[0]}
    check(len(kept) == n_keep, f"{tag}: kept {len(kept)}")
    rres = ngt.run_lmem(spec, n_chain=N_CHAIN_RE, n_burn=N_BURN_RE, n_thin=N_THIN_RE, out_folder=None,
                        vshards=V,
                        stream=stream)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), rres.draws[k])]
    check(set(rres.draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(rres.state.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    check(residual_drift(rres.plan, rres.state) < 1e-2, f"{tag}: replayed ycorr drifted")
    rep = engine_sweep.ReplayedSweep(plan, rres.state, stream)
    state = [rres.state]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, 20)
    ms_replay = steady_ms(lambda: rep.run(1), 20)
    busy, per_sweep, missed, by_name, _ = replay_window(rep, 10)
    idle = 1.0 - busy / ms_replay
    print(f"[{ph}] KeyedStream: kept draws and final ycorr bit-identical eager and replayed; eager "
          f"{N_CHAIN_RE / eager_s:.2f} sweeps/s, replayed run_lmem {rres.sweeps_per_sec:.2f} sweeps/s "
          f"(host clock); steady, 20 sweeps between CUDA events: eager {ms_eager:.4f} ms/sweep, "
          f"replayed {ms_replay:.4f} ms/sweep; 10 replays under the profiler: device busy {busy:.4f} "
          f"ms/sweep, {per_sweep} kernels and copies per sweep ({missed} records missed); idle share "
          f"without the profiler {idle:.4f}")
    for key, cnt in sorted(by_name.items(), key=lambda r: -r[1])[:5]:
        print(f"  replayed x{cnt:<4} {key[:90]}")
    del rep, state, rres
    return launches, keyed_launches, dict(eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay,
                                          replay_busy_ms_per_sweep=busy, idle_share=idle, drift=drift,
                                          corr_u=c, kernels_per_sweep=per_sweep)


def cg_work(rp, iters, dtype):
    """(bytes, operations) of a CG solve of `iters` iterations over rp's
    live entries of K: diag.cg_work, the count diag.roofline makes too."""
    return diag.cg_work(int(rp.iv_len.sum()), rp.q, dtype, iters)


def parent_cg_solve(rp, rs, ive, ivu, b, x0):
    """The parent tree's eager solve of the same system: the generic cg_solve
    (its stopping rule read on the host each iteration) on the long-form
    matvec sample_random_cg used before CG1: Z' (Z v) by a gather and a
    padded sum over each level's records, K v over every padded slot."""
    idx = torch.where(rs.z_idx >= 0, rs.z_idx, rp.q)

    def matvec(v):
        zv = torch.index_select(torch.cat([v, v.new_zeros(1)]), 0, idx)
        kv = torch.sum(rs.iv_val * torch.index_select(v, 0, rs.iv_idx.reshape(-1)).view(
            rs.iv_idx.shape), dim=1)
        return random_effects._padded_sum(zv, rp.z_rows) * ive + kv * ivu

    return cg.cg_solve(matvec, b, x0=x0, tol=rp.cg_tol, max_iter=rp.cg_iters)


def second_sweep_solve(plan, st, stream):
    """The arguments of the CG solve of the second sweep from st (the
    sampler's cg_solve_sparse wrapped for two eager sweeps), and the state
    after it."""
    calls, orig = [], random_effects.cg_solve_sparse

    def record(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    random_effects.cg_solve_sparse = record
    try:
        sweep = ngt.make_sweep(plan)
        st = sweep(sweep(st, stream), stream)
    finally:
        random_effects.cg_solve_sparse = orig
    return calls[-1], st


def cg1_check(plan, st, ph, name, other=None, ablations=None):
    """8.4a CG1 against its plain version at a second sweep's inputs: the
    same iteration count (stopped by the tolerance), x within TOL_CG of its
    scale, two launches the same bits; solved to CG_TIGHT, the same count
    and x within TOL_CG_TIGHT; its time (event pairs; the card alone) beside
    the plain version's and the parent's eager solve of the same system (ms
    an iteration). other: another tree's CG1 (cg_lib_solver), timed beside
    this tree's by cg_arms; ablations: {label: cg_lib_solver} of the
    ablation builds, timed by cg_ablations."""
    (args, kw), st2 = second_sweep_solve(plan, st, keyed.KeyedStream(3, DEV, plan.dtype))
    rp, rs = plan.random[0], st.random[0]
    layout = kw.pop("layout")
    check(layout is rp.cg_layout, f"{name}: the sweep's solve was not given the plan's layout")

    def kern():
        return cg.cg_solve_sparse_kernel(*args, **kw, layout=layout)

    x, it, res = kern()
    x2, it2, res2 = kern()
    check(torch.equal(x, x2) and torch.equal(it, it2) and torch.equal(res, res2),
          f"{name}: two launches differ")
    px, pit, _ = cg.cg_solve_sparse_plain(*args, **kw)
    iters = int(it)
    check(iters == int(pit), f"{name}: {iters} iterations, the plain version {int(pit)}")
    check(0 < iters < rp.cg_iters, f"{name}: ran to its cap ({iters})")
    err, scale = rel_err(x, px)
    tight = dict(kw, tol=CG_TIGHT)
    tx, tit, _ = cg.cg_solve_sparse_kernel(*args, **tight, layout=layout)
    tpx, tpit, _ = cg.cg_solve_sparse_plain(*args, **tight)
    terr, tscale = rel_err(tx, tpx)
    print(f"[{ph}] {name} solved to {CG_TIGHT:g}: {int(tit)} iterations (plain {int(tpit)}), x within "
          f"{terr:.3e} of the plain version's (scale {tscale:.3e}, tol {TOL_CG_TIGHT:g} x scale)")
    check(int(tit) == int(tpit) and terr <= TOL_CG_TIGHT * tscale,
          f"{name}: solved to {CG_TIGHT:g}, disagrees with its plain version")
    ive = 1.0 / st2.e.var_e

    def parent():
        return parent_cg_solve(rp, rs, ive, args[4], args[5], args[6])

    ox, oit, _ = parent()
    ms_k, dev = median_ms(kern, 20), device_ms(kern, cg_reps(rp.q))  # None: windows lost records
    ms_p, ms_o = median_ms(lambda: cg.cg_solve_sparse_plain(*args, **kw), 3), median_ms(parent, 3)
    nnz = int(rp.iv_len.sum())
    on_card = "not measured" if dev is None else f"{dev / iters:.5f}"
    f64, grid = int(plan.dtype == torch.float64), layout[0].numel() + 1
    scratch = [_cuda.lib().ngt_cg_solve_scratch_bytes(f64, rp.q, slots, grid) / 2**20
               for slots in (layout[2], rp.q * rs.iv_idx.shape[1] // cg.CHUNK + grid)]
    report(name, err, scale, TOL_CG, ms_k, ms_p, cg_work(rp, iters, plan.dtype),
           note=f" (q = {rp.q:,}, {nnz:,} live A^-1 entries of {rs.iv_idx.numel():,} padded, "
                f"{plan.dtype}, a second sweep's system; {iters} iterations at tol {rp.cg_tol:g}: "
                f"{ms_k / iters:.5f} ms an iteration, on the card alone {on_card}; plain "
                f"{ms_p / iters:.5f} ms an iteration; the parent's eager solve (cg_solve on the "
                f"long-form matvec) {ms_o:.4f} ms, {oit} iterations, {ms_o / oit:.5f} ms an "
                f"iteration, x within {rel_err(ox, x)[0]:.2e} of CG1's; scratch {scratch[0]:.2f} MiB "
                f"for the plan's {layout[2]:,} chunk slots ({scratch[1]:.2f} MiB sized by the padded "
                f"width); no single PyTorch call solves a sparse SPD system by CG)", phase=ph, dev_ms=dev)
    TIMINGS[name].update(iterations=iters, parent_eager_ms=ms_o, parent_eager_iterations=oit,
                         parent_eager_ms_per_iteration=ms_o / oit, scratch_mib=scratch[0],
                         scratch_mib_padded_width=scratch[1])
    if ablations:
        TIMINGS[name]["ablations"] = cg_ablations(ablations, args, layout, iters, ph, name)
    if other is not None:
        TIMINGS[name]["arms"] = cg_arms(other, args, kw, layout, iters, ph, name)
    return TIMINGS[name]


# CG1's ablation builds: scratch copies of this tree's csrc/cg_solve.cu (start_build's
# patches), each running exactly max_iter iterations (no stopping rule) with one part
# taken out: the matvec's walk over the chunks (a row's K p sum read as 0), the grid
# barriers (a block barrier left), the totals of the partials (each 1)
_CG_NO_RULE = ("while (root(rz) > limit && it < a.max_iter)", "while (it < a.max_iter)")
CG_ABLATIONS = (
    ("whole", (_CG_NO_RULE,)),
    ("no matvec", (_CG_NO_RULE,
                   ("    walk(ch, E, NC, a.ap + R0, [&](long long j) { return p_of(__ldcg(prv + j)); });\n",
                    ""),
                   ("Row{a.ap[i], __ldcs", "Row{T(0), __ldcs"))),
    ("no grid barriers", (_CG_NO_RULE,
                          ("void grid_barrier(unsigned long long* bar, unsigned long long target) {\n"
                           "  __syncthreads();\n",
                           "void grid_barrier(unsigned long long* bar, unsigned long long target) {\n"
                           "  __syncthreads();\n  return;\n"))),
    ("no totals", (_CG_NO_RULE,
                   ("__device__ __forceinline__ T grid_total(const T* part, int slot, T* red) {\n",
                    "__device__ __forceinline__ T grid_total(const T* part, int slot, T* red) {\n"
                    "  return T(1);\n"))),
)


def cg_lib_solver(lib, label):
    """(solve, calls) for another build of CG1 (an ablation build, or another
    tree's csrc/cg_solve.cu) with this tree's C interface: solve(args, tol,
    max_iter, layout=None) -> (x, iterations, ||r||) on cg_solve_sparse's
    args, through this tree's launcher; calls() counts the solves made. A
    build without that interface (ngt_cg_solve_scratch_bytes: CG1 before
    its row-owned design) is refused."""
    check(hasattr(lib, "ngt_cg_solve_scratch_bytes"),
          f"{label}: its CG1 lacks this tree's C interface (ngt_cg_solve_scratch_bytes)")
    _cuda.bind_cg(lib)
    calls = [0]

    def solve(args, tol, max_iter, layout=None):
        calls[0] += 1
        return cg.solve_with(lib, *args, tol=tol, max_iter=max_iter, layout=layout)
    return solve, lambda: calls[0]


def cg_reps(q):
    """Solves a profiler window of CG1 holds: at 1,000,000 rows a window of
    10 kept 8 of each kernel's records (H100)."""
    return 10 if q < 500_000 else 4


def cg_ms(fn, q, calls=None):
    """ms of one call of fn (a CG1 solve) on the card alone (device_ms), or,
    where the profiler keeps no whole window (solves of tens of ms often),
    the median of event pairs around single calls, whose host share is
    microseconds; and which of the two it is."""
    dev = device_ms(fn, cg_reps(q), calls=calls)
    return (dev, "card alone") if dev is not None else (median_ms(fn, cg_reps(q)), "event pair")


def cg_ablations(libs, args, layout, iters, ph, name):
    """Step 1 of a CG1 redesign: each ablation build (CG_ABLATIONS) on the
    same system and layout for exactly `iters` iterations, on the card
    alone, and the split it gives: matvec, grid barriers and totals, each
    the whole build's time less the build without it, an iteration."""
    ms, how = {}, {}
    for label, (solve, calls) in libs.items():
        t, how[label] = cg_ms(lambda: solve(args, 0.0, iters, layout), args[5].shape[0], calls)
        ms[label] = t / iters
    whole = ms["whole"]
    split = {label: whole - v for label, v in ms.items() if label != "whole"}
    print(f"[{ph}] {name} ablations, {iters} iterations each, ms an iteration: "
          + ", ".join(f"{k} {v:.6f} ({how[k]})" for k, v in ms.items()) + "; the part each takes out: "
          + ", ".join(f"{k[3:]} {v:.6f}" for k, v in split.items()))
    return dict(ms_per_iteration=ms, split_ms_per_iteration=split, timed_by=how)


def cg_arms(other, args, kw, layout, iters, ph, name):
    """Another tree's CG1 (P, cg_lib_solver) beside this tree's (C) on the
    same system and layout: P held to the plain version (the same
    iterations, x within TOL_CG of scale), then both timed (cg_ms) in turns
    P, C, C, P, ms an iteration."""
    solve_p, calls_p = other
    px, pit, _ = cg.cg_solve_sparse_plain(*args, **kw)
    x, it, _ = solve_p(args, **kw, layout=layout)
    e, sc = rel_err(x, px)
    check(int(it) == int(pit) == iters and e <= TOL_CG * sc,
          f"{name}: the other tree's CG1 {int(it)} iterations (plain {int(pit)}), x within {e:.3e}")
    rows = []
    for arm in "PCCP":
        if arm == "P":
            t, how = cg_ms(lambda: solve_p(args, **kw, layout=layout), args[5].shape[0], calls_p)
        else:
            t, how = cg_ms(lambda: cg.cg_solve_sparse_kernel(*args, **kw, layout=layout), args[5].shape[0])
        rows.append(dict(arm=arm, ms=t, timed_by=how, ms_per_iteration=t / iters))
    print(f"[{ph}] {name} arms P, C, C, P, ms an iteration ({iters} iterations): "
          + ", ".join(f"{r['arm']} {r['ms_per_iteration']:.6f} ({r['timed_by']})" for r in rows))
    return rows


def cg_chains(spec, ph, tag):
    """8.4b A-cg in float64: run_lmem as it runs by default (PhiloxStream,
    eager; launch counts from 0), then a loop of make_sweep and run_lmem's
    replays from one KeyedStream (kept draws and final ycorr the same bits)
    and a ReplayedSweep from the same start, one replay at a time (each
    sweep's CG iterations those of the eager sweep); every sweep stopped by
    its tolerance, drift, finite draws, varU > 0; steady ms/sweep of both
    arms, device busy and idle share of the replays."""
    _cuda.reset_launches()
    res = ngt.run_lmem(spec, n_chain=N_CG_CHAIN, n_burn=N_CG_BURN, n_thin=N_CG_THIN, out_folder=None, seed=7,
                       dtype=torch.float64)
    launches = dict(_cuda.LAUNCHES)
    expect = {k: 0 for k in launches}
    expect["cg_solve"] = N_CG_CHAIN
    check(launches == expect, f"{tag}: launches {launches}, expected {expect}")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad and (res.draws["varUA"] > 0).all(), f"{tag}: draws of {bad} not finite, or varU <= 0")
    drift = residual_drift(res.plan, res.state)
    check(drift < 1e-2, f"{tag}: ycorr drifted from y - Xb - Zu")
    print(f"[{ph}] run_lmem (PhiloxStream, eager) {N_CG_CHAIN} sweeps: {res.sweeps_per_sec:.2f} "
          f"sweeps/s (host clock); launches {({k: v for k, v in launches.items() if v})}; drift "
          f"{drift:.3e} of max|y|; varU mean {res.draws['varUA'].mean():.4f}")
    del res

    plan, st0 = ngt.assemble(spec, dtype=torch.float64)
    rp = plan.random[0]
    stream = keyed.KeyedStream(7, DEV, torch.float64)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    st, kept, iters = st0, [], []
    for i in range(1, N_CG_CHAIN + 1):
        st = sweep(st, stream)
        iters.append(sweep.cg_iterations[0])
        if i > N_CG_BURN and (i - N_CG_BURN) % N_CG_THIN == 0:
            kept.append(ngt.collect_sample(st, plan))
    keyed_launches = dict(_cuda.LAUNCHES)
    iters = [int(t) for t in iters]
    check(keyed_launches["cg_solve"] == N_CG_CHAIN, f"{tag}: keyed eager launches {keyed_launches}")
    check(0 < min(iters) and max(iters) < rp.cg_iters, f"{tag}: a sweep's CG ran to its cap ({iters})")
    eager = {k: torch.stack([x[k] for x in kept]) for k in kept[0]}
    rres = ngt.run_lmem(spec, n_chain=N_CG_CHAIN, n_burn=N_CG_BURN, n_thin=N_CG_THIN, out_folder=None,
                        dtype=torch.float64, stream=stream)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), rres.draws[k])]
    check(set(rres.draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(rres.state.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    check(residual_drift(rres.plan, rres.state) < 1e-2, f"{tag}: replayed ycorr drifted")
    check(all(torch.isfinite(v).all().item() for v in eager.values()) and (eager["varUA"] > 0).all().item(),
          f"{tag}: KeyedStream draws not finite or varU <= 0")
    rep = engine_sweep.ReplayedSweep(plan, st0, stream)
    rep_iters = []
    for _ in range(N_CG_CHAIN):
        rep.run(1)
        rep_iters.append(rep.cg_iterations[0].clone())
    check([int(t) for t in rep_iters] == iters, f"{tag}: replayed iterations {rep_iters}, eager {iters}")
    check(torch.equal(rep.static.ycorr, st.ycorr), f"{tag}: ReplayedSweep's ycorr differs from eager")
    state = [st]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, 20)
    ms_replay = steady_ms(lambda: rep.run(1), 20)
    busy, per_sweep, missed, by_name, ms_by = replay_window(rep, 10)
    idle = 1.0 - busy / ms_replay
    cg1 = sum(v for k, v in ms_by.items() if "cg_kernel" in k)
    mean_it = statistics.mean(iters)
    print(f"[{ph}] KeyedStream, float64: kept draws and final ycorr bit-identical eager and replayed, "
          f"every replay's CG iterations the eager sweep's {iters} (cap {rp.cg_iters}, tol "
          f"{rp.cg_tol:g}); replayed run_lmem {rres.sweeps_per_sec:.2f} sweeps/s (host clock); steady, "
          f"20 sweeps between CUDA events: eager {ms_eager:.4f} ms/sweep, replayed {ms_replay:.4f} "
          f"ms/sweep ({ms_replay / mean_it:.5f} ms an iteration at their mean {mean_it:.1f}); 10 "
          f"replays under the profiler: device busy {busy:.4f} ms/sweep, CG1 {cg1:.4f} of it, "
          f"{per_sweep} kernels and copies per sweep ({missed} records missed); idle share without "
          f"the profiler {idle:.4f}")
    for key, cnt in sorted(by_name.items(), key=lambda r: -ms_by[r[0]])[:5]:
        print(f"  replayed x{cnt:<4} {ms_by[key]:.4f} ms {key[:80]}")
    out = dict(iterations=iters, eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay,
               replay_busy_ms_per_sweep=busy, cg1_ms_per_sweep=cg1, idle_share=idle,
               kernels_per_sweep=per_sweep, drift=drift)
    del rep, state, rres
    return out, launches, keyed_launches


def acg_spec(gen_size):
    """A-cg's model at gen_size animals a generation: intercept + an animal
    effect by perturbed CG over a 5-generation pedigree (at most 50
    offspring per sire), records on the last 3 generations. Returns the
    spec, the planted values and the printed phase tag."""
    ph = "8 A-cg" if gen_size == CG_GEN_SIZE else f"8 A-cg {GENS * gen_size:,}"
    t0 = time.perf_counter()
    ped, u_true = simulate_pedigree(GENS, gen_size, seed=12)
    idx, val = pedigree.a_inverse_padded(ped)
    sire, dam, dsq = pedigree.a_inverse_factor(ped)
    first = (GENS - CG_RECORDED_GENS) * gen_size
    animal = np.arange(first, ped.n)
    rng = np.random.default_rng(13)
    y = 1.0 + u_true[animal] + rng.normal(size=animal.size)
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(animal.size))], random=[
        ngt.RandomTerm("A", None, prior=ngt.Random("A", VAR_A, sampler="cg"), z_idx=animal,
                       n_levels=ped.n, sparse_struct=dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam,
                                                          dinv_sqrt=dsq))])
    print(f"[{ph}] pedigree of {ped.n:,} animals ({GENS} generations of {gen_size:,}, max F "
          f"{ped.inbreeding.max():.4f}), padded A^-1 width {idx.shape[1]}, {int((val != 0).sum()):,} "
          f"nonzeros, {animal.size:,} records; built in {time.perf_counter() - t0:.2f} s")
    return spec, u_true, ph


def acg_replay_arms(spec, other, ph):
    """A-cg's replayed sweep (float64, KeyedStream) with another tree's CG1
    (P; sample_random_cg's solve swapped for it while the sweep is captured)
    and this tree's (C) in turns P, C, C, P: steady ms/sweep (CUDA events
    around 20 replays), device busy and CG1's share of it (10 profiled
    replays), idle share."""
    solve_p, _ = other
    plan, st0 = ngt.assemble(spec, dtype=torch.float64)
    stream = keyed.KeyedStream(7, DEV, torch.float64)
    orig = random_effects.cg_solve_sparse

    def p_solve(*args, tol, max_iter, layout):
        return solve_p(args, tol, max_iter, layout)

    rows = []
    for arm in "PCCP":
        random_effects.cg_solve_sparse = p_solve if arm == "P" else orig
        try:
            rep = engine_sweep.ReplayedSweep(plan, st0, stream)
        finally:
            random_effects.cg_solve_sparse = orig
        ms = steady_ms(lambda: rep.run(1), 20)
        busy, per_sweep, _, _, ms_by = replay_window(rep, 10)
        cg1 = sum(v for k, v in ms_by.items() if "cg_kernel" in k)
        rows.append(dict(arm=arm, replay_ms_per_sweep=ms, busy_ms=busy, cg1_ms=cg1,
                         idle_share=1.0 - busy / ms, nodes=per_sweep))
        del rep
    print(f"[{ph}] replayed A-cg, arms P, C, C, P: " + "; ".join(
        f"{r['arm']} {r['replay_ms_per_sweep']:.4f} ms/sweep (busy {r['busy_ms']:.4f}, CG1 "
        f"{r['cg1_ms']:.4f}, idle share {r['idle_share']:.4f}, {r['nodes']} nodes)" for r in rows))
    return rows


def cg_phase(gen_size=CG_GEN_SIZE, name="cg_solve", other=None, ablations=None):
    """8.4 A-cg (acg_spec): CG1 against its plain version and the parent's
    eager solve (8.4a; and against another tree's CG1 and the ablation
    builds where given), the float64 chains eager and replayed (8.4b; with
    another tree's CG1 also the replayed sweep in turns), then 5 eager
    sweeps in float32 (whose epsilon is above the default tolerance of
    1e-8: the iterations are printed, as a finding). Returns the numbers
    and the launch counts by run."""
    spec, u_true, ph = acg_spec(gen_size)
    plan, st = ngt.assemble(spec, dtype=torch.float64)
    out = {"CG1": cg1_check(plan, st, ph, name, other, ablations)}
    del plan, st
    out["float64"], launches, keyed_launches = cg_chains(spec, ph, f"A-cg {gen_size}")
    if other is not None:
        out["replay arms"] = acg_replay_arms(spec, other, ph)
    plan, st = ngt.assemble(spec, dtype=torch.float32)
    rp = plan.random[0]
    sweep, stream = ngt.make_sweep(plan), PhiloxStream(7, DEV, torch.float32)
    iters = []
    for _ in range(N_CG_F32):
        st = sweep(st, stream)
        iters.append(int(sweep.cg_iterations[0]))
        check(torch.isfinite(st.random[0].u).all().item() and st.random[0].var_u.item() > 0,
              "A-cg float32: u not finite or varU not > 0")
    drift = residual_drift(plan, st)
    c = corr(st.random[0].u, torch.from_numpy(u_true).to(DEV))
    print(f"[{ph}] float32: {N_CG_F32} sweeps, CG iterations per sweep {iters} (cap {rp.cg_iters}, tol "
          f"{rp.cg_tol:g}); drift {drift:.3e} of max|y|; varU {st.random[0].var_u.item():.4f}; "
          f"corr(last u, planted) over all animals {c:.4f}")
    check(drift < 1e-2, "A-cg float32: ycorr drifted from y - Xb - Zu")
    out["float32"] = dict(iterations=iters, drift=drift, corr_u=c)
    return out, {"A-cg": launches, "A-cg keyed": keyed_launches}


def random_phase(spec_for, sig, other=None):
    """8: RE1 against its plain version (8.1; and against another tree's,
    other, where given), BayesR+A (8.2) and GBLUP (8.3) at 10,000 x 49,152,
    A-cg on 100,000 animals (8.4). Returns the numbers and the launch counts
    by run."""
    spec = spec_for("BayesR")
    y, md = spec.y, spec.markers[0].data
    t0 = time.perf_counter()
    ped, u_true, ainv = phase8_pedigree()
    check(ped.n == N, "one animal per individual of the panel")
    print(f"[8 random] pedigree of {ped.n:,} animals ({GENS} generations of {GEN_SIZE_A:,}, max F "
          f"{ped.inbreeding.max():.4f}), dense A^-1 in {time.perf_counter() - t0:.2f} s")
    u_dev = torch.from_numpy(u_true).to(DEV)
    eye = np.eye(N)
    spec_a = ngt.ModelSpec(y=y + u_true, fixed=spec.fixed, markers=spec.markers, block_size=BLOCK,
                           random=[ngt.RandomTerm("A", eye, prior=ngt.Random("A", VAR_A), ivstr=ainv)])
    plan, st = ngt.assemble(spec_a, vshards=V_MAIN)
    arms = re1_phase(plan, st, other)
    del plan, st
    counted, out = {}, {} if arms is None else {"RE1 arms": arms}
    counted["BayesR+A"], counted["BayesR+A keyed"], out["BayesR+A"] = random_path(
        "BayesR+A", spec_a, u_dev, V_MAIN, "planted polygenic u", marker_truth=sig)
    del spec_a
    t0 = time.perf_counter()
    dos = pack2.unpack2(torch.as_tensor(md.genotypes, device=DEV), torch.float64)[:, :N].T
    ginv = ngt.make_g_inverse(dos)
    del dos
    torch.cuda.synchronize()
    print(f"[8 GBLUP] G^-1 of the {N:,} x {P:,} panel (make_g_inverse, float64 on the card) in "
          f"{time.perf_counter() - t0:.2f} s")
    spec_g = ngt.ModelSpec(y=y, fixed=spec.fixed, random=[
        ngt.RandomTerm("G", eye, prior=ngt.Random("G", VAR_A), ivstr=ginv.float())])
    del ginv
    counted["GBLUP"], counted["GBLUP keyed"], out["GBLUP"] = random_path(
        "GBLUP", spec_g, sig, 1, "the planted genetic value", GBLUP_EBV_LIMIT)
    del spec_g
    out["A-cg"], by_run = cg_phase()
    counted.update(by_run)
    return out, counted


def random_only(spec_for, sig, card, other_src=None):
    """`python3 chip_smoke.py random [DIR]`: phase 8 alone, the quick form
    for work on the random effects; with DIR, RE1 also against DIR's
    (another tree's csrc/). One JSON line of its numbers, and no result
    line."""
    other = None if other_src is None else other_level_scan(other_src)
    out, counted = random_phase(spec_for, sig, other)
    print(json.dumps({"card": card, "random": out, "launches": counted,
                      "level_scan": TIMINGS.get("level_scan"), "cg_solve": TIMINGS.get("cg_solve")}))


def cg_only(card, other_src=None):
    """`python3 chip_smoke.py cg [DIR]`: phase 8.4 at 100,000 animals and at
    1,000,000 (5 generations of 200,000; minutes of host build), CG1 timed
    as cg_solve and cg_solve_1m, each beside its ablation builds
    (CG_ABLATIONS); with DIR (another tree's csrc/), DIR's CG1 also held to
    the plain version and timed beside this tree's in turns P, C, C, P, on
    its own and in the replayed sweep. One JSON line of its numbers, and no
    result line."""
    builds = [start_build(_cuda.CSRC, "cg_ablate", ["cg_solve.cu"], patches, label)
              for label, patches in CG_ABLATIONS]
    if other_src is not None:
        builds.append(start_build(other_src, "cg_other", ["cg_solve.cu"]))
    libs = {label: cg_lib_solver(finish_build(label, so, proc, "cg_kernel"), label)
            for label, so, proc in builds}
    other = None if other_src is None else libs.pop(builds[-1][0])
    out, counted = {}, {}
    for gen_size, name in ((CG_GEN_SIZE, "cg_solve"), (CG_GEN_SIZE_1M, "cg_solve_1m")):
        key = f"A-cg {GENS * gen_size:,}"
        out[key], by_run = cg_phase(gen_size, name, other, libs)
        counted.update({f"{k} {GENS * gen_size:,}": v for k, v in by_run.items()})
    print(json.dumps({"card": card, "cg": out, "launches": counted}))

# ------------------------------------------------------------------ phase 9

N_CHAIN_CM, N_BURN_CM, N_THIN_CM = 100, 50, 5
REGION_CM = 100  # loci per BayesPR region of the correlated sets: 492 regions
V_CM = 0.01 * np.array([[1.0, 0.5], [0.5, 1.0]])  # the correlated sets' prior (co)variance
V_A2 = np.array([[1.0, 0.5], [0.5, 1.0]])  # the (intercept, slope) group's prior covariance
TOL_CORR = 1e-4  # RE2 and CM1 against their plain versions, of the output's scale
RE2_NTS = (1, 2, 3)


def simulate_corr(n=N, p=P, chunk=8192):
    """Two n x p panels of uniform {0, 1, 2} dosages on the card, the same
    500 expected causal loci in both with N(0, 0.1^2) effects correlated 0.5
    between the sets, N(0, 1) noise. Returns the spec (intercept and one
    correlated pair under BayesPR, regions of REGION_CM loci on one
    chromosome) and the planted signal."""
    g = torch.Generator(device=DEV).manual_seed(21)
    genos = [torch.randint(0, 3, (n, p), generator=g, device=DEV, dtype=torch.int8) for _ in range(2)]
    causal = torch.rand(p, generator=g, device=DEV) < 500.0 / p
    e1, e2 = (torch.randn(p, generator=g, device=DEV) for _ in range(2))
    bts = [torch.where(causal, e1 * 0.1, 0.0),
           torch.where(causal, (0.5 * e1 + 0.75 ** 0.5 * e2) * 0.1, 0.0)]
    sig = sum(torch.cat([gt[i:i + chunk].float() @ bt for i in range(0, n, chunk)])
              for gt, bt in zip(genos, bts))
    sig = sig - sig.mean()
    y = (sig + torch.randn(n, generator=g, device=DEV)).double().cpu().numpy()
    chr_ids = np.ones(p, np.int64)
    datas = tuple(ngt.MarkerData(genotypes=gt, center=gt.double().mean(0), snp_ids=[f"M{i}" for i in range(p)],
                                 chr_ids=chr_ids) for gt in genos)
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], block_size=BLOCK,
                         corr_markers=[ngt.CorrMarkerTerm(("M1", "M2"), datas,
                                                          ngt.BayesPR(REGION_CM, V_CM))])
    return spec, sig


def corr_values(plan, st):
    """sum_t Mc_t beta_t of every correlated marker set, by K2 over its
    packed (locus, set) rows (the check's own launches), or as a product
    over int8 or float rows."""
    out = torch.zeros_like(st.ycorr)
    for cs, cp in zip(st.corr_markers, plan.corr_markers):
        T, V, B, n_t, q = cs.mt.shape
        u = cs.beta.view(V, T, B, n_t).transpose(0, 1).reshape(-1).contiguous()
        if cs.mt.dtype == torch.uint8:
            dy = pack2.rank_update(cs.mt.view(-1, q), u).reshape(-1)[: plan.n]
        else:
            with full_f32():
                dy = u @ cs.mt.view(-1, q).to(u.dtype)
        out = out + dy - (u * cs.center.reshape(-1)).sum()
    return out


def corr_drift(plan, st):
    """max |ycorr - (y - Xb - Zu - Mc beta - sum_t Mc_t beta_t)| / max |y|."""
    fit = sum(fs.x @ fs.b for fs in st.fixed)
    for rs, rp in zip(st.random, plan.random):
        fit = fit + (torch.einsum("tnl,tl->n", rs.zs, rs.u) if rp.correlated else rs.z @ rs.u)
    if plan.markers:
        fit = fit + ngt.genomic_values_state(plan, st)
    fit = fit + corr_values(plan, st)
    return ((st.ycorr - (st.y - fit)).abs().max() / st.y.abs().max()).item()


def work_re2(q, n_t, itemsize=4):
    """(bytes, operations) of one correlated level scan: A's lower triangle
    and the per-level rule (nT + nT^2 elements), yi, z, the old u read, the
    new u written, each element `itemsize` bytes; nT multiply-adds per
    element of the triangle, 2 nT^2 per level."""
    return (itemsize * q * (q + 1) // 2 + itemsize * q * (n_t + n_t * n_t + 4 * n_t),
            q * (q + 1) * n_t + 2 * q * n_t * n_t)


def work_cm1(V, B, n_t, itemsize=4):
    """(bytes, operations) of one CM1 step: the Grams' lower triangles (with
    the diagonal blocks, which the chain reads), the packed rows and the two
    outputs, in elements of itemsize bytes; 2 nT^2 operations per Gram
    block and 2 nT^2 per locus."""
    blocks = V * B * (B + 1) // 2
    return itemsize * (blocks * n_t * n_t + V * B * (3 * n_t + n_t * n_t) + 2 * V * B * n_t), \
        2 * n_t * n_t * (blocks + V * B)


def re2_inputs(q, n_t, ivstr=None, seed=0):
    """RE2's inputs at q: the structure given (or RE1's random one), random
    per-level cross-products, yi, z, an old u, varE and iVarU."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    if ivstr is None:
        ivstr = re1_inputs(q, None, None)[0]
    x = torch.randn(q, 3, n_t, generator=g, device=DEV)
    zpz = (torch.einsum("lkt,lku->ltu", x, x) + 0.1 * torch.eye(n_t, device=DEV)).contiguous()
    yi, u = (torch.randn(n_t, q, generator=g, device=DEV) for _ in range(2))
    z = torch.randn(q, n_t, generator=g, device=DEV)
    m = torch.randn(n_t, n_t, generator=g, device=DEV)
    ivu = torch.linalg.inv(m @ m.T / n_t + torch.eye(n_t, device=DEV))
    return ivstr, yi, zpz, z, u, torch.tensor(1.7, device=DEV), ivu


def other_corr_level_scan(src):
    """(scan, calls): another tree's RE2, built alone from its csrc/
    directory src with this tree's nvcc flags; scan takes
    corr_level_scan_kernel's arguments, through this tree's launcher. A
    tree whose RE2 lacks this tree's C interface (the rule built on the
    card, ngt_corr_level_scan_takes_rule: RE2 before its rule moved onto
    the card) is refused."""
    label, so, proc = start_build(src, "re2_other", ["level_scan.cu"])
    lib = finish_build(label, so, proc, "coop_scan_kernel")
    check(hasattr(lib, "ngt_corr_level_scan_takes_rule"),
          f"{label}: its RE2 lacks this tree's C interface (ngt_corr_level_scan_takes_rule)")
    _cuda.bind_re2(lib)
    calls = [0]

    def scan(*args):
        calls[0] += 1
        return random_scan.corr_level_scan_with(lib, *args)
    return scan, lambda: calls[0]


def re2_arms(other, args, n_t):
    """Another tree's RE2 (P, other_corr_level_scan) and this tree's (C) on
    the same inputs: P held to the plain version within TOL_CORR with two
    runs the same bits, then both on the card alone (a profiled window of 10
    calls, every launch of a call, the rule's included) in turns P, C, C, P."""
    scan_p, calls_p = other
    ref = random_scan.corr_level_scan_plain(*args)
    o = scan_p(*args)
    e, sc = rel_err(o, ref)
    check(torch.isfinite(o).all().item() and e <= TOL_CORR * sc and torch.equal(o, scan_p(*args)),
          f"corr_level_scan nT={n_t}: the other tree's RE2 within {e:.3e} of {sc:.3e}, or two runs differ")
    mine = random_scan.corr_level_scan_kernel(*args)
    print(f"[9 corr] corr_level_scan nT={n_t}: P's and C's u {'bit-identical' if torch.equal(o, mine) else 'DIFFER'} "
          f"(digests {digest(o)}, {digest(mine)})")
    rows = []
    for arm in "PCCP":  # every kernel of a call, the library's for P's rule too: one window's sum
        fn = scan_p if arm == "P" else random_scan.corr_level_scan_kernel
        rows.append(dict(arm=arm, device_ms=by_kernel(lambda: fn(*args), 10, "9 corr", arm, quiet=True)))
    print(f"[9 corr] corr_level_scan nT={n_t}, arms P, C, C, P on the card alone, rule included: "
          + ", ".join(f"{r['arm']} {r['device_ms']}" for r in rows) + " ms")
    return rows


def re2_phase(ainv, other=None):
    """9.1: RE2 against its plain version at q = 10,000 (the dense A^-1 of
    phase 8's pedigree) for nT = 1, 2, 3, the same bits twice, its time on
    the card alone beside RE1's on the same structure in the same call and
    the library's triangular solve of the same system (and beside another
    tree's RE2, other, in turns, where given); and at q = 1, 31, 33, 193
    (past the look-ahead), 3,001 for nT = 1, 2, 3, 5 (5: the generic form)."""
    out = {}
    q = ainv.shape[0]
    g = torch.Generator(device=DEV).manual_seed(30)
    yi, z, u = (torch.randn(q, generator=g, device=DEV) for _ in range(3))
    args1 = (ainv, yi, torch.rand(q, generator=g, device=DEV) * 3, z, u,
             torch.tensor(1 / 1.7, device=DEV), torch.tensor(0.6, device=DEV))
    re1_ms = device_ms(lambda: random_scan.level_scan_kernel(*args1), 20)
    for n_t in RE2_NTS:
        args = re2_inputs(q, n_t, ainv, seed=n_t)

        def kern():
            return random_scan.corr_level_scan_kernel(*args)

        def plain():
            return random_scan.corr_level_scan_plain(*args)

        o, ref = kern(), plain()
        check(torch.isfinite(o).all().item() and torch.equal(o, kern()),
              f"corr_level_scan nT={n_t}: not finite, or two runs differ")
        e, sc = rel_err(o, ref)
        mat, rhs = random_scan.corr_level_scan_system(*args)

        def library():
            return torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)

        e_l, _ = rel_err(library().view(q, n_t).T, ref)
        check(e_l <= TOL_CORR * sc, f"corr_level_scan nT={n_t}: the library solve differs by {e_l:.3e}")
        ms_k, ms_p = median_ms(kern, 10), median_ms(plain, 1)
        # a call: RE2's two launches (prep builds the rule) and the wrapper's
        # output and scratch: the sum over one profiled window's names
        dev = by_kernel(kern, 10, "9 corr", f"corr_level_scan nT={n_t}")
        lib_dev = device_ms(library, 10, records_per_launch=0)
        name = "corr_level_scan" if n_t == 2 else f"corr_level_scan_nt{n_t}"
        report(name, e, sc, TOL_CORR, ms_k, ms_p, work_re2(q, n_t),
               f" (q = {q:,}, nT = {n_t}, the dense A^-1 of phase 8's pedigree, random rule inputs; "
               f"RE1 on the same A^-1 in this call {re1_ms} ms on the card alone; the library solve's "
               f"max_abs_err {e_l:.3e}, its {q * n_t:,}-unknown system built outside the timed window; "
               "not a TPU kernel: the counterpart of the level lax.scan of sample_random_corr)",
               phase="9 corr", dev_ms=dev, library_ms=median_ms(library, 10), library_dev_ms=lib_dev)
        out[f"nT={n_t}"] = dict(device_ms=dev, re1_device_ms=re1_ms, library_device_ms=lib_dev,
                                max_abs_err=e, scale=sc)
        if other is not None:
            out[f"nT={n_t}"]["arms"] = re2_arms(other, args, n_t)
        del mat, rhs
    for qs in (1, 31, 33, 193, 3001):
        for n_t in (1, 2, 3, 5):
            args = re2_inputs(qs, n_t, seed=qs + n_t)
            o, r = random_scan.corr_level_scan_kernel(*args), random_scan.corr_level_scan_plain(*args)
            e, sc = rel_err(o, r)
            same = torch.equal(o, random_scan.corr_level_scan_kernel(*args))
            print(f"[9 corr] corr_level_scan at q = {qs:,}, nT = {n_t}: max_abs_err {e:.3e} (scale "
                  f"{sc:.3e}); two launches {'bit-identical' if same else 'DIFFER'}")
            check(e <= TOL_CORR * sc and same, f"corr_level_scan at q = {qs}, nT = {n_t} disagrees")
    return out


# CM1's ablation builds: scratch copies of a tree's csrc/corr_scan.cu (start_build's
# patches), each with one part of its design taken out (four loci a chain step, the
# chain handed on at a named barrier with look-ahead sums); a source in which a patch
# does not match exactly once fails the run
CM1_ABLATIONS = (
    ("whole", ()),
    ("no shuffles", (("p[q][t] = __shfl_sync(kFull, acc[t], k0 + q);", "p[q][t] = acc[t];"),)),
    ("no waits", (("  while (*reinterpret_cast<const volatile int*>(pub) < n) __nanosleep(64);\n", ""),
                  ("    named_sync(1 + ((g - 1) & 1), 64);\n    stage(", "    stage("),
                  ("    if (g > 0) named_sync(1 + ((g - 1) & 1), 64);\n", ""))),
    ("no far products", (("  if (kFarSmem && g >= 2) stage_far(0);\n", ""),
                         ("      if (w + 2 < g) stage_far(w + 1);\n", ""),
                         ("    if (mine) {\n      // group w", "    if (false) {\n      // group w"))),
    ("no look-ahead", (("      if (has_next) {\n", "      if (false) {\n"),)),
    ("no staging", (("    if (staged) stage(g, lane, 32);  // into the slot group w has left\n", ""),)),
)


def tree_name(src):
    """The name of the tree whose csrc/ directory src is."""
    return Path(src).resolve().parent.parent.name


def start_cm1_ablations(src):
    """Start the nvcc builds of CM1_ABLATIONS on src's corr_scan.cu (src a
    tree's csrc/): [(name, start_build's triple)]."""
    text = (Path(src) / "corr_scan.cu").read_text()
    check(all(text.count(old) == 1 for _, patches in CM1_ABLATIONS for old, _ in patches),
          f"{src}: CM1_ABLATIONS do not fit its corr_scan.cu")
    return [(name, start_build(src, "cm1_ablation", ["corr_scan.cu"], patches,
                               label=f"{tree_name(src)} {name}"))
            for name, patches in CM1_ABLATIONS]


def finish_cm1_ablations(started):
    """{name: cm1_lib} of start_cm1_ablations's builds."""
    return {name: cm1_lib(finish_build(*b, "corr_scan"), b[0]) for name, b in started}


class CM1Case:
    """One block-step's inputs at the MultiBreed path's shapes: its step-0
    Gram, the rule's rows of a random state (pk_g (V, T, B, W)), a random r0,
    the step's centres, sum(y) and a zeroed beta buffer (V, T, B, nT); rows,
    the step's complete rows as the plain block-step forms them. All in the
    state's type."""

    def __init__(self, plan, st, seed=31):
        cs, cp = st.corr_markers[0], plan.corr_markers[0]
        self.n_t, self.V, self.B = n_t, V, B = cp.n_t, cp.vshards, cp.block
        dt = st.ycorr.dtype
        g = torch.Generator(device=DEV).manual_seed(seed)
        self.z = torch.randn(cp.p_pad, n_t, generator=g, device=DEV).to(dt)
        self.bold = torch.randn(cp.p_pad, n_t, generator=g, device=DEV).to(dt) * 0.01
        self.var_e = st.ycorr.var()
        self.rule_args = (self.bold, self.z, cs.var_beta, cs.region_id, cs.mpm.reshape(-1, n_t, n_t),
                          cs.mask.reshape(-1), self.var_e)
        self.pk = corr_scan.corr_rule_plain(*self.rule_args)
        self.pk_g = self.pk.view(V, -1, B, self.pk.shape[-1])
        self.gram_t = (cs.gram, 0)
        self.r0 = torch.randn(V, B, n_t, generator=g, device=DEV).to(dt) * 30
        self.cb = cs.center[0]
        self.sum_y = st.ycorr.sum()
        self.beta = torch.zeros((V, self.pk_g.shape[1], B, n_t), dtype=dt, device=DEV)
        self.rows = self.pk_g[:, 0].clone()
        self.rows[..., :n_t] += self.r0 - self.cb * self.sum_y
        self.ivb = torch.linalg.inv(cs.var_beta)[torch.clamp(cs.region_id, 0, cp.n_regions - 1).long()]

    def fold(self):
        return self.r0, self.cb, self.sum_y


def cm1_lib(lib, label):
    """(step, calls, swaps) for another build of CM1 (an ablation build, or
    another tree's csrc/corr_scan.cu) with this tree's C interface:
    step(case) -> u is its one launch of a block-step on a CM1Case, through
    this tree's launcher; calls() counts the launches; swaps: the
    ops.corr_scan functions the sampler calls (corr_rule, corr_block_step)
    through that build. A build without that interface
    (ngt_corr_block_step: CM1 before the block-step's fold) is refused."""
    check(hasattr(lib, "ngt_corr_block_step"),
          f"{label}: its CM1 lacks this tree's C interface (ngt_corr_block_step)")
    _cuda.bind_cm1(lib)
    calls = [0]

    def block_step(*args):
        calls[0] += 1
        return corr_scan.corr_block_step_with(lib, *args)

    def rule(*args):
        return (corr_scan.corr_rule_with(lib, *args) if args[0].shape[1] <= corr_scan.FAST_NT
                else corr_scan.corr_rule_plain(*args))

    def step(c):
        return block_step(c.gram_t, c.pk_g, *c.fold(), c.beta)
    return step, lambda: calls[0], dict(corr_rule=rule, corr_block_step=block_step)


def cm1_ablations(ablations, case, tag):
    """Step 1 of a CM1 redesign: each tree's ablation builds (CM1_ABLATIONS)
    on one step's inputs, each launch alone on the card, and the split they
    give: each part, the whole build's time less the build without it."""
    out = {}
    for tree, libs in ablations.items():
        ms = {name: device_ms(lambda: step(case), 20, calls=calls) for name, (step, calls, _) in libs.items()}
        split = {name[3:]: (None if ms["whole"] is None or v is None else ms["whole"] - v)
                 for name, v in ms.items() if name != "whole"}
        print(f"[9 corr] CM1{tag} ablations of {tree}, ms a step on the card alone: "
              + ", ".join(f"{k} {v}" for k, v in ms.items()) + "; the part each takes out: "
              + ", ".join(f"{k} {v}" for k, v in split.items()))
        out[tree] = dict(device_ms=ms, split_ms=split)
    return out


def sm_clocks_mhz():
    """(the SM clock, its maximum) in MHz, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    cur, mx = (float(x) for x in smi.stdout.splitlines()[0].split(","))
    return cur, mx


def cm1_latency_ms(B, n_t, mhz):
    """CM1's dependent-chain bound for one step: B loci one after another,
    each 2 nT + 1 dependent operations (the shuffle of its sums, M_j's nT
    multiply-adds, the next locus's nT) of 4 cycles, at mhz."""
    return B * (2 * n_t + 1) * 4 / (mhz * 1e3)


def work_rule(p, n_regions, n_t, itemsize=4):
    """(bytes, operations) of the rule launch: beta, z, mpm, the mask and the
    region ids read and the packed rows written once a locus, the regions'
    covariances and varE once (values of itemsize bytes, the region id 4,
    the mask 1); a locus's two Gauss-Jordan inverses (2 nT^3 multiply-adds
    each), its Cholesky (nT^3 / 3) and lhs, M, c, adj (4 nT^2), two
    operations a multiply-add."""
    per_locus = itemsize * (2 * n_t + n_t * n_t + corr_scan.pack_width(n_t)) + 4 + 1
    return (p * per_locus + itemsize * (n_regions * n_t * n_t + 1),
            round(p * 2 * (4 * n_t ** 3 + n_t ** 3 / 3 + 4 * n_t * n_t)))


def rule_phase(case, p, n_regions, other=None):
    """9.2a: the rule launch against its plain version (the torch pack,
    corr_rule_plain) on the MultiBreed set's regions and a random state:
    adj, c and M each within 1e-5 of its scale, the same bits twice; both
    times on the card alone; with other, in turns P (the torch pack, the
    parent's rule), C, C, P."""
    n_t = case.n_t
    W = corr_scan.pack_width(n_t)

    def kern():
        return corr_scan.corr_rule_kernel(*case.rule_args)

    def plain():
        return corr_scan.corr_rule_plain(*case.rule_args)

    o, ref = kern(), plain()
    check(torch.equal(o, kern()) and torch.isfinite(o).all().item(), "corr_rule: not finite, or two runs differ")
    errs = {}
    for part, sl in (("adj", slice(0, n_t)), ("c", slice(2 * n_t, 3 * n_t)), ("M", slice(3 * n_t, W))):
        errs[part] = rel_err(o[:, sl], ref[:, sl])
        check(errs[part][0] <= 1e-5 * errs[part][1], f"corr_rule: {part} within {errs[part][0]:.3e}")
    check(torch.equal(o[:, n_t:2 * n_t], ref[:, n_t:2 * n_t]), "corr_rule: bold not copied")
    dev, dev_p = device_ms(kern, 20), device_ms(plain, 20, records_per_launch=0)
    e, sc = max((v for v in errs.values()), key=lambda v: v[0] / v[1])
    report("corr_rule", e, sc, 1e-5, median_ms(kern, 20), median_ms(plain, 20), work_rule(p, n_regions, n_t),
           f" (p = {p:,} loci, {n_regions} regions, nT = {n_t}: adj, c, M within "
           + ", ".join(f"{k} {v[0]:.3e} of {v[1]:.3e}" for k, v in errs.items())
           + f"; the torch pack on the card alone {dev_p} ms; not a TPU kernel: the counterpart of the "
           "per-locus rule in the block lax.scan of sample_corr_marker_set)", phase="9 corr", dev_ms=dev)
    out = dict(device_ms=dev, plain_device_ms=dev_p, errors={k: v[0] for k, v in errs.items()})
    if other is not None:
        rows = [dict(arm=arm, device_ms=device_ms(plain, 20, records_per_launch=0) if arm == "P"
                     else device_ms(kern, 20)) for arm in "PCCP"]
        print("[9 corr] the rule, arms P (the torch pack), C, C, P on the card alone: "
              + ", ".join(f"{r['arm']} {r['device_ms']}" for r in rows) + " ms")
        out["arms"] = rows
    return out


def cm1_arms(other, case, tag):
    """Another tree's CM1 (P, cm1_lib) and this tree's (C) on one
    block-step, in turns P, C, C, P on the card alone. P is first held to
    C's plain version."""
    step_p, calls_p, _ = other
    ref = torch.zeros_like(case.beta)
    ru = corr_scan.corr_block_step_plain(case.gram_t[0][0], case.pk_g, 0, *case.fold(), ref)
    u = step_p(case)
    e, sc = rel_err(case.beta[:, 0], ref[:, 0])
    check(e <= TOL_CORR * sc and rel_err(u, ru)[0] <= TOL_CORR * rel_err(u, ru)[1],
          f"corr_block_scan_v{tag}: the other tree's CM1 within {e:.3e} of {sc:.3e}")
    rows = [dict(arm=arm, device_ms=device_ms(lambda: step_p(case), 20, calls=calls_p) if arm == "P"
                 else device_ms(lambda: corr_scan.corr_block_step_kernel(
                     case.gram_t, case.pk_g, *case.fold(), case.beta), 20)) for arm in "PCCP"]
    print(f"[9 corr] CM1{tag}, arms P, C, C, P on the card alone: "
          + ", ".join(f"{r['arm']} {r['device_ms']}" for r in rows) + " ms")
    return rows


def cm1_phase(plan, st, ablations=None, other=None):
    """9.2: CM1's block-step (the folded launch: rows read in place, r0,
    centres and sum(y) added, beta written into the (V, T, B, nT) buffer)
    against its plain version at the MultiBreed path's first step (its Gram,
    the rule's rows of a random state), at V as assembled, the same bits
    twice and the buffer's other steps untouched, its time on the card alone
    beside its byte and dependent-chain bounds, K6 on the first set's Gram
    at the same (V, B) and the library's batched triangular solve of the
    same systems; ablations: {tree: {name: cm1_lib}}, timed by
    cm1_ablations; other: another tree's CM1 (cm1_lib), by cm1_arms."""
    case = CM1Case(plan, st)
    cs, cp = st.corr_markers[0], plan.corr_markers[0]
    n_t, V, B = case.n_t, case.V, case.B
    tag = "" if V > 1 else "_v1"
    name = "corr_block_scan_v" + tag

    def kern():
        return corr_scan.corr_block_step_kernel(case.gram_t, case.pk_g, *case.fold(), case.beta)

    ref = torch.zeros_like(case.beta)

    def plain():
        return corr_scan.corr_block_step_plain(cs.gram[0], case.pk_g, 0, *case.fold(), ref)

    u, ru = kern(), plain()
    b, rb = case.beta[:, 0].clone(), ref[:, 0]
    check(torch.isfinite(b).all().item() and torch.equal(u, kern()) and torch.equal(b, case.beta[:, 0]),
          f"{name}: not finite, or two runs differ")
    check(not case.beta[:, 1:].any().item(), f"{name}: wrote outside its step of the beta buffer")
    e, sc = rel_err(b, rb)
    eu, scu = rel_err(u, ru)
    check(eu <= TOL_CORR * scu, f"{name}: u max_abs_err {eu:.3e} of {scu:.3e}")
    mat, rhs = corr_scan.corr_block_system(cs.gram[0], case.rows, n_t)

    def library():
        return torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)

    e_l, _ = rel_err(library().view(V, B, n_t), ru)
    check(e_l <= TOL_CORR * scu, f"{name}: the library solve differs by {e_l:.3e}")
    # K6 in the same call, on the first set's Gram at the same (V, B)
    g6 = cs.gram[:, :, 0, :, :, 0].contiguous()  # (T, B, V, B)
    pk6 = gibbs_kernels.gauss_block_pack(torch.zeros(cp.p_pad, device=DEV), case.bold[:, 0], case.z[:, 0],
                                         case.ivb[:, 0, 0], cs.mpm[..., 0, 0].reshape(-1),
                                         torch.zeros(cp.p_pad, device=DEV),
                                         torch.zeros(cp.p_pad, device=DEV), cs.mask.reshape(-1),
                                         1.0 / case.var_e)
    pk6 = pk6.view(V, -1, B, 8)[:, 0].contiguous()
    k6_ms = device_ms(lambda: gibbs_kernels.gauss_block_scan_v((g6, 0), pk6), 20)
    ms_k, ms_p = median_ms(kern, 20), median_ms(plain, 3)
    dev = device_ms(kern, 20)
    mhz, mhz_max = sm_clocks_mhz()
    lat = cm1_latency_ms(B, n_t, mhz)
    report(name, e, sc, TOL_CORR, ms_k, ms_p, work_cm1(V, B, n_t),
           f" (V = {V}, B = {B}, nT = {n_t}, the MultiBreed panels' Gram, the rule's rows of a random state "
           f"with r0, the step's centres and sum(y) folded in; u max_abs_err {eu:.3e} of {scu:.3e}; the "
           f"dependent-chain bound {lat:.6f} ms ({B} loci x {2 * n_t + 1} operations x 4 cycles at the "
           f"{mhz:g} MHz SM clock nvidia-smi reports, maximum {mhz_max:g}); K6 on the first set's Gram at "
           f"the same V, B in this call {k6_ms} ms on the card alone; the library's batched solve's "
           f"max_abs_err {e_l:.3e}, its systems built outside the timed window; not a TPU kernel: the "
           "counterpart of the block lax.scan of sample_corr_marker_set)", phase="9 corr", dev_ms=dev,
           library_ms=median_ms(library, 20), library_dev_ms=device_ms(library, 20, records_per_launch=0))
    TIMINGS[name].update(latency_bound_ms=lat, sm_clock_mhz=mhz, sm_clock_max_mhz=mhz_max)
    out = dict(device_ms=dev, k6_device_ms=k6_ms, max_abs_err=e, scale=sc, latency_bound_ms=lat)
    if V > 1:
        out["rule"] = rule_phase(case, cp.p_pad, cp.n_regions, other)
    if ablations:
        out["ablations"] = cm1_ablations(ablations, case, tag)
    if other is not None:
        out["arms"] = cm1_arms(other, case, tag)
    return out


def multibreed_arms(spec, V, other):
    """MultiBreed's replayed sweep (KeyedStream) with another tree's CM1 (P:
    the sampler's rule and block-step swapped for that tree's, cm1_lib's
    swaps, while the sweep is captured) and this tree's (C) in turns P, C,
    C, P: steady ms/sweep (CUDA events around 20 replays), device busy,
    CM1's kernels and the rule launch's share of it, nodes and the idle
    share."""
    swaps = other[2]
    plan, st0 = ngt.assemble(spec, vshards=V)
    stream = keyed.KeyedStream(7, DEV, torch.float32)
    orig = {k: getattr(corr_scan, k) for k in swaps}
    rows = []
    for arm in "PCCP":
        for k in swaps:
            setattr(corr_scan, k, swaps[k] if arm == "P" else orig[k])
        try:
            rep = engine_sweep.ReplayedSweep(plan, st0, stream)
        finally:
            for k in swaps:
                setattr(corr_scan, k, orig[k])
        ms = steady_ms(lambda: rep.run(1), 20)
        busy, per_sweep, _, _, ms_by = replay_window(rep, 10)
        cm1 = sum(v for k, v in ms_by.items() if "corr_scan_kernel" in k)
        rule = sum(v for k, v in ms_by.items() if "corr_rule_kernel" in k)
        rows.append(dict(arm=arm, replay_ms_per_sweep=ms, busy_ms=busy, cm1_ms=cm1, rule_ms=rule,
                         idle_share=1.0 - busy / ms, nodes=per_sweep))
        del rep
    print(f"[9 MultiBreed V={V}] replayed, arms P, C, C, P: " + "; ".join(
        f"{r['arm']} {r['replay_ms_per_sweep']:.4f} ms/sweep (busy {r['busy_ms']:.4f}, CM1's kernels "
        f"{r['cm1_ms']:.4f}, the rule launch {r['rule_ms']:.4f}, idle share {r['idle_share']:.4f}, "
        f"{r['nodes']} nodes)" for r in rows))
    return rows


def corr_path(tag, spec, V, checks, phase="9"):
    """One M9 path: run_lmem as it runs by default (PhiloxStream, eager;
    launch counts from 0), then a loop of make_sweep and run_lmem's replays
    from one KeyedStream (the same bits), then the steady ms/sweep of both
    arms, the replays' kernels a sweep, device busy and idle share. Checks
    drift, finite draws and every kept covariance draw positive definite
    (cholesky_ex info 0); `checks(res)` prints the path's own numbers and
    returns the expected launch counts."""
    ph = f"{phase} {tag}"
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = ngt.run_lmem(spec, n_chain=N_CHAIN_CM, n_burn=N_BURN_CM, n_thin=N_THIN_CM, out_folder=None,
                       seed=7, vshards=V)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    expect = {k: 0 for k in launches}
    expect.update(checks(res))
    check(launches == expect, f"{tag}: launches {launches}, expected {expect}")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad, f"{tag}: kept draws of {bad} are not finite")
    for k, a in res.draws.items():  # the (n_regions, 4) and (2, 2) covariance draws
        if k.startswith("var") and a.ndim == 3:
            mats = torch.from_numpy(a).reshape(-1, 2, 2).double()
            check((torch.linalg.cholesky_ex(mats)[1] == 0).all().item(),
                  f"{tag}: a kept {k} draw is not positive definite")
    drift = corr_drift(res.plan, res.state)
    print(f"[{ph}] run_lmem (PhiloxStream, eager) {N_CHAIN_CM} sweeps in {wall:.2f} s: "
          f"{res.sweeps_per_sec:.2f} sweeps/s (host clock); launches "
          f"{({k: v for k, v in launches.items() if v})}; drift {drift:.3e} of max|y| (limit 1e-2); "
          f"varE {res.state.e.var_e.item():.4f}; every kept covariance positive definite")
    check(drift < 1e-2, f"{tag}: ycorr drifted")
    del res

    plan, st0 = ngt.assemble(spec, vshards=V)
    stream = keyed.KeyedStream(7, DEV, plan.dtype)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    st, kept = st0, []
    t0 = time.perf_counter()
    for i in range(1, N_CHAIN_CM + 1):
        st = sweep(st, stream)
        if i > N_BURN_CM and (i - N_BURN_CM) % N_THIN_CM == 0:
            kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    keyed_launches = dict(_cuda.LAUNCHES)
    eager = {k: torch.stack([x[k] for x in kept]) for k in kept[0]}
    rres = ngt.run_lmem(spec, n_chain=N_CHAIN_CM, n_burn=N_BURN_CM, n_thin=N_THIN_CM, out_folder=None,
                        vshards=V,
                        stream=stream)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), rres.draws[k])]
    check(set(rres.draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(rres.state.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    r_drift = corr_drift(rres.plan, rres.state)
    check(r_drift < 1e-2, f"{tag}: replayed ycorr drifted")
    rep = engine_sweep.ReplayedSweep(plan, rres.state, stream)
    state = [rres.state]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, 20)
    ms_replay = steady_ms(lambda: rep.run(1), 20)
    busy, per_sweep, missed, by_name, ms_by = replay_window(rep, 10)
    idle = 1.0 - busy / ms_replay
    print(f"[{ph}] KeyedStream: kept draws and final ycorr bit-identical eager and replayed (drift "
          f"{r_drift:.3e}); eager {N_CHAIN_CM / eager_s:.2f} sweeps/s, replayed run_lmem "
          f"{rres.sweeps_per_sec:.2f} sweeps/s (host clock); steady, 20 sweeps between CUDA events: eager "
          f"{ms_eager:.4f} ms/sweep, replayed {ms_replay:.4f} ms/sweep; 10 replays under the profiler: "
          f"device busy {busy:.4f} ms/sweep, {per_sweep} kernels and copies per sweep ({missed} records "
          f"missed); idle share without the profiler {idle:.4f}; eager launches per sweep "
          f"{({k: v / N_CHAIN_CM for k, v in keyed_launches.items() if v})}")
    for key, cnt in sorted(ms_by.items(), key=lambda r: -r[1])[:6]:
        print(f"  replayed {ms_by[key]:.4f} ms/sweep in x{by_name[key]:<4} {key[:90]}")
    del rep, state, rres
    return launches, keyed_launches, dict(eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay,
                                          replay_busy_ms_per_sweep=busy, idle_share=idle, drift=drift,
                                          kernels_per_sweep=per_sweep)


def corr_chain_phase():
    """9.5: the kernel chains against the float64 plain chains on a small
    model of each path (3 sweeps, one HostStream): corr(beta or u) and
    corr(ycorr) > 0.999, |dycorr| / scale < 0.05 (the packed rule of
    bench.py:338-359), two kernel runs bit-identical."""
    n, p = 512, 1024
    rng = np.random.default_rng(17)
    gs = [rng.integers(0, 3, (n, p)).astype(np.int8) for _ in range(2)]
    y = sum((g - g.mean(0)) @ rng.normal(0, 0.05, p) for g in gs) + rng.normal(0, 1, n)
    chr_ids = np.ones(p, np.int64)
    ms = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], block_size=128, corr_markers=[
        ngt.CorrMarkerTerm(("M1", "M2"), tuple(ngt.from_array(g, chr_ids=chr_ids) for g in gs),
                           ngt.BayesPR(REGION_CM, V_CM))])
    ped, _ = simulate_pedigree(4, n // 4, seed=19)
    x = rng.normal(size=n)
    rs = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], random=[
        ngt.RandomTerm(("A", "S"), (np.eye(n), np.eye(n) * x[:, None]), prior=ngt.Random("A", V_A2),
                       ivstr=pedigree.a_inverse(ped))])
    for name, spec, V in (("MultiBreed", ms, 1), ("MultiBreed", ms, 4), ("A2", rs, 1)):
        def run(device, dtype):
            plan, st = ngt.assemble(spec, device=device, dtype=dtype, vshards=V)
            sweep, draws = ngt.make_sweep(plan), HostStream(11, device, dtype)
            for _ in range(3):
                st = sweep(st, draws)
            x = st.corr_markers[0].beta if plan.corr_markers else st.random[0].u
            return x.reshape(-1).double().cpu().numpy(), st.ycorr.double().cpu().numpy()

        (xk, yk), (xp, yp), xk2 = run(DEV, torch.float32), run("cpu", torch.float64), run(DEV, torch.float32)[0]
        cx, cy = np.corrcoef(xk, xp)[0, 1], np.corrcoef(yk, yp)[0, 1]
        dy = np.abs(yk - yp).max() / np.abs(yp).max()
        print(f"[9 chain] {name} V={V}: float32 kernels against float64 plain: corr(effects) {cx:.6f}, "
              f"corr(ycorr) {cy:.6f}, max|dycorr|/scale {dy:.3e} (limits 0.999, 0.999, 0.05); two kernel "
              f"runs {'bit-identical' if np.array_equal(xk, xk2) else 'DIFFER'}")
        check(cx > 0.999 and cy > 0.999 and dy < 0.05, f"{name} V={V}: kernel chain departs from plain")
        check(np.array_equal(xk, xk2), f"{name} V={V}: two kernel runs differ")


def corr_replay_arms(spec, other):
    """BayesR+A2's replayed sweep (KeyedStream) with another tree's RE2 (P;
    sample_random_corr's scan swapped for it while the sweep is captured)
    and this tree's (C) in turns P, C, C, P: steady ms/sweep (CUDA events
    around 20 replays), device busy, RE2's share of it (its kernels, and for
    P the rule's torch.linalg launches are not counted in it) and the idle
    share."""
    scan_p, _ = other
    plan, st0 = ngt.assemble(spec, vshards=V_MAIN)
    stream = keyed.KeyedStream(7, DEV, torch.float32)
    orig = random_effects.corr_level_scan
    rows = []
    for arm in "PCCP":
        random_effects.corr_level_scan = scan_p if arm == "P" else orig
        try:
            rep = engine_sweep.ReplayedSweep(plan, st0, stream)
        finally:
            random_effects.corr_level_scan = orig
        ms = steady_ms(lambda: rep.run(1), 20)
        busy, per_sweep, _, _, ms_by = replay_window(rep, 10)
        re2 = sum(v for k, v in ms_by.items() if "coop_" in k)
        rows.append(dict(arm=arm, replay_ms_per_sweep=ms, busy_ms=busy, re2_ms=re2,
                         idle_share=1.0 - busy / ms, nodes=per_sweep))
        del rep
    print("[9 BayesR+A2] replayed, arms P, C, C, P: " + "; ".join(
        f"{r['arm']} {r['replay_ms_per_sweep']:.4f} ms/sweep (busy {r['busy_ms']:.4f}, RE2's kernels "
        f"{r['re2_ms']:.4f}, idle share {r['idle_share']:.4f}, {r['nodes']} nodes)" for r in rows))
    return rows


def corr_phase(spec_for, sig, other=None, ablations=None, other_cm1=None):
    """9: the correlated terms (ROADMAP M9). RE2 (9.1) and CM1 (9.2) against
    their plain versions; MultiBreed, two 10,000 x 49,152 panels correlated
    under BayesPR with a 2 x 2 v and 492 regions, at V=96 and V=1 (9.3);
    BayesR+A2, phase 8's BayesR path plus an (intercept, slope) animal group
    on phase 8's 10,000-animal pedigree (9.4); each as corr_path runs it;
    the kernel chains against the float64 plain chains (9.5). With other
    (another tree's RE2, other_corr_level_scan), RE2 and BayesR+A2's replayed
    sweep also beside it in turns; with other_cm1 (another tree's CM1,
    cm1_lib), CM1, the rule and MultiBreed's replayed sweep at both V;
    ablations (CM1's, finish_cm1_ablations by tree) are timed at both V.
    Returns the numbers and the launch counts by run."""
    out, counted = {}, {}
    t0 = time.perf_counter()
    ped, u1, ainv = phase8_pedigree()
    ainv_dev = torch.as_tensor(ainv, dtype=torch.float32, device=DEV)
    print(f"[9 corr] phase 8's pedigree and dense A^-1 in {time.perf_counter() - t0:.2f} s")
    out["RE2"] = re2_phase(ainv_dev, other)

    spec_m, sig_m = simulate_corr()
    mem0 = torch.cuda.memory_allocated()
    plan, st = ngt.assemble(spec_m, vshards=V_MAIN)
    cs = st.corr_markers[0]
    print(f"[9 MultiBreed] {plan.corr_markers[0].n_regions} regions; on the card: panels "
          f"{cs.mt.numel() / 1e6:.1f} MB, Grams {4 * cs.gram.numel() / 1e6:.1f} MB (state "
          f"{(torch.cuda.memory_allocated() - mem0) / 1e6:.1f} MB)")
    out["CM1 V=96"] = cm1_phase(plan, st, ablations, other_cm1)
    del plan, st, cs
    plan, st = ngt.assemble(spec_m, vshards=1)
    out["CM1 V=1"] = cm1_phase(plan, st, ablations, other_cm1)
    del plan, st

    for V in (V_MAIN, 1):
        def checks(res, V=V):
            cp, cs = res.plan.corr_markers[0], res.state.corr_markers[0]
            mean = torch.zeros_like(cs.beta)
            for t, nm in enumerate(cp.names):
                mean[: cp.p, t] = torch.from_numpy(res.posterior_mean(f"beta{nm}")).to(DEV)
            gv = corr_values(res.plan, replace(res.state, corr_markers=(replace(cs, beta=mean),)))
            print(f"[9 MultiBreed V={V}] EBV corr (posterior-mean beta of both sets) with the planted "
                  f"signal over 2,048 individuals {corr(gv[:2048], sig_m[:2048]):.4f} (printed only)")
            n = cp.n_blocks // V * N_CHAIN_CM
            return dict(pack2_matvec=n, pack2_rank_update=n, corr_block_scan_v=n, corr_rule=N_CHAIN_CM)

        launches, klaunches, rec = corr_path(f"MultiBreed V={V}", spec_m, V, checks)
        counted[f"MultiBreed V={V}"], counted[f"MultiBreed keyed V={V}"] = launches, klaunches
        out[f"MultiBreed V={V}"] = rec
        if other_cm1 is not None:
            out[f"MultiBreed V={V} replay arms"] = multibreed_arms(spec_m, V, other_cm1)
    del spec_m

    spec = spec_for("BayesR")
    rng = np.random.default_rng(23)
    x = rng.normal(size=N)
    u2 = 0.5 * u1 + 0.75 ** 0.5 * henderson_values(ped, GENS, GEN_SIZE_A, np.random.default_rng(24))
    eye = np.eye(N)
    spec_a2 = ngt.ModelSpec(y=spec.y + u1 + x * u2, fixed=spec.fixed, markers=spec.markers,
                            block_size=BLOCK, random=[ngt.RandomTerm(
                                ("A", "S"), (eye, eye * x[:, None]), prior=ngt.Random("A", V_A2),
                                ivstr=ainv_dev)])

    def checks_a2(res):
        T = res.plan.markers[0].n_blocks // V_MAIN
        u = torch.from_numpy(res.posterior_mean("uA_S")).to(DEV)
        print(f"[9 BayesR+A2] corr(posterior-mean u, planted) over 2,048 individuals: intercept "
              f"{corr(u[0, :2048], torch.from_numpy(u1[:2048]).to(DEV)):.4f}, slope "
              f"{corr(u[1, :2048], torch.from_numpy(u2[:2048]).to(DEV)):.4f} (printed only); varU mean "
              f"{res.draws['varUA_S'].mean(0).round(4).tolist()}")
        return dict(pack2_matvec=T * N_CHAIN_CM, pack2_rank_update=T * N_CHAIN_CM,
                    r_block_scan_v=T * N_CHAIN_CM, corr_level_scan=N_CHAIN_CM)

    counted["BayesR+A2"], counted["BayesR+A2 keyed"], out["BayesR+A2"] = corr_path(
        "BayesR+A2", spec_a2, V_MAIN, checks_a2)
    if other is not None:
        out["BayesR+A2 replay arms"] = corr_replay_arms(spec_a2, other)
    del spec_a2
    corr_chain_phase()
    return out, counted


def corr_only(spec_for, sig, card, other_src=None):
    """`python3 chip_smoke.py corr [DIR]`: phase 9 alone, the quick form for
    work on the correlated terms, with CM1's ablation builds of this tree
    (CM1_ABLATIONS); with DIR (another tree's csrc/), DIR's ablation builds
    too, and RE2, CM1, the rule, and the BayesR+A2 and MultiBreed replayed
    sweeps also against DIR's in turns P, C, C, P. One JSON line of its
    numbers, and no result line."""
    srcs = [_cuda.CSRC] + ([] if other_src is None else [other_src])
    started = [start_cm1_ablations(src) for src in srcs]
    other = other_cm1 = None
    if other_src is not None:
        build = start_build(other_src, "cm1_other", ["corr_scan.cu"])
        other = other_corr_level_scan(other_src)
        other_cm1 = cm1_lib(finish_build(*build, "corr_scan"), build[0])
    ablations = {tree_name(src): finish_cm1_ablations(st) for src, st in zip(srcs, started)}
    out, counted = corr_phase(spec_for, sig, other, ablations, other_cm1)
    print(json.dumps({"card": card, "corr": out, "launches": counted,
                      **{k: TIMINGS.get(k) for k in TIMINGS if k.startswith("corr_")}}))


# ------------------------------------------------------------------ phase 10

RT_EVERY = 2  # (a): a checkpoint every 2 kept samples (10 sweeps)
RT_STOP = 75  # (a): the interrupted run's n_chain (its last checkpoint at kept sample 4)
RT_CG_CHAIN, RT_CG_EVERY, RT_CG_STOP = 20, 5, 17  # (b): sweeps, checkpoints, the interrupted run
RT_PREDICT_ROWS = 1000  # (d): panel rows served through predict
TOL_SERVE = 1e-5  # (d): K2 on the card (f32) against the host's f64, of the output's scale


def same_leaves(tag, a, b):
    """Every tensor of two states the same bits, and the same sweep index."""
    la, lb = engine_sweep._leaves(a), engine_sweep._leaves(b)
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    check(la.keys() == lb.keys() and not differ and a.sweep_index == b.sweep_index,
          f"{tag}: final states differ in {differ} (sweep {a.sweep_index} against {b.sweep_index})")


def out_files(folder):
    return {f: (Path(folder) / f).read_bytes() for f in sorted(os.listdir(folder)) if f.endswith("Out")}


def runtime_bayesr(spec, sig, root):
    """10a: BayesR at V=96 through run_lmem with a KeyedStream (replayed):
    without files (N) and with files and a checkpoint every RT_EVERY kept
    samples (F) in turns N, F, F, N, then stopped at RT_STOP sweeps and
    resumed to N_CHAIN. Files byte for byte, draws and final state bit for
    bit; EBV limit; ms/sweep of each turn; the checkpoint's bytes and
    seconds."""
    from nextgp_tpu_torch.io import checkpoint as ckpt

    stream = keyed.KeyedStream(7, DEV, torch.float32)
    kw = dict(n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, vshards=V_MAIN, stream=stream)
    # the arms in turns without files (N) and with them (F): N, F, F, N
    ref = ngt.run_lmem(spec, out_folder=None, **kw)
    _cuda.reset_launches()
    full = ngt.run_lmem(spec, out_folder=f"{root}/a", checkpoint_every=RT_EVERY, **kw)
    launches = dict(_cuda.LAUNCHES)
    again = ngt.run_lmem(spec, out_folder=f"{root}/a2", checkpoint_every=RT_EVERY, **kw)
    last = ngt.run_lmem(spec, out_folder=None, **kw)
    ngt.run_lmem(spec, out_folder=f"{root}/b", checkpoint_every=RT_EVERY, **{**kw, "n_chain": RT_STOP})
    resumed = ngt.run_lmem(spec, out_folder=f"{root}/b", checkpoint_every=RT_EVERY, resume=True, **kw)
    files = out_files(f"{root}/a")
    check(files and files == out_files(f"{root}/b") == out_files(f"{root}/a2"),
          "10a: resumed files differ from the unbroken run's")
    kept_before = (RT_STOP - N_BURN) // N_THIN // RT_EVERY * RT_EVERY
    for tag, res, first in (("files", full, 0), ("no files", last, 0), ("resumed", resumed, kept_before)):
        differ = [k for k in ref.draws if not np.array_equal(ref.draws[k][first:], res.draws[k])]
        check(res.draws.keys() == ref.draws.keys() and not differ, f"10a: {tag} draws {differ} differ")
    same_leaves("10a resumed", full.state, resumed.state)
    same_leaves("10a files", full.state, ref.state)
    turns = [1e3 / r.sweeps_per_sec for r in (ref, full, again, last)]
    plan, st = full.plan, full.state
    check(plan.markers[0].vshards == V_MAIN, f"10a: V = {plan.markers[0].vshards}")
    mean = ngt.genomic_values_state(plan, st, beta=full.posterior_mean("betaM1"))
    ebv, tru = mean[:2048] - mean[:2048].mean(), sig[:2048].to(mean.dtype) - sig[:2048].mean()
    corr = (torch.dot(ebv, tru) / (ebv.norm() * tru.norm())).item()
    check(corr >= EBV_LIMITS[("BayesR", V_MAIN)], f"10a: EBV correlation {corr:.4f} below the limit")
    path = f"{root}/a/chain.ckpt"
    t0 = time.perf_counter()
    digest = ckpt.constants_digest(st)
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_checkpoint(path, st, meta={"fingerprint": ckpt.plan_fingerprint(plan),
                                         "kept_rows": full.draws["varE"].shape[0], "constants": digest})
    save_s = time.perf_counter() - t0
    out = dict(ms_per_sweep_turns=dict(zip(("N", "F", "F2", "N2"), turns)),
               ms_per_sweep_resumed=1e3 / resumed.sweeps_per_sec, checkpoint_bytes=os.path.getsize(path),
               checkpoint_s=save_s, constants_digest_s=digest_s,
               file_bytes=sum(len(v) for v in files.values()), ebv_corr=corr)
    print(f"[10a BayesR V={V_MAIN}] run_lmem, KeyedStream, replayed, {N_CHAIN} sweeps ({N_BURN} burn-in, "
          f"thin {N_THIN}), ms/sweep in turns without files (N) and with {len(files)} files and a "
          f"checkpoint every {RT_EVERY} kept samples (F): N {turns[0]:.4f}, F {turns[1]:.4f}, F "
          f"{turns[2]:.4f}, N {turns[3]:.4f}; {out['ms_per_sweep_resumed']:.4f} resumed (host clock from "
          f"the first capture to the device finishing); files ({out['file_bytes']:,} bytes) and draws the "
          f"same bits after a stop at {RT_STOP} and a resume, final state bit for bit; EBV corr "
          f"{corr:.4f} (limit {EBV_LIMITS[('BayesR', V_MAIN)]}); a checkpoint {out['checkpoint_bytes']:,} "
          f"bytes in {save_s * 1e3:.2f} ms, the constants' digest once a run {digest_s * 1e3:.1f} ms")
    print(f"[10a BayesR V={V_MAIN}] launches counted by the wrappers at capture: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches, ref, stream


def runtime_acg(root):
    """10b: A-cg on phase 8's 100,000 animals in float64, replayed with a
    KeyedStream: RT_CG_CHAIN sweeps with a checkpoint every RT_CG_EVERY,
    then a run stopped at RT_CG_STOP sweeps and resumed: u and ycorr (and
    every other leaf) bit for bit, the files byte for byte."""
    spec, _, _ = acg_spec(CG_GEN_SIZE)
    stream = keyed.KeyedStream(11, DEV, torch.float64)
    kw = dict(n_chain=RT_CG_CHAIN, n_burn=0, n_thin=1, dtype=torch.float64, stream=stream,
              checkpoint_every=RT_CG_EVERY, keep_in_memory=False)
    _cuda.reset_launches()
    full = ngt.run_lmem(spec, out_folder=f"{root}/cg_a", **kw)
    launches = dict(_cuda.LAUNCHES)
    ngt.run_lmem(spec, out_folder=f"{root}/cg_b", **{**kw, "n_chain": RT_CG_STOP})
    resumed = ngt.run_lmem(spec, out_folder=f"{root}/cg_b", resume=True, **kw)
    check(out_files(f"{root}/cg_a") == out_files(f"{root}/cg_b"), "10b: resumed files differ")
    same_leaves("10b resumed", full.state, resumed.state)
    check(torch.isfinite(full.state.random[0].u).all().item() and residual_drift(full.plan, full.state) < 1e-2,
          "10b: u not finite, or ycorr drifted")
    print(f"[10b A-cg] {full.plan.random[0].q:,} animals, float64, KeyedStream, replayed: {RT_CG_CHAIN} "
          f"sweeps with a checkpoint every {RT_CG_EVERY} ({1e3 / full.sweeps_per_sec:.4f} ms/sweep, host "
          f"clock), stopped at {RT_CG_STOP} and resumed ({1e3 / resumed.sweeps_per_sec:.4f} ms/sweep): "
          f"u, ycorr and every other leaf bit for bit, files byte for byte; launches counted at capture "
          f"{ {k: v for k, v in launches.items() if v} }")
    return dict(ms_per_sweep=1e3 / full.sweeps_per_sec, ms_per_sweep_resumed=1e3 / resumed.sweeps_per_sec,
                checkpoint_bytes=os.path.getsize(f"{root}/cg_a/chain.ckpt")), launches


def runtime_chains(spec, ref, stream, root):
    """10c: two chains of 10a through run_chains, each with its own
    KeyedStream: chain 0 the same bits as 10a's run_lmem with its stream,
    chain 1 as a run_lmem with the other; R-hat of varE finite. Then with
    per-chain files and a checkpoint every RT_EVERY kept samples, unbroken
    and stopped at RT_STOP sweeps and resumed: the draws of the run without
    files, every chain's files byte for byte, the batched state bit for
    bit."""
    other = keyed.KeyedStream(8, DEV, torch.float32)
    kw = dict(n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, vshards=V_MAIN)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = ngt.run_chains(spec, 2, track="all", streams=[stream, other], **kw)
    plain_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    one = ngt.run_lmem(spec, out_folder=None, stream=other, **kw)
    for c, res in enumerate((ref, one)):
        differ = [k for k in res.draws if not np.array_equal(out["draws"][k][c], res.draws[k])]
        check(out["draws"].keys() == res.draws.keys() and not differ, f"10c: chain {c}'s {differ} differ")
    check(not np.array_equal(out["draws"]["varE"][0], out["draws"]["varE"][1]), "10c: the chains agree")
    rhat = float(out["rhat"]["varE"][0])
    check(np.isfinite(rhat), f"10c: R-hat of varE {rhat}")
    check(out["state"].ycorr.shape[0] == 2 and out["state"].sweep_index.tolist() == [N_CHAIN] * 2,
          "10c: the batched state")
    fkw = dict(kw, track="all", streams=[stream, other], checkpoint_every=RT_EVERY)
    runs_s = []

    def timed(folder, **extra):
        t0 = time.perf_counter()
        res = ngt.run_chains(spec, 2, out_folder=f"{root}/{folder}", **{**fkw, **extra})
        runs_s.append(time.perf_counter() - t0)
        return res

    full = timed("ch_a")
    timed("ch_b", n_chain=RT_STOP)
    resumed = timed("ch_b", resume=True)
    kept_before = (RT_STOP - N_BURN) // N_THIN // RT_EVERY * RT_EVERY
    for tag, res, first in (("files", full, 0), ("resumed", resumed, kept_before)):
        differ = [k for k in out["draws"] if not np.array_equal(out["draws"][k][:, first:], res["draws"][k])]
        check(res["draws"].keys() == out["draws"].keys() and not differ, f"10c: {tag} draws {differ} differ")
    n_files = 0
    for chain in ("chain1", "chain2"):
        files = out_files(f"{root}/ch_a/{chain}")
        n_files += len(files)
        check(files and files == out_files(f"{root}/ch_b/{chain}"), f"10c: resumed {chain} files differ")
    for tag, res in (("resumed", resumed), ("no files", out)):
        la, lb = engine_sweep._leaves(full["state"]), engine_sweep._leaves(res["state"])
        differ = [k for k in la if not torch.equal(la[k], lb[k])]
        check(la.keys() == lb.keys() and not differ, f"10c: {tag} batched state differs in {differ}")
    print(f"[10c run_chains] two chains of 10a in turn, each the same bits as its run_lmem; R-hat of "
          f"varE {rhat:.4f}, ESS {float(out['ess']['varE'][0]):.2f}; with {n_files} per-chain files and "
          f"a checkpoint every {RT_EVERY} kept samples, stopped at {RT_STOP} and resumed: files byte for "
          f"byte, draws and the batched state bit for bit; seconds a call: {plain_s:.2f} without files, "
          f"with files (unbroken, stopped, resumed) {', '.join(f'{t:.2f}' for t in runs_s)}")
    return dict(rhat_var_e=rhat, ess_var_e=float(out["ess"]["varE"][0]), no_files_s=plain_s,
                files_runs_s=runs_s), launches


def runtime_serving(spec, ref):
    """10d: the posterior-mean beta of 10a served on the host (genomic_values,
    f64) and on the card (genomic_values_state, K2 over the whole panel,
    f32); predict on RT_PREDICT_ROWS panel rows against genomic_values."""
    md = spec.markers[0].data
    beta = ref.posterior_mean("betaM1")
    t0 = time.perf_counter()
    host = ngt.genomic_values(md, beta)
    host_s = time.perf_counter() - t0
    _cuda.reset_launches()
    card = ngt.genomic_values_state(ref.plan, ref.state, beta=beta)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    err = np.abs(card.double().cpu().numpy() - host).max() / np.abs(host).max()
    check(err < TOL_SERVE, f"10d: genomic_values_state {err:.3e} of scale from genomic_values")
    m = min(RT_PREDICT_ROWS, md.n_ind)
    rows = pack2.unpack2(md.genotypes, torch.uint8)[:, :m].T.cpu().numpy()
    pred = ngt.predict(md, beta, rows)
    perr = np.abs(pred - host[:m]).max() / np.abs(host).max()
    check(perr < 1e-9, f"10d: predict {perr:.3e} of scale from genomic_values")
    print(f"[10d serving] genomic_values (host f64, {host_s:.3f} s) against genomic_values_state (K2, "
          f"card f32): {err:.3e} of scale (limit {TOL_SERVE}); predict on {m:,} panel rows "
          f"{perr:.3e} of scale (limit 1e-9)")
    return dict(serve_err=err, predict_err=perr, genomic_values_host_s=host_s), launches


def runtime_phase(spec_for, sig):
    """10: the runtime (ROADMAP M10, M11) on the card: run_lmem's files,
    checkpoints and exact resume (10a BayesR, 10b A-cg), run_chains (10c)
    and serving (10d). Output folders live in a temporary directory removed
    afterwards. Returns the numbers and the launch counts by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ngt_runtime_")
    counted = {}
    try:
        spec = spec_for("BayesR")
        out = {}
        parts = {}
        t1 = time.perf_counter()
        out["BayesR"], counted["runtime BayesR"], ref, stream = runtime_bayesr(spec, sig, root)
        parts["a"], t1 = time.perf_counter() - t1, time.perf_counter()
        out["chains"], counted["runtime chains"] = runtime_chains(spec, ref, stream, root)
        parts["c"], t1 = time.perf_counter() - t1, time.perf_counter()
        out["serving"], counted["runtime serving"] = runtime_serving(spec, ref)
        parts["d"], t1 = time.perf_counter() - t1, time.perf_counter()
        del ref
        out["A-cg"], counted["runtime A-cg"] = runtime_acg(root)
        parts["b"] = time.perf_counter() - t1
        out["part_seconds"] = parts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[10 runtime] every check passed in {out['seconds']:.1f} s (by part: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in out['part_seconds'].items())})")
    return out, counted


def runtime_only(spec_for, sig, card):
    """`python3 chip_smoke.py runtime`: phase 10 alone. One JSON line of its
    numbers and launch counts, and no result line."""
    out, counted = runtime_phase(spec_for, sig)
    print(json.dumps({"card": card, "runtime": out, "launches": counted}))


# ------------------------------------------------------------------ phase 11

FRACTION_IMPUTED = 0.05  # (b): the share of dosages replaced by imputed (fractional) ones
CLI_N, CLI_P, CLI_GEN = 2_000, 8_192, 500  # (c): the CLI's data; its pedigree 4 generations of 500
# (c): 200 kept draws a chain, so that `diag`'s R-hat < 1.05 rests on more than
# chance: over 2 x 50 draws varE's R-hat read 0.98-1.06 between seeds at V = 1
# and at V = 2 alike (ESS 16-74)
CLI_CHAIN = dict(length=1_000, burnin=200, thin=4, seed=3, chains=2)
ST_PACKED_RULE = 3  # (a): sweeps of the int8 and packed chains held by the packed rule


def plink_write(geno, prefix):
    """geno (n, p) int8 dosages in {0, 1, 2} on the card -> a PLINK v1.0
    SNP-major fileset `prefix`.bed/.bim/.fam (A1-allele dosages: 2 -> 00,
    1 -> 10, 0 -> 11), the .bed encoded on the card."""
    n, p = geno.shape
    bps = (n + 3) // 4
    codes = torch.zeros((4 * bps, p), dtype=torch.uint8, device=geno.device)
    codes[:n] = torch.where(geno == 2, 0, torch.where(geno == 1, 2, 3)).to(torch.uint8)
    f = codes.view(bps, 4, p)
    body = (f[:, 0] | (f[:, 1] << 2) | (f[:, 2] << 4) | (f[:, 3] << 6)).t().contiguous()
    with open(f"{prefix}.bed", "wb") as fh:
        fh.write(bytes([0x6C, 0x1B, 0x01]))
        fh.write(body.cpu().numpy().tobytes())
    Path(f"{prefix}.bim").write_text("".join(f"{1 + j * 10 // p}\trs{j}\t0\t{j}\tA\tG\n" for j in range(p)))
    Path(f"{prefix}.fam").write_text("".join(f"F{i} I{i} 0 0 0 -9\n" for i in range(n)))


def storage_path(tag, spec, sig, pack, scan, n_gathers, n_window=20):
    """One marker path at V=96 on the storage `pack` gives (pack2=False:
    int8; None: what the data allow, through run_lmem), 100 sweeps from one
    KeyedStream: eager (a loop of make_sweep; launches counted) and replayed
    (run_lmem under pack2=None, else scan_chain, the runner run_lmem drives,
    on assemble(pack2=False)): the same bits. Checks the launches (K1 and K2
    none on unpacked storage), drift, finite draws and the EBV limit of
    BayesR; prints the peak memory of each arm, steady ms/sweep of both, the
    replays' busy time, nodes and idle share. Returns (eager launches, the
    numbers, the state after ST_PACKED_RULE sweeps, the replayed result's
    plan, state and posterior-mean beta)."""
    ph = f"11 {tag}"
    n_keep = (N_CHAIN - N_BURN) // N_THIN
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan, st0 = ngt.assemble(spec, vshards=V_MAIN, pack2=pack)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    mp, ms0 = plan.markers[0], st0.markers[0]
    unpacked = ms0.mt.dtype != torch.uint8
    T = mp.n_blocks // V_MAIN
    stream = keyed.KeyedStream(7, DEV, plan.dtype)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    st, kept, early = st0, [], None
    t0 = time.perf_counter()
    for i in range(1, N_CHAIN + 1):
        st = sweep(st, stream)
        if i == ST_PACKED_RULE:
            early = (st.markers[0].beta.clone(), st.ycorr.clone())
        if i > N_BURN and (i - N_BURN) % N_THIN == 0:
            kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    eager_peak = torch.cuda.max_memory_allocated() - base
    expect = {k: 0 for k in launches}
    expect.update({scan: N_CHAIN * T, "keyed_rng": launches["keyed_rng"]})
    if not unpacked:
        expect.update({"pack2_matvec": n_gathers * N_CHAIN * T, "pack2_rank_update": N_CHAIN * T})
    check(launches == expect and launches["keyed_rng"] > 0, f"{tag}: eager launches {launches}, "
          f"expected {expect}")
    eager = {k: torch.stack([x[k] for x in kept]).cpu().numpy() for k in kept[0]}
    del st0, kept

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if pack is None:
        res = ngt.run_lmem(spec, n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, out_folder=None,
                           vshards=V_MAIN, stream=stream)
        rplan, rst, draws = res.plan, res.state, res.draws
    else:
        rplan, rst0 = ngt.assemble(spec, vshards=V_MAIN, pack2=pack)
        rst, rdraws = engine_sweep.scan_chain(rplan, rst0, stream, N_BURN, n_keep, N_THIN)
        draws = {k: v.cpu().numpy() for k, v in rdraws.items()}
        del rst0
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated() - base
    check(rplan.markers[0].packed == (not unpacked), f"{tag}: the replayed arm's storage differs")
    differ = [k for k in eager if not np.array_equal(eager[k], draws[k])]
    check(set(draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(rst.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    fit = fit_checks(f"{tag} V={V_MAIN}", rplan, rst, {k: torch.from_numpy(v) for k, v in draws.items()},
                     sig, EBV_LIMITS.get((tag.split()[0], V_MAIN)) if tag.startswith("BayesR") else None,
                     phase="11")
    rep = engine_sweep.ReplayedSweep(rplan, rst, stream)
    state = [rst]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, n_window)
    ms_replay = steady_ms(lambda: rep.run(1), n_window)
    busy, per_sweep, missed, by_name, ms_by = replay_window(rep, 10)
    idle = 1.0 - busy / ms_replay
    storage = str(ms0.mt.dtype).removeprefix("torch.") + ("" if unpacked else " (2-bit packed)")
    print(f"[{ph}] storage {storage}, mt {tuple(ms0.mt.shape)}, {mp.dosage_bytes} bytes a dosage; "
          f"assemble {assemble_s:.2f} s; eager {N_CHAIN} sweeps {N_CHAIN / eager_s:.2f} sweeps/s, launches "
          f"{({k: v for k, v in launches.items() if v})}; replayed ({'run_lmem' if pack is None else 'scan_chain'}) "
          f"the same bits; peak memory above the data before it: eager {eager_peak / 2**30:.3f} GiB, "
          f"replayed {replay_peak / 2**30:.3f} GiB; steady, {n_window} sweeps between CUDA events: "
          f"eager {ms_eager:.4f} ms/sweep, replayed {ms_replay:.4f}; 10 replays under the profiler: busy "
          f"{busy:.4f} ms/sweep, {per_sweep} kernels and copies a sweep ({missed} records missed); idle "
          f"share {idle:.4f}")
    for key, cnt in sorted(ms_by.items(), key=lambda r: -r[1])[:6]:
        print(f"  replayed {ms_by[key]:.4f} ms/sweep in x{by_name[key]:<4} {key[:90]}")
    beta = draws["betaM1"].mean(0)
    del rep, state
    return launches, dict(storage=storage, assemble_s=assemble_s, eager_sweeps_per_s=N_CHAIN / eager_s,
                          eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay,
                          replay_busy_ms_per_sweep=busy, replay_kernels_per_sweep=per_sweep,
                          idle_share=idle, eager_peak_gib=eager_peak / 2**30,
                          replay_peak_gib=replay_peak / 2**30, **fit), early, (rplan, rst, beta)


def packed_rule(tag, a, b, phase="11"):
    """bench.py:338-359's rule for two chains of one stream: corr of beta
    and of ycorr > 0.999 and max |dycorr| / max |ycorr| < 0.05."""
    (ba, ya), (bb, yb) = a, b
    cb, cy = corr(ba, bb), corr(ya, yb)
    dy = ((ya - yb).abs().max() / yb.abs().max()).item()
    print(f"[{phase} {tag}] after {ST_PACKED_RULE} sweeps of one KeyedStream: corr(beta) {cb:.6f}, "
          f"corr(ycorr) {cy:.6f}, max|dycorr|/scale {dy:.3e} (the packed rule: > 0.999, > 0.999, < 0.05)")
    check(cb > 0.999 and cy > 0.999 and dy < 0.05, f"{tag}: the chains part by the packed rule")
    return dict(corr_beta=cb, corr_ycorr=cy, dycorr=dy)


def route_phase(plan, st):
    """One V=96 step of int8 rows (step 0: 24,576 x 10,000): the port's
    product route (a cast to float32 and torch.matmul for the gather and the
    scatter, TF32 off) beside the ladder's S2a/S2b (`micro.dense_gather` /
    `dense_scatter`, hand-written int8 passes) on the same rows, each held
    to the route's output and timed on the card alone."""
    T, V, B, n = st.markers[0].mt.shape
    rows = st.markers[0].mt[0].reshape(V * B, n)
    g = torch.Generator(device=DEV).manual_seed(5)
    y = torch.randn(n, generator=g, device=DEV)
    u = torch.randn(V * B, generator=g, device=DEV) * 1e-2
    with full_f32():
        dense = rows.to(torch.float32)
        r0, dy = dense @ y, u @ dense
    for name, out, ref in (("S2a gather", mk.dense_gather(rows, y), r0),
                           ("S2b scatter", mk.dense_scatter(rows, u), dy)):
        err, scale = rel_err(out, ref)
        check(err < TOL_PASS * scale, f"11 route: {name} {err / scale:.3e} of scale from the product")

    def cast():
        return rows.to(torch.float32)

    def gather():
        with full_f32():
            return dense @ y

    def scatter():
        with full_f32():
            return u @ dense

    def step():
        with full_f32():
            d = rows.to(torch.float32)
            return d @ y, u @ d

    reps = 20
    ms = {"cast": device_ms(cast, reps, 0), "product gather": device_ms(gather, reps, 0),
          "product scatter": device_ms(scatter, reps, 0), "product step (cast, both)": device_ms(step, reps, 0),
          "S2a dense_gather": device_ms(lambda: mk.dense_gather(rows, y), reps),
          "S2b dense_scatter": device_ms(lambda: mk.dense_scatter(rows, u), reps)}
    int8_bound = (rows.numel() + 4 * (n + V * B)) / HBM_BYTES_PER_S * 1e3
    f32_bound = (4 * rows.numel() + 4 * (n + V * B)) / HBM_BYTES_PER_S * 1e3
    print(f"[11 route] one V={V} step of int8 rows ({V * B:,} x {n:,}), ms on the card alone: "
          + ", ".join(f"{k} {'n/a' if v is None else f'{v:.4f}'}" for k, v in ms.items())
          + f"; a pass's bound by bytes {int8_bound:.4f} (int8 rows), {f32_bound:.4f} (the cast rows)")
    return dict(device_ms=ms, int8_bound_ms=int8_bound, f32_bound_ms=f32_bound)


def imputed(geno, bt, seed=23, chunk=8192):
    """simulate_panel's dosages with FRACTION_IMPUTED of the entries
    replaced by fractional dosages uniform in [0, 2], as float32 on the
    card, and y from the same effects and N(0, 1) noise. Returns (panel,
    y on the host, planted signal)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    gf = geno.to(torch.float32)
    for i in range(0, gf.shape[0], chunk):
        blk = gf[i:i + chunk]
        hit = torch.rand(blk.shape, generator=g, device=DEV) < FRACTION_IMPUTED
        blk[hit] = 2.0 * torch.rand(int(hit.sum()), generator=g, device=DEV)
    sig = torch.cat([gf[i:i + chunk] @ bt for i in range(0, gf.shape[0], chunk)])
    sig = sig - sig.mean()
    y = (sig + torch.randn(gf.shape[0], generator=g, device=DEV)).double().cpu().numpy()
    return gf, y, sig


def host_float(gf):
    """A float32 panel on the card as from_float_array's float64 host array."""
    return gf.cpu().numpy().astype(np.float64)


def multibreed_float():
    """Two imputed panels of one set of loci (the effects of simulate_corr:
    500 expected causal loci, correlated 0.5 between the sets) through
    from_float_array, under BayesPR with a 2 x 2 v and regions of REGION_CM
    loci. Returns the spec."""
    g = torch.Generator(device=DEV).manual_seed(21)
    genos = [torch.randint(0, 3, (N, P), generator=g, device=DEV, dtype=torch.int8) for _ in range(2)]
    causal = torch.rand(P, generator=g, device=DEV) < 500.0 / P
    e1, e2 = (torch.randn(P, generator=g, device=DEV) for _ in range(2))
    bts = [torch.where(causal, e1 * 0.1, 0.0), torch.where(causal, (0.5 * e1 + 0.75 ** 0.5 * e2) * 0.1, 0.0)]
    panels = [imputed(gt, bt, seed=30 + i) for i, (gt, bt) in enumerate(zip(genos, bts))]
    del genos
    sig = sum(s for _, _, s in panels)
    y = (sig + torch.randn(N, generator=g, device=DEV)).double().cpu().numpy()
    chr_ids = np.ones(P, np.int64)
    datas = tuple(ngt.from_float_array(host_float(gf), chr_ids=chr_ids) for gf, _, _ in panels)
    del panels
    return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))], block_size=BLOCK,
                         corr_markers=[ngt.CorrMarkerTerm(("M1", "M2"), datas, ngt.BayesPR(REGION_CM, V_CM))])


def multibreed_float_checks(res):
    """The float MultiBreed run's storage and expected launches (V=1: T =
    192 block-steps, CM1 each, no K1 or K2)."""
    cs, cp = res.state.corr_markers[0], res.plan.corr_markers[0]
    check(cs.mt.dtype == torch.float32 and cp.dosage_bytes == 4 and cp.vshards == 1,
          f"11 MultiBreed: storage {cs.mt.dtype}, V = {cp.vshards}")
    T = cp.n_blocks
    return {"corr_block_scan_v": N_CHAIN_CM * T, "corr_rule": N_CHAIN_CM}


def cli_data(root):
    """A CLI analysis in `root`: a CLI_N x CLI_P text genotype file (a
    digit and a space a dosage), a pedigree of 4 generations of CLI_GEN
    animals (simulate_pedigree's), a phenotype CSV over every animal in
    pedigree order (an intercept, a covariate x, the planted polygenic
    values, 200 causal loci and N(0, 1) noise) and the config: y ~ 1 + x +
    PED(ID) + SNP(M) under BayesR, two chains on KeyedStreams, with
    vshards "auto" (run.json, out/) and 1 (run_v1.json, out_v1/). Returns
    the two configs' paths and the planted genomic values."""
    rng = np.random.default_rng(40)
    ped, u = simulate_pedigree(4, CLI_GEN, 41)
    lbl = [f"A{i + 1}" for i in range(ped.n)]
    Path(f"{root}/ped.txt").write_text("".join(
        f"{lbl[i]} {lbl[ped.sire[i]] if ped.sire[i] >= 0 else 0} {lbl[ped.dam[i]] if ped.dam[i] >= 0 else 0}\n"
        for i in range(ped.n)))
    g = rng.integers(0, 3, (CLI_N, CLI_P)).astype(np.uint8)
    text = np.full((CLI_N, 2 * CLI_P), ord(" "), np.uint8)
    text[:, 0::2] = g + ord("0")
    text[:, -1] = ord("\n")
    text.tofile(f"{root}/geno.txt")
    bt = np.where(rng.random(CLI_P) < 200 / CLI_P, rng.normal(0, 0.1, CLI_P), 0.0)
    x = rng.normal(0, 1, CLI_N)
    y = 1.0 + 0.3 * x + u * np.sqrt(0.3) + (g - g.mean(0)) @ bt + rng.normal(0, 1, CLI_N)
    Path(f"{root}/pheno.csv").write_text("ID,x,y\n" + "".join(
        f"{lbl[i]},{float(x[i])!r},{float(y[i])!r}\n" for i in range(CLI_N)))
    cfg = {"formula": "y ~ 1 + x + PED(ID) + SNP(M)", "data": "pheno.csv", "pedigree": "ped.txt",
           "genotypes": {"M": "geno.txt"},
           "priors": {"M": {"type": "BayesR", **{k.rstrip("_"): v for k, v in PRIOR_R.items()}},
                      "ID": {"type": "Random", "str": "A", "v": 0.3}},
           "chain": CLI_CHAIN, "block_size": BLOCK, "out_folder": "out"}
    Path(f"{root}/run.json").write_text(json.dumps(cfg))
    Path(f"{root}/run_v1.json").write_text(json.dumps({**cfg, "vshards": 1, "out_folder": "out_v1"}))
    return f"{root}/run.json", f"{root}/run_v1.json", (g - g.mean(0)) @ bt


def cli_main(*argv):
    """`python -m nextgp_tpu_torch ARGV` in this process (runpy runs the
    package's __main__ as -m does), so that the wrappers' launch counters
    can be read. Returns (exit code, seconds)."""
    import runpy

    saved = sys.argv
    sys.argv = ["nextgp_tpu_torch", *argv]
    t0 = time.perf_counter()
    try:
        runpy.run_module("nextgp_tpu_torch", run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as stop:
        code = stop.code if isinstance(stop.code, int) else (0 if stop.code is None else 1)
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    return code, time.perf_counter() - t0


def cli_phase(root):
    """11c: the command line on the card: `run` (two chains, KeyedStream,
    replayed), `diag`, `summary`, `predict` and `roofline` on a generated
    config, each returning 0; the output files; the launches of `run` (K1,
    K3 and K2 alike, T = nb / V block-steps a captured sweep at the V that
    "auto" gives the set on this card; RE1, R1); `summary` also through a
    child `python -m`. Then `run` with vshards 1: the "auto" chains'
    posterior-mean varE and chain 1's EBV correlation (`predict`) held to
    phase 15's gate against it."""
    from nextgp_tpu_torch.engine import plan as engine_plan
    from nextgp_tpu_torch.io.summary import summary_mcmc

    nb = CLI_P // BLOCK
    V = engine_plan._card_vshards(nb, BLOCK, CLI_N, "BayesR")
    cfg, cfg_v1, tbv = cli_data(root)
    out = f"{root}/out"
    t0 = time.perf_counter()
    md = ngt.read_genotype_file(f"{root}/geno.txt")
    parse_s = time.perf_counter() - t0
    check(md.genotypes.shape == (CLI_N, CLI_P) and md.genotypes.dtype == np.int8, "11c: the text panel")
    _cuda.reset_launches()
    rc, run_s = cli_main("run", cfg, "--quiet")
    launches = dict(_cuda.LAUNCHES)
    check(rc == 0, f"11c: run returned {rc}")
    for name in ("r_block_scan_v", "level_scan", "keyed_rng"):
        check(launches[name] > 0, f"11c: run launched no {name}: {launches}")
    steps = launches["r_block_scan_v"]
    check(steps % (nb // V) == 0 and launches["pack2_matvec"] == launches["pack2_rank_update"] == steps,
          f"11c: run's launches {launches} are not whole sweeps of {nb // V} block-steps (V={V})")
    chains = [f"{out}/chain{c + 1}" for c in range(CLI_CHAIN["chains"])]
    for folder in chains:
        for f in ("varEOut", "betaMOut", "uIDOut", "varUIDOut", "piMOut"):
            check(os.path.getsize(f"{folder}/{f}") > 0, f"11c: {folder}/{f} is missing or empty")
    secs = {"parse": parse_s, "run": run_s}
    for cmd, argv in (("diag", ("diag", "varE", "--out-folder", out)),
                      ("summary", ("summary", "varE", "--out-folder", chains[0])),
                      ("predict", ("predict", cfg, "--set", "M", "--out-folder", chains[0],
                                   "--output", f"{root}/ebv.txt")),
                      ("roofline", ("roofline", cfg))):
        rc, secs[cmd] = cli_main(*argv)
        check(rc == 0, f"11c: {cmd} returned {rc}")
    ebv = np.loadtxt(f"{root}/ebv.txt")
    check(ebv.shape == (CLI_N,) and np.isfinite(ebv).all(), "11c: predict's genomic values")
    rc, secs["run V=1"] = cli_main("run", cfg_v1, "--quiet")
    check(rc == 0, f"11c: run with vshards 1 returned {rc}")
    rc, _ = cli_main("predict", cfg_v1, "--set", "M", "--out-folder", f"{root}/out_v1/chain1",
                     "--output", f"{root}/ebv_v1.txt")
    check(rc == 0, f"11c: predict on the vshards 1 chain returned {rc}")
    fit = {}
    for label, folder, ebv_file in (("auto", out, "ebv.txt"), ("V=1", f"{root}/out_v1", "ebv_v1.txt")):
        var_e = np.mean([summary_mcmc("varE", f"{folder}/chain{c + 1}")[0] for c in range(CLI_CHAIN["chains"])])
        fit[label] = (float(var_e), float(np.corrcoef(np.loadtxt(f"{root}/{ebv_file}"), tbv)[0, 1]))
    (e, c), (e1, c1) = fit["auto"], fit["V=1"]
    print(f"[11c CLI] the \"auto\" chains at V={V}: posterior-mean varE {e:.4f}, chain 1's EBV correlation with "
          f"the planted values {c:.4f}; at V=1 {e1:.4f}, {c1:.4f} (the gate: varE within {GATE_VAR_E:.0%}, EBV at "
          f"least V=1's - {GATE_EBV})")
    check(abs(e - e1) <= GATE_VAR_E * e1 and c >= c1 - GATE_EBV,
          f"11c: the \"auto\" chains at V={V} fall outside the gate against V=1: {fit}")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "nextgp_tpu_torch", "summary", "varUID", "--out-folder",
                            chains[0]], capture_output=True, text=True, timeout=300, env=env)
    secs["summary (python -m)"] = time.perf_counter() - t0
    check(child.returncode == 0 and np.isfinite(float(child.stdout.split()[-1])),
          f"11c: python -m nextgp_tpu_torch summary: {child.returncode} {child.stderr[-300:]}")
    print(f"[11c CLI] {CLI_N:,} x {CLI_P:,} text panel parsed in {parse_s:.2f} s (host); `run` (2 chains of "
          f"{CLI_CHAIN['length']} sweeps, KeyedStream, replayed, V={V} by \"auto\") {run_s:.2f} s with its "
          f"parse, pedigree and A^-1; launches counted at capture {({k: v for k, v in launches.items() if v})}; "
          f"diag, summary, predict and roofline returned 0; seconds {({k: round(v, 3) for k, v in secs.items()})}")
    return dict(seconds=secs), launches


def storage_phase():
    """11: unpacked marker storage at full width (ROADMAP M7c) and the
    command line (M12). (a) int8: the 10k x 49,152 panel written as a PLINK
    fileset and read back (timed), BayesR (estimatePi, V=96) on int8 rows
    (pack2=False) and on the packed rows pack2=None gives the same data,
    their first sweeps held by the packed rule, BayesC+D on int8 rows, and
    one step's product route beside S2a/S2b; (b) float: the panel with 5 %
    imputed dosages through from_float_array, BayesR at V=96, MultiBreed on
    two such panels at V=1 ("auto"), serving on the float storage; (c) the
    CLI. Returns the numbers and the launch counts by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ngt_storage_")
    out, counted = {}, {}
    try:
        geno, bt, y, sig, _ = simulate_panel()
        t1 = time.perf_counter()
        plink_write(geno, f"{root}/panel")
        write_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        md = ngt.read_plink(f"{root}/panel")
        read_s = time.perf_counter() - t1
        check(np.array_equal(md.genotypes, geno.cpu().numpy()), "11a: read_plink's dosages differ")
        bed = os.path.getsize(f"{root}/panel.bed")
        print(f"[11a PLINK] {N:,} x {P:,} written in {write_s:.2f} s ({bed:,} bytes of .bed), read_plink "
              f"{read_s:.2f} s (host numpy decode), the dosages equal")
        out["plink"] = dict(write_s=write_s, read_s=read_s, bed_bytes=bed)

        def spec(data, path="BayesR", yy=y):
            prior, weighted = PATHS[path][:2]
            w = np.random.default_rng(3).uniform(0.5, 2.0, N) if weighted else None
            return ngt.ModelSpec(y=yy, fixed=[ngt.FixedTerm("int", np.ones(N))],
                                 markers=[ngt.MarkerTerm("M1", data, prior)],
                                 residual=None if w is None else ngt.RandomEffect(w, 1.0), block_size=BLOCK)

        counted["storage BayesR int8"], out["BayesR int8"], early8, _ = storage_path(
            "BayesR int8", spec(md), sig, False, "r_block_scan_v", 1)
        counted["storage BayesR packed"], out["BayesR packed"], early_pk, _ = storage_path(
            "BayesR packed", spec(md), sig, None, "r_block_scan_v", 1)
        out["packed rule"] = packed_rule("BayesR int8 / packed", early8, early_pk)
        counted["storage BayesC+D int8"], out["BayesC+D int8"], _, _ = storage_path(
            "BayesC+D int8", spec(md, "BayesC+D"), sig, False, "bc_block_scan_wv", 2)
        plan, st = ngt.assemble(spec(md), vshards=V_MAIN, pack2=False)
        out["route"] = route_phase(plan, st)
        del plan, st, md

        gf, yf, sig_f = imputed(geno, bt)
        del geno
        t1 = time.perf_counter()
        mdf = ngt.from_float_array(host_float(gf))
        float_s = time.perf_counter() - t1
        del gf
        counted["storage BayesR float"], out["BayesR float"], _, (fplan, fst, beta) = storage_path(
            "BayesR float", spec(mdf, yy=yf), sig_f, None, "r_block_scan_v", 1)
        out["BayesR float"]["from_float_array_s"] = float_s
        t1 = time.perf_counter()
        host = ngt.genomic_values(mdf, beta)
        host_s = time.perf_counter() - t1
        card = ngt.genomic_values_state(fplan, fst, beta=beta)
        err = np.abs(card.double().cpu().numpy() - host).max() / np.abs(host).max()
        check(err < TOL_SERVE, f"11b: genomic_values_state {err:.3e} of scale from genomic_values")
        print(f"[11b serving] float storage: genomic_values_state (a float32 product on the card) within "
              f"{err:.3e} of scale of genomic_values (host f64, {host_s:.2f} s; limit {TOL_SERVE})")
        out["serving float"] = dict(serve_err=err, genomic_values_host_s=host_s)
        del fplan, fst, mdf

        launches, _, out["MultiBreed float V=1"] = corr_path(
            "MultiBreed float V=1", multibreed_float(), "auto", multibreed_float_checks, phase="11")
        counted["storage MultiBreed float V=1"] = launches
        out["CLI"], counted["storage CLI"] = cli_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[11 storage] every check passed in {out['seconds']:.1f} s")
    return out, counted


def storage_only(card):
    """`python3 chip_smoke.py storage`: phase 11 alone. One JSON line of its
    numbers and launch counts, and no result line."""
    out, counted = storage_phase()
    print(json.dumps({"card": card, "storage": out, "launches": counted}))


# ------------------------------------------------------------------ phase 12

GRN_LADDER = ((10, 20, 2_000), (30, 60, 5_000), (100, 200, 10_000))  # scripts/bench_grn.py's (G, S, N)
GRN_WIDE = (100, 1_000, 10_000)  # (b)'s wide chain: 1,000 SNPs, the top of the users' range (PERF.md §1)
GRN_WIDTHS = (GRN_LADDER[-1], GRN_WIDE)
# (a): GRN1 timed at bench_grn's shapes (the Gram of that shape's panel) and at 1,000-3,000 SNPs
# (10,000 individuals)
GRN_TIMED = tuple((G, S, N) for G, S, N in GRN_LADDER) + tuple((100, S, 10_000) for S in (1_000, 2_000, 3_000))
GRN_EDGES = tuple((G, S) for S in (1, 31, 32, 33, 63, 64, 65, 2000, 3000) for G in (1, 3, 100))
GRN_LIMIT_G = 3  # GRN1 at its shared-memory limit and one past it (its d's in scratch) for this many genes
TOL_GRN = {torch.float32: 1e-4, torch.float64: 1e-10}  # GRN1 against its plain version, of d's scale
GRN_ROUND = 4  # SNPs a chain round of GRN1 (kRound in csrc/grn_scan.cu)
GRN_CHAIN_OPS = 5  # dependent operations a round: the shuffle of its w's, the three multiply-adds
#                    that finish its d's one from the next, and the one that adds its last d into
#                    the next round's w's
GRN_ITERS, GRN_BURN = 300, 100  # (b): iterations of the float32 chains, and the ones not averaged
GRN_F64_ITERS = 20  # (b): iterations of the float64 chains, GRN1's and the plain scan's
GRN_TOL_CHAIN = 1e-9  # (b): the float64 GRN1 chain against the float64 plain chain, relative
GRN_VAR_E = 0.25  # bench_grn's noise sd 0.5
GRN_EST = dict(chain_length=60, burn_in=20, output_freq=10)  # (c): 4 kept rows
GRN_FILES = ("Lambda1", "varLambda1", "Lambda2", "varBeta", "varE", "means")
F64_FLOP_PER_S = 34e12  # the H100 SXM data sheet's float64 rate outside the tensor cores
# GRN1's ablation builds (`grn` mode): scratch copies of this tree's csrc/grn_scan.cu
# (start_build's patches): whole; without the far sums (the far-sum warps skip their
# tiles) or the chain (the chain warp skips its 32 steps), for the split; the chain one
# SNP a shuffle (not four), or the far sums' tiles read one ahead or three (two in
# float64; not two, one). A patch that no longer matches fails the run.
GRN_ABLATIONS = (
    ("whole", ()),
    ("no far sums", (("for (int k = wk; k < i; k += kWorkers)", "for (int k = wk; k < 0; k += kWorkers)"),)),
    ("no chain", (("for (int s0 = 0; s0 < kT; s0 += kRound) {", "for (int s0 = 0; s0 < 0; s0 += kRound) {"),)),
    ("1 SNP a round", (("constexpr int kRound = 4;", "constexpr int kRound = 1;"),)),
    ("1 tile ahead", (("kAhead = sizeof(T) == 4 ? 2 : 1;", "kAhead = 1;"),)),
    ("3 tiles ahead", (("kAhead = sizeof(T) == 4 ? 2 : 1;", "kAhead = sizeof(T) == 4 ? 3 : 2;"),)),
)
GRN_ABL_SHAPES = {torch.float32: ((10, 200), (100, 200), (10, 1_000), (100, 1_000), (100, 2_000), (100, 3_000)),
                  torch.float64: ((100, 200), (100, 1_000), (100, 2_000))}


def grn_data(G, S, N, seed=1):
    """scripts/bench_grn.py's generator (copied: that script imports jax):
    dosages uniform in {0, 1, 2}, the planted Lambda1 on the subdiagonal
    (+-0.3 by turns), a sparse Lambda2 (10 % of entries, sd 0.3), gene
    means sd 1, noise sd 0.5. Returns (x, y, lam1, lam2) in numpy."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (S, N)).astype(np.float64)
    l1 = np.zeros((G, G))
    for g in range(1, G):
        l1[g, g - 1] = 0.3 * (1 if g % 2 else -1)
    l2 = rng.normal(0, 0.3, (G, S)) * (rng.uniform(size=(G, S)) < 0.1)
    mu = rng.normal(0, 1, G)
    e = rng.normal(0, 0.5, (G, N))
    xc = x - x.mean(axis=1, keepdims=True)
    y = np.linalg.solve(np.eye(G) - l1, mu[:, None] + l2 @ xc + e)
    return x, y, l1, l2


def grn_inputs(G, S, dtype, n=2000, zero_snp=None, xc=None):
    """GRN1's inputs: the Gram of S centred dosage rows of n individuals (xc
    where given; a row constant where zero_snp names it), r0 at the scale
    x'ycorr has, normal z and bold, var_e 0.25; seeded by (G, S)."""
    g = torch.Generator(device=DEV).manual_seed(1000 * G + S)
    if xc is None:
        x = torch.randint(0, 3, (S, n), generator=g, device=DEV).double()
        if zero_snp is not None:
            x[zero_snp] = 1.0
        xc = x - x.mean(1, keepdim=True)
    gram = (xc @ xc.T).to(dtype)
    r0, z, bold = (torch.randn(G, S, generator=g, device=DEV, dtype=torch.float64).to(dtype) for _ in range(3))
    return gram.contiguous(), r0 * 20.0, z, bold * 0.05, torch.tensor(GRN_VAR_E, dtype=dtype, device=DEV)


def grn_panel_inputs(G, S, N, dtype):
    """grn_inputs on the Gram of bench_grn's panel of that shape."""
    x = torch.as_tensor(grn_data(G, S, N)[0], device=DEV)
    return grn_inputs(G, S, dtype, xc=x - x.mean(1, keepdim=True))


def grn_held(tag, args, dtype, layout=None):
    """GRN1 (on layout, or its own) against grn_scan_plain on args: d and
    bnew within TOL_GRN of scale, non-finite where the plain version's are,
    bnew = bold - d, the same bits twice. Returns (max_abs_err of d, its
    scale, d)."""
    bnew, d = grn_scan.grn_scan_kernel(*args, layout)
    rb, rd = grn_scan.grn_scan_plain(*args)
    errs = []
    for out, ref, what in ((d, rd, "d"), (bnew, rb, "bnew")):
        fin = torch.isfinite(ref)
        check(torch.equal(torch.isfinite(out), fin), f"grn_scan {tag}: {what} finite where the plain is not")
        e, sc = rel_err(out[fin], ref[fin]) if fin.any() else (0.0, 0.0)
        check(e <= TOL_GRN[dtype] * sc, f"grn_scan {tag}: {what} max_abs_err {e:.3e} of {sc:.3e}")
        errs.append((e, sc))
    b2, d2 = grn_scan.grn_scan_kernel(*args, layout)
    check(same_or_nan(bnew, args[3] - d) and same_or_nan(b2, bnew) and same_or_nan(d2, d),
          f"grn_scan {tag}: bnew is not bold - d, or two runs differ")
    return errs[0] + (d,)


def same_or_nan(a, b):
    """torch.equal, NaN taken as equal to NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all().item())


def grn_latency_ms(S, mhz):
    """GRN1's dependent-chain bound: ceil(S / GRN_ROUND) rounds of
    GRN_CHAIN_OPS dependent operations, each of at least 4 cycles, at mhz
    (the card's maximum SM clock: an idle card reports its resting
    clock)."""
    return -(-S // GRN_ROUND) * GRN_CHAIN_OPS * 4 / (mhz * 1e3)


_SASS = {}  # the built library -> its SASS by function


def library_sass():
    """The built library's SASS (cuobjdump, ~20 s, once a process), one
    string a function, its mangled name on the first line."""
    so = _cuda.build()
    if so not in _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        res = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
        _SASS[so] = re.split(r"\n\s*Function : ", res.stdout)[1:]
    return _SASS[so]


def grn_sass():
    """GRN1's SASS (cuobjdump of the built library), every instance (float32
    and float64, shared memory or scratch): no
    local-memory load or store (LDL, STL), no shared-memory load behind a
    predicate, and no read of SR_CgaCtaId inside a loop (between a branch
    and the earlier instruction it jumps back to)."""
    funcs = [f for f in library_sass() if "grn" in f.split("\n", 1)[0]]
    check(funcs, "no GRN1 function in the library's SASS")
    loops, bad = 0, {}
    for f in funcs:
        name, lines = f.split("\n", 1)[0].strip(), f.splitlines()
        local = [ln.strip() for ln in lines if re.search(r"\b(LDL|STL)\b", ln)]
        pred = [ln.strip() for ln in lines if re.search(r"@!?P\d+\s+LDS\b", ln)]
        where = {}  # a label or an address -> its line
        for i, ln in enumerate(lines):
            m = re.match(r"\s*(\.L_x_\d+):", ln) or re.search(r"/\*([0-9a-f]{4,})\*/", ln)
            if m:
                key = m.group(1)
                where.setdefault(key if key.startswith(".") else int(key, 16), i)
        cga = []
        for i, ln in enumerate(lines):
            m = re.search(r"\bBRA\b[^;]*?(?:`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b)", ln)
            target = None if m is None else where.get(m.group(1) or int(m.group(2), 16))
            if target is not None and target < i:
                loops += 1
                cga += [lines[j].strip() for j in range(target, i) if "SR_CgaCtaId" in lines[j]]
        if local or pred or cga:
            bad[name] = (local + pred + cga)[:4]
    check(not bad, f"GRN1's SASS: {bad}")
    print(f"[12 grn] SASS of {len(funcs)} GRN1 instances: no LDL/STL, no predicated LDS, no SR_CgaCtaId "
          f"read in any of their {loops} loops")
    return dict(functions=len(funcs), loops=loops)


def grn_lib_scan(lib, label):
    """(scan, calls) for another build of GRN1 (an ablation build, or another
    tree's csrc/grn_scan.cu) through that build's own C interface:
    scan(gram, r0, z, bold, var_e, layout) -> (bnew, d), on the layout where
    the build takes one (this tree's interface, with ngt_grn_scan_smem_snps),
    else on gram row-major (the interface before the layout, with
    ngt_grn_scan_scratch_words(G, S)); calls() counts the scans made."""
    takes_layout = hasattr(lib, "ngt_grn_scan_smem_snps")
    I, P = ctypes.c_longlong, ctypes.c_void_p
    if takes_layout:
        _cuda.bind_grn(lib)
    else:
        lib.ngt_grn_scan.argtypes, lib.ngt_grn_scan.restype = [P] * 8 + [I] * 3 + [P], ctypes.c_int
        lib.ngt_grn_scan_scratch_words.argtypes, lib.ngt_grn_scan_scratch_words.restype = [I, I], I
    calls = [0]

    def scan(gram, r0, z, bold, var_e, layout=None):
        G, S = r0.shape
        f64 = int(r0.dtype == torch.float64)
        if takes_layout:
            first = (grn_scan.grn_layout(gram) if layout is None else layout).buf
            words = grn_scan.scratch_words(G, S, lib.ngt_grn_scan_smem_snps(f64))
        else:
            first, words = gram, lib.ngt_grn_scan_scratch_words(G, S)
        scratch = torch.empty(words, dtype=r0.dtype, device=r0.device) if words else None
        bnew, d = torch.empty_like(r0), torch.empty_like(r0)
        _cuda.check(lib.ngt_grn_scan(first.data_ptr(), r0.data_ptr(), z.data_ptr(), bold.data_ptr(), var_e.data_ptr(),
                                     bnew.data_ptr(), d.data_ptr(), None if scratch is None else scratch.data_ptr(),
                                     G, S, f64, _cuda.stream_of(r0)), f"{label}: ngt_grn_scan")
        calls[0] += 1
        return bnew, d
    return scan, lambda: calls[0]


def graph_ms(fn, reps=20, rounds=5):
    """ms of one call of fn on the card: CUDA events around replays of a
    graph that captured reps calls back to back (the median of rounds
    replays), so no host time and a graph's launch between two calls.
    Late in a long process the profiler drops records, and device_ms then
    times nothing; this times every call."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def grn_arms(other, args, lay, dtype, name):
    """Another tree's GRN1 (P, grn_lib_scan) beside this tree's (C) on one
    case: P held to the plain version, then both timed (graph_ms) in turns
    P, C, C, P."""
    scan_p, _ = other
    e, sc = rel_err(scan_p(*args, lay)[1], grn_scan.grn_scan_plain(*args)[1])
    check(e <= TOL_GRN[args[0].dtype] * sc, f"{name}: the other tree's GRN1 is {e:.3e} off the plain version")
    rows = []
    for arm in "PCCP":
        fn = (lambda: scan_p(*args, lay)) if arm == "P" else (lambda: grn_scan.grn_scan_kernel(*args, lay))
        rows.append(dict(arm=arm, graph_ms=graph_ms(fn)))
    print(f"[12 grn] {name} in graph replays, arms P, C, C, P: "
          + ", ".join(f"{r['arm']} {r['graph_ms']:.6f}" for r in rows) + f" ms (P held to the plain version: {e:.3e})")
    return rows


def grn_kernel_phase(other=None):
    """12a: GRN1 against its plain version in float32 and float64, at
    GRN_TIMED (the Gram of bench_grn's panel of that shape) with times
    beside the bounds, the plain version and the library's triangular
    solve (and with other, another tree's GRN1, in turns P, C, C, P), the
    layout's time once a chain; at GRN_EDGES, either side of its
    shared-memory limit and with a monomorphic SNP; the SASS check."""
    out = {"sass": grn_sass()}
    lib = _cuda.lib()
    out["smem_snps"] = {"float32": lib.ngt_grn_scan_smem_snps(0), "float64": lib.ngt_grn_scan_smem_snps(1)}
    print(f"[12 grn] GRN1 keeps the d's in shared memory up to {out['smem_snps']['float32']:,} SNPs in float32 and "
          f"{out['smem_snps']['float64']:,} in float64, in scratch past it")
    mhz, mhz_max = sm_clocks_mhz()
    for dtype, tag in ((torch.float32, ""), (torch.float64, "_f64")):
        for G, S, N in GRN_TIMED:
            args = grn_panel_inputs(G, S, N, dtype)
            lay_ms = median_ms(lambda: grn_scan.grn_layout(args[0]), 3)
            lay = grn_scan.grn_layout(args[0])
            e, sc, _ = grn_held(f"{G} x {S}", args, dtype, lay)

            def kern():
                return grn_scan.grn_scan_kernel(*args, lay)

            def plain():
                return grn_scan.grn_scan_plain(*args)

            mat, rhs = grn_scan.grn_system(args[0], args[1], args[2], args[4])

            def library():
                return torch.linalg.solve_triangular(mat, rhs, upper=False)

            e_l, _ = rel_err(library().T, plain()[1])
            check(e_l <= TOL_GRN[dtype] * sc, f"grn_scan {G} x {S}: the library solve differs by {e_l:.3e}")
            work = diag.grn_work(G, S, torch.finfo(dtype).bits // 8)
            lat = grn_latency_ms(S, mhz_max)
            ms_k, ms_p, dev_ms = median_ms(kern, 20), median_ms(plain, 3), device_ms(kern, 20)
            lib_ms, lib_dev = median_ms(library, 20), device_ms(library, 20, records_per_launch=0)
            name = f"grn_scan_{G}x{S}{tag}"
            if (G, S, dtype) == (100, 200, torch.float32):
                name = "grn_scan"
            note = (f" (G = {G}, S = {S}, the Gram of bench_grn's {N:,}-individual panel, {dtype}; one launch, "
                    f"a block a gene; the layout made once a chain in {lay_ms:.4f} ms (event pair); the "
                    f"dependent-chain bound {lat:.6f} ms ({-(-S // GRN_ROUND)} rounds x {GRN_CHAIN_OPS} operations x 4 cycles at the "
                    f"{mhz_max:g} MHz maximum SM clock nvidia-smi reports, {mhz:g} before the phase); the "
                    f"library solve's max_abs_err {e_l:.3e}, its system built outside the timed window; not "
                    "a TPU kernel: the counterpart of the lax.scan of gene_scan)")
            if dtype == torch.float64:  # report's operations bound is the float32 rate
                note += f"; float64 operations bound {1e3 * work[1] / F64_FLOP_PER_S:.6f} ms at 34 TFLOP/s"
            report(name, e, sc, TOL_GRN[dtype], ms_k, ms_p, work[:2], note, library_ms=lib_ms,
                   phase="12 grn", dev_ms=dev_ms, library_dev_ms=lib_dev)
            TIMINGS[name].update(latency_bound_ms=lat, sm_clock_mhz=mhz, sm_clock_max_mhz=mhz_max,
                                 layout_ms=lay_ms, graph_ms=graph_ms(kern))
            print(f"[12 grn] {name}: {TIMINGS[name]['graph_ms']:.6f} ms a call in graph replays")
            if other is not None:
                TIMINGS[name]["arms"] = grn_arms(other, args, lay, dtype, name)
            out[name] = dict(TIMINGS[name])
            del mat, rhs, args, lay
        for G, S in GRN_EDGES:
            e, sc, _ = grn_held(f"{G} x {S} {dtype}", grn_inputs(G, S, dtype), dtype)
        print(f"[12 grn] {dtype}: held at (G, S) = {GRN_EDGES} (tol {TOL_GRN[dtype]:g} x scale), two launches "
              "bit-identical each")
        limit = out["smem_snps"][str(dtype).split(".")[1]]
        for S in (limit, limit + 1):
            args = grn_inputs(GRN_LIMIT_G, S, dtype, n=200)
            lay = grn_scan.grn_layout(args[0])
            d = grn_held(f"{GRN_LIMIT_G} x {S} {dtype}", args, dtype, lay)[2]
            one = [args[0]] + [t[-1:].contiguous() for t in args[1:4]] + [args[4]]
            check(torch.equal(grn_scan.grn_scan_kernel(*one, lay)[1][0], d[-1]),
                  f"grn_scan {GRN_LIMIT_G} x {S} {dtype}: the last gene differs from a call on it alone")
            del args, lay, one, d
        for S in (200, 2000, 3000):
            args = grn_inputs(3, S, dtype, zero_snp=S // 3)
            d = grn_scan.grn_scan_kernel(*args)[1]
            check(not torch.isfinite(d[:, S // 3:]).any().item() and torch.isfinite(d[:, :S // 3]).all().item(),
                  f"grn_scan at S = {S}: the monomorphic SNP is not where the draws stop being finite")
            grn_held(f"3 x {S} monomorphic {dtype}", args, dtype)
        print(f"[12 grn] {dtype}: at its shared-memory limit and one past it (G = {GRN_LIMIT_G}, S = {limit:,} "
              f"and {limit + 1:,}, the d's in scratch past it; the last gene the bits of a call on it alone), "
              "a monomorphic SNP at S = 200, 2,000 and 3,000 giving non-finite draws "
              "from it on, as the plain version does")
    return out


class GRNRun:
    """One GRN chain on the card from prepare_grn's state: its step, state,
    stream, the running sums of Lambda1 and Lambda2 after GRN_BURN and the
    varE draws."""

    def __init__(self, data, dtype, stream, replayed):
        x, y, _, _ = data
        G = y.shape[0]
        _, self.state0, self.step = tgrn.prepare_grn(x, y, G, start_lam1=np.full(G * G - G, 0.1), dtype=dtype,
                                                     device=DEV)
        self.chain = tgrn.GRNChain(self.step, self.state0, stream) if replayed else None
        self.state, self.stream, self.done = self.state0, stream, 0
        self.lam1 = self.lam2 = None
        self.var_e = []

    def run(self, n, keep=False):
        for _ in range(n):
            if self.chain is not None:
                self.chain.run(1)
                st = self.chain.state
            else:
                st = self.state = self.step(self.state, self.stream)
            self.done += 1
            if keep and self.done > GRN_BURN:
                lam1 = self.step.lam_matrix(st.lam1).double()
                self.lam1 = lam1 if self.lam1 is None else self.lam1 + lam1
                self.lam2 = st.lam2.double() if self.lam2 is None else self.lam2 + st.lam2
                self.var_e.append(st.var_e.clone())
        if self.chain is not None:
            self.state = self.chain.state


def grn_leaves_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in tgrn._TENSORS) and a.it == b.it


def grn_fit(run, data):
    """(finite, accept, corr(posterior-mean Lambda2, planted), corr(Lambda1,
    planted), mean varE) of a float32 run after GRN_ITERS iterations."""
    _, y, l1, l2 = data
    G, st, kept = y.shape[0], run.state, GRN_ITERS - GRN_BURN
    finite = all(torch.isfinite(getattr(st, f)).all().item() for f in ("mu", "lam1", "lam2", "var_lam1",
                                                                       "var_beta", "var_e", "ycorr"))
    off = ~torch.eye(G, dtype=torch.bool, device=DEV)
    return (finite, int(st.accept), corr(run.lam2.flatten() / kept, torch.as_tensor(l2, device=DEV).flatten()),
            corr((run.lam1 / kept)[off], torch.as_tensor(l1, device=DEV)[off]),
            torch.stack(run.var_e).double().mean().item())


@contextlib.contextmanager
def grn_scan_as(scan):
    """make_grn_step's steps call scan for GRN1 within the block."""
    saved = tgrn.grn_scan
    tgrn.grn_scan = scan
    try:
        yield
    finally:
        tgrn.grn_scan = saved


def grn_f32_chains(data, wide, other=None):
    """12b at one width: float32 eager and replayed from one KeyedStream (the
    same bits, accept count included), the posterior means against the
    planted matrices, varE, ms/iteration of both arms, busy, idle and nodes
    of a replayed step, GRN1's share. With other (another tree's GRN1), its
    replayed chain first, from the same stream (its limits printed, not
    held), then the replayed step with it (P) and with this tree's (C) in
    turns P, C, C, P."""
    _, y, _, l2 = data
    G, S, N = y.shape[0], l2.shape[1], y.shape[1]
    label = " wide" if wide else ""
    out, counted, arms = {}, {}, {}
    if other is not None:
        with grn_scan_as(other[0]):
            p = GRNRun(data, torch.float32, keyed.KeyedStream(12, DEV, torch.float32), True)
        p.run(GRN_ITERS, keep=True)
        fin, acc, c2, c1, ve = grn_fit(p, data)
        print(f"[12 grn] {G} x {S} x {N:,}, the other tree's GRN1 in the replayed chain, {GRN_ITERS} iterations: "
              f"finite {fin}, accept {acc}, corr(Lambda2, planted) {c2:.4f}, corr(Lambda1, planted) {c1:.4f}, "
              f"varE {ve:.5f} (printed)")
        out["other_chain"] = dict(finite=fin, accept=acc, lam2_corr=c2, lam1_corr=c1, var_e=ve)
    for arm, replayed in (("eager", False), ("replayed", True)):
        _cuda.reset_launches()
        run = GRNRun(data, torch.float32, keyed.KeyedStream(12, DEV, torch.float32), replayed)
        run.run(GRN_ITERS, keep=True)
        torch.cuda.synchronize()
        counted[f"GRN f32 {arm}{label}"] = dict(_cuda.LAUNCHES)
        arms[arm] = run
    e, r = arms["eager"], arms["replayed"]
    check(grn_leaves_equal(e.state, r.state) and torch.equal(e.lam2, r.lam2) and torch.equal(e.lam1, r.lam1),
          f"GRN f32 {G} x {S}: the replayed chain's bits differ from the eager chain's")
    finite, accept, lam2_corr, lam1_corr, var_e = grn_fit(r, data)
    print(f"[12 grn] {G} x {S} x {N:,}, float32, start_lam1 0.1, {GRN_ITERS} iterations eager and replayed from "
          f"one KeyedStream: the same bits; accept {accept}; corr(posterior-mean Lambda2, planted) {lam2_corr:.4f} "
          f"(limit 0.7); corr(Lambda1, planted) {lam1_corr:.4f} (printed); varE {var_e:.5f} (limits "
          f"{GRN_VAR_E / 2:g}-{GRN_VAR_E * 2:g}); launches a run: GRN1 {counted[f'GRN f32 eager{label}']['grn_scan']} "
          f"eager, {counted[f'GRN f32 replayed{label}']['grn_scan']} replayed (the warm step and the capture)")
    check(finite, f"GRN f32 {G} x {S}: the final state is not finite")
    check(accept > 0, f"GRN f32 {G} x {S}: no Metropolis-Hastings move accepted")
    check(lam2_corr >= 0.7, f"GRN f32 {G} x {S}: corr(Lambda2, planted) {lam2_corr:.4f} below 0.7")
    check(GRN_VAR_E / 2 <= var_e <= GRN_VAR_E * 2, f"GRN f32 {G} x {S}: varE {var_e:.5f} off the simulated "
                                                    f"{GRN_VAR_E}")
    ms_eager = steady_ms(lambda: e.run(1), 50)
    ms_replay = steady_ms(lambda: r.chain.run(1), 50)
    busy, nodes, missed, by_name, ms_by = replay_window(r.chain, 10)
    grn_ms = sum(v for k, v in ms_by.items() if "grn" in k)
    idle = 1.0 - busy / ms_replay
    top = sorted(ms_by.items(), key=lambda kv: -kv[1])[:6]
    print(f"[12 grn] {G} x {S}, float32 ms/iteration (CUDA events around 50): eager {ms_eager:.4f}, replayed "
          f"{ms_replay:.4f}; 10 replays under the profiler: device busy {busy:.4f} ms/iteration, {nodes} kernels "
          f"and copies a step ({missed} records missed), idle share without the profiler {idle:.4f}; GRN1 "
          f"{grn_ms:.4f} ms a step ({grn_ms / busy:.4f} of busy); the largest: "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    out.update(accept=accept, lam2_corr=lam2_corr, lam1_corr=lam1_corr, var_e=var_e,
               eager_ms_per_iteration=ms_eager, replayed_ms_per_iteration=ms_replay, busy_ms=busy, nodes=nodes,
               idle_share=idle, grn_scan_ms=grn_ms, grn_scan_share=grn_ms / busy, largest=dict(top))
    if other is not None:
        rows = []
        for arm in "PCCP":
            chain = p.chain if arm == "P" else r.chain
            ms = steady_ms(lambda: chain.run(1), 50)
            b, _, _, _, by = replay_window(chain, 10)
            rows.append(dict(arm=arm, replayed_ms_per_iteration=ms, busy_ms=b,
                             grn_scan_ms=sum(v for k, v in by.items() if "grn" in k)))
        print(f"[12 grn] {G} x {S}, the replayed step in turns P, C, C, P (ms/iteration, busy, GRN1's ms): "
              + "; ".join(f"{w['arm']} {w['replayed_ms_per_iteration']:.4f}, {w['busy_ms']:.4f}, "
                          f"{w['grn_scan_ms']:.4f}" for w in rows))
        out["arms"] = rows
    return out, counted


def grn_chain_phase(data_by_width, other=None):
    """12b: the float32 chains at GRN_WIDTHS (grn_f32_chains), then at
    bench_grn's width float64 with GRN1 against float64 with the plain scan
    on the card."""
    out, counted = {}, {}
    for (G, S, N), data in data_by_width.items():
        out[f"f32 {G}x{S}"], by_run = grn_f32_chains(data, (G, S, N) == GRN_WIDE, other)
        counted.update(by_run)
    runs = {}
    for arm in ("kernel", "plain"):
        _cuda.reset_launches()
        with grn_scan_as(tgrn.grn_scan if arm == "kernel" else
                         lambda gram, r0, z, bold, var_e, layout: grn_scan.grn_scan_plain(gram, r0, z, bold, var_e)):
            run = GRNRun(data_by_width[GRN_LADDER[-1]], torch.float64, keyed.KeyedStream(13, DEV, torch.float64),
                         False)
            run.run(GRN_F64_ITERS)
            torch.cuda.synchronize()
        counted[f"GRN f64 {arm}"] = dict(_cuda.LAUNCHES)
        runs[arm] = run.state
    k, p = runs["kernel"], runs["plain"]
    check(counted["GRN f64 kernel"]["grn_scan"] == GRN_F64_ITERS and counted["GRN f64 plain"]["grn_scan"] == 0,
          "GRN f64: GRN1 did not launch once an iteration in the kernel arm, or launched in the plain arm")
    worst = max(rel_err(getattr(k, f).double(), getattr(p, f).double())[0]
                / max(getattr(p, f).double().abs().max().item(), 1e-300)
                for f in ("mu", "lam1", "lam2", "var_lam1", "var_beta", "var_e", "ycorr"))
    print(f"[12 grn] float64, {GRN_F64_ITERS} iterations with GRN1 and with the plain scan on the card, one "
          f"KeyedStream: largest difference {worst:.3e} of a field's scale (limit {GRN_TOL_CHAIN:g}); accept "
          f"{int(k.accept)} and {int(p.accept)}")
    check(worst <= GRN_TOL_CHAIN and int(k.accept) == int(p.accept),
          "GRN f64: the GRN1 chain departs from the plain chain")
    out["f64"] = dict(largest_rel_diff=worst, accept=int(k.accept))
    return out, counted


def grn_out_rows(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        return header, np.array([[float(v) for v in ln.split("\t")] for ln in fh.read().splitlines()])


def grn_est_phase(data, root):
    """12c: est_grn on the same data with a KeyedStream (replayed), its six
    *Out files in a temporary folder: there, with the kept rows, equal to
    the draws; out_folder=None writes nothing."""
    x, y, _, _ = data
    G, S = y.shape[0], x.shape[0]
    folder = os.path.join(root, "grn_out")
    kw = dict(start_lam1=np.full(G * G - G, 0.1), device=DEV, dtype=torch.float32, **GRN_EST)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    acc, draws, st = ngt.est_grn(x, y, G, 2, out_folder=folder, stream=keyed.KeyedStream(14, DEV, torch.float32),
                                 **kw)
    sec = time.perf_counter() - t0
    counted = dict(_cuda.LAUNCHES)
    n_keep = (GRN_EST["chain_length"] - GRN_EST["burn_in"]) // GRN_EST["output_freq"]
    widths = dict(Lambda1=G * G, varLambda1=1, Lambda2=G * S, varBeta=G, varE=1, means=G)
    check(sorted(os.listdir(folder)) == sorted(f"{n}Out" for n in GRN_FILES), f"est_grn: files {os.listdir(folder)}")
    for n in GRN_FILES:
        header, rows = grn_out_rows(os.path.join(folder, f"{n}Out"))
        check(header == [f"{n}{i + 1}" for i in range(widths[n])] and rows.shape == (n_keep, widths[n])
              and draws[n].shape == rows.shape and np.array_equal(rows, draws[n].astype(np.float64)),
              f"est_grn: {n}Out does not hold the kept draws")
    empty = os.path.join(root, "empty")
    os.makedirs(empty)
    cwd = os.getcwd()
    os.chdir(empty)
    try:
        ngt.est_grn(x, y, G, 2, out_folder=None, stream=keyed.KeyedStream(14, DEV, torch.float32), **kw)
    finally:
        os.chdir(cwd)
    check(os.listdir(empty) == [], "est_grn with out_folder=None wrote files")
    check(counted["grn_scan"] > 0, "est_grn: GRN1 was not launched")
    print(f"[12 grn] est_grn ({GRN_EST['chain_length']} iterations, KeyedStream, replayed) in {sec:.2f} s: "
          f"accept {acc}; six *Out files of {n_keep} rows, equal to the draws; out_folder=None writes nothing; "
          f"launches {dict((k, v) for k, v in counted.items() if v)}")
    return dict(accept=acc, seconds=sec, kept=n_keep), counted


def grn_phase(other=None):
    """12: the GRN vertical (ROADMAP M13): GRN1 (12a), the chains at
    bench_grn's full width and at 1,000 SNPs (12b) and est_grn with its
    files (12c); with other (another tree's GRN1, grn_lib_scan), that GRN1
    beside this tree's. Returns the numbers and the launch counts by run."""
    t0 = time.perf_counter()
    out, counted = {}, {}
    t1 = time.perf_counter()
    out["kernel"] = grn_kernel_phase(other)
    parts = {"a": time.perf_counter() - t1}
    data = {shape: grn_data(*shape) for shape in GRN_WIDTHS}
    t1 = time.perf_counter()
    out["chain"], by_run = grn_chain_phase(data, other)
    counted.update(by_run)
    parts["b"] = time.perf_counter() - t1
    root = tempfile.mkdtemp(prefix="ngt_grn_")
    t1 = time.perf_counter()
    try:
        out["est_grn"], counted["GRN est_grn"] = grn_est_phase(data[GRN_LADDER[-1]], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parts["c"] = time.perf_counter() - t1
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    print(f"[12 grn] every check passed in {out['seconds']:.1f} s (by part: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in parts.items())})")
    return out, counted


def grn_ablations(libs):
    """GRN1's split (`grn` mode): each ablation build (GRN_ABLATIONS) timed
    (graph_ms) at GRN_ABL_SHAPES; the far sums' and the chain's parts are
    the whole build's time less the build's without them. The builds with
    one SNP a round or other tiles ahead give the whole build's bits."""
    out = {}
    for dtype, shapes in GRN_ABL_SHAPES.items():
        for G, S in shapes:
            args = grn_inputs(G, S, dtype)
            lay = grn_scan.grn_layout(args[0])
            ref = libs["whole"][0](*args, lay)[1]
            ms = {}
            for label, (scan, _) in libs.items():
                d = scan(*args, lay)[1]
                if label != "whole" and "no " not in label:
                    check(torch.equal(d, ref), f"GRN1 ablation {label} at {G} x {S}: not the whole build's bits")
                ms[label] = graph_ms(lambda: scan(*args, lay))
            split = {k: ms["whole"] - ms[k] for k in ("no far sums", "no chain")}
            key = f"{G}x{S}{'' if dtype == torch.float32 else '_f64'}"
            print(f"[12 grn ablations] {key}, ms a call in graph replays: "
                  + ", ".join(f"{k} {v:.6f}" for k, v in ms.items()) + "; the part each of the first two takes "
                  "out: " + ", ".join(f"{k[3:]} {v:.6f}" for k, v in split.items()))
            out[key] = dict(graph_ms=ms, split_ms=split)
            del args, lay
    return out


def grn_only(card, other_src=None):
    """`python3 chip_smoke.py grn [DIR]`: phase 12 alone, then GRN1's ablation
    builds (GRN_ABLATIONS); with DIR (another tree's csrc/, built alone with
    its own C interface), DIR's GRN1 beside this tree's in turns P, C, C, P
    at GRN_TIMED and in the replayed step at both widths. One JSON line of
    its numbers and launch counts, and no result line."""
    builds = [start_build(_cuda.CSRC, "grn_ablate", ["grn_scan.cu"], patches, label)
              for label, patches in GRN_ABLATIONS]
    if other_src is not None:
        builds.append(start_build(other_src, "grn_other", ["grn_scan.cu"]))
    libs = {label: grn_lib_scan(finish_build(label, so, proc, "grn"), label) for label, so, proc in builds}
    other = None if other_src is None else libs.pop(builds[-1][0])
    out, counted = grn_phase(other)
    out["ablations"] = grn_ablations(libs)
    print(json.dumps({"card": card, "grn": out, "launches": counted}))


# ------------------------------------------------------------------ phase 13

SHARD_SWEEPS = 20  # 13a-13c: eager sweeps of each sharded chain
SHARD_RULE = 3  # 13b, 13c: sweeps held to the single-rank chain by the packed rule
SHARD_SEED = 7
SHARD_CHAINS = dict(n_chain=30, n_burn=10, n_thin=2)  # 13b's run_chains: 10 kept a chain
CORR_SHARD = dict(n=2_000, p=8_192, V=8)  # 13c: phase 9's generator at a smaller depth
SHARD_TIMEOUT = 300  # seconds a group of ranks may take
SHARED_CARD = ("the ranks of 13b and 13c are processes time-sharing one card, and gloo stages each "
               "psum through the host: these times are no speed of a multi-GPU run")


def shard_route(ctx, t):
    """Which collective a rank's psum takes: its group's backend on t's device."""
    import torch.distributed as dist

    return f"{dist.get_backend(ctx.group)} all_reduce on {t.device.type} tensors ({ctx.n_shards} in the row)"


def psum_ms(ctx, t, reps=50):
    """ms of one psum of t over the row, on the host clock to the device
    finishing (every rank of the row runs it together)."""
    ctx.psum(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ctx.psum(t)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def psum_costs(ctx, st):
    """The psums a sweep makes, timed alone: one over the residual (a
    block-step's correction) and one over a scalar (a count)."""
    return dict(psum_ms_vector=psum_ms(ctx, st.ycorr), psum_ms_scalar=psum_ms(ctx, st.e.var_e.reshape(1)))


def sweeps_ms(step, state, stream, n):
    """(state after n sweeps of step, ms a sweep over the last n - 1: the
    first is left out, it allocates what later sweeps reuse)."""
    state = step(state, stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n - 1):
        state = step(state, stream)
    torch.cuda.synchronize()
    return state, 1e3 * (time.perf_counter() - t0) / (n - 1)


def rule_vs(tag, got, ref):
    """bench.py:338-359's packed rule between a sharded chain and the
    single-rank chain of the same stream after SHARD_RULE sweeps: corr of
    beta and of ycorr > 0.999, max |dycorr| / max |ycorr| < 0.05."""
    cb, cy = corr(got[0].reshape(-1), ref[0].reshape(-1)), corr(got[1], ref[1])
    dy = ((got[1] - ref[1]).abs().max() / ref[1].abs().max()).item()
    print(f"[13 {tag}] after {SHARD_RULE} sweeps of one stream against the single-rank chain: corr(beta) "
          f"{cb:.6f}, corr(ycorr) {cy:.6f}, max|dycorr|/scale {dy:.3e} (the packed rule: > 0.999, > 0.999, "
          "< 0.05)")
    check(cb > 0.999 and cy > 0.999 and dy < 0.05, f"{tag}: the sharded chain parts from the single-rank "
                                                   "chain by the packed rule")
    return dict(corr_beta=cb, corr_ycorr=cy, dycorr=dy)


def held_share(plan, loc, tag):
    """K1, K2 and K3 against their plain versions at a rank's share: its
    contiguous (T, V/S, B, q) rows and (T, B, V/S, B) Gram, step 0 of its
    own blocks with its real r0, as phase 3 holds them at the whole panel's
    shapes (the event-pair times beside the plain versions'; nothing timed on
    the card alone: the other ranks share it)."""
    ms, mp = loc.markers[0], plan.markers[0]
    T, V, B, q = ms.mt.shape
    rows, K, dt = V * B, mp.n_classes, loc.ycorr.dtype
    step = Step0(loc)
    gen = torch.Generator(device=DEV).manual_seed(5)
    y4 = pack2.y_planar(step.y)
    u = torch.randn(rows, generator=gen, dtype=dt, device=DEV) * 0.01
    t = T - 1  # the last of the rank's steps: a real offset into its rows
    sl = slice(t * rows, (t + 1) * rows)
    note = f" ({rows} x {q}: the rank's step {t} of {T}, V = {V} of the chain's {mp.vshards})"
    for name, kern, plain in (
            ("pack2_matvec", lambda: pack2.matvec_step(step.mt_rows, t, y4, rows),
             lambda: pack2.matvec_plain(step.mt_rows[sl], y4)),
            ("pack2_rank_update", lambda: pack2.rank_update_step(step.mt_rows, t, u),
             lambda: pack2.rank_update_plain(step.mt_rows[sl], u))):
        e, s = rel_err(kern(), plain())
        check(torch.equal(kern(), kern()), f"{name}{tag}: two runs differ")
        report(name + tag, e, s, TOL_PASS, median_ms(kern, 20), median_ms(plain, 3), pass_work(rows, q), note,
               phase="13 shards")
    var_e = loc.ycorr.var()
    unif = torch.rand(ms.beta.shape[0], generator=gen, dtype=dt, device=DEV)
    z = torch.randn(ms.beta.shape[0], generator=gen, dtype=dt, device=DEV)
    flat = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1))
    varc = ms.var_beta[0] * ms.v_class
    held_scan(f"r_block_scan_v{tag}", lambda pk_t: gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, K),
              lambda pk_t: gibbs_kernels.r_block_scan_v_plain(ms.gram[0], pk_t, K),
              lambda un: step.rows(gibbs_kernels.r_block_pack(ms.beta, z, un, **flat, varc=varc,
                                                              logpi=ms.log_pi, ive=1.0 / var_e, var_e=var_e)),
              unif, gen, step, lambda pk_t, uu: cdf_near(ms.gram[0], pk_t, uu, K),
              scan_work(V, B, 8 + 4 * K, 1, 3, 10 * K), f"V={V} of {mp.vshards}, B={B}, K={K}, the rank's Gram",
              card_alone=False, phase="13 shards")


def held_corr_share(plan, loc, tag):
    """CM1's block-step and its rule (CM1r) against their plain versions at
    a rank's share of a correlated set (its V/S block chains, its loci), as
    phase 9 holds them at the whole set's shapes."""
    cs, cp = loc.corr_markers[0], plan.corr_markers[0]
    local = replace(cp, vshards=cs.mt.shape[1], p_pad=cs.beta.shape[0])
    case = CM1Case(replace(plan, corr_markers=(local,)), loc)
    n_t, V, B = case.n_t, case.V, case.B
    ref = torch.zeros_like(case.beta)

    def kern():
        return corr_scan.corr_block_step_kernel(case.gram_t, case.pk_g, *case.fold(), case.beta)

    def plain():
        return corr_scan.corr_block_step_plain(cs.gram[0], case.pk_g, 0, *case.fold(), ref)

    u, ru = kern(), plain()
    check(torch.equal(u, kern()) and torch.isfinite(u).all().item(), f"corr_block_scan_v{tag}: two runs differ")
    eu, scu = rel_err(u, ru)
    check(eu <= TOL_CORR * scu, f"corr_block_scan_v{tag}: u max_abs_err {eu:.3e} of {scu:.3e}")
    e, sc = rel_err(case.beta[:, 0], ref[:, 0])
    report(f"corr_block_scan_v{tag}", e, sc, TOL_CORR, median_ms(kern, 20), median_ms(plain, 3),
           work_cm1(V, B, n_t), f" (V = {V} of {cp.vshards}, B = {B}, nT = {n_t}, the rank's Gram and rows; "
           f"u max_abs_err {eu:.3e} of {scu:.3e})", phase="13 shards")

    def rule():
        return corr_scan.corr_rule_kernel(*case.rule_args)

    o, r = rule(), corr_scan.corr_rule_plain(*case.rule_args)
    check(torch.equal(o, rule()), f"corr_rule{tag}: two runs differ")
    e, sc = rel_err(o, r)
    report(f"corr_rule{tag}", e, sc, 1e-5, median_ms(rule, 20),
           median_ms(lambda: corr_scan.corr_rule_plain(*case.rule_args), 3),
           work_rule(local.p_pad, cp.n_regions, n_t), f" (the rank's {local.p_pad:,} loci)", phase="13 shards")


def replicated(st):
    """The fields every rank of a row holds alike after a sweep."""
    ms = st.markers[0]
    return (st.ycorr, st.e.var_e, st.fixed[0].b, ms.var_beta, ms.pi_hat, ms.log_pi)


def rank_nccl(port):
    """13a: a world of one through init_distributed (NCCL, the card), BayesR
    at the main path through make_sharded_sweep on global_mesh(1, 1) and
    through make_sweep, SHARD_SWEEPS eager sweeps each from one PhiloxStream
    seed: the same bits."""
    import torch.distributed as dist

    from nextgp_tpu_torch.parallel import multihost, sharded

    check(multihost.init_distributed(f"127.0.0.1:{port}", 1, 0), "init_distributed: no process group")
    check(dist.get_backend() == "nccl", f"13a: the backend is {dist.get_backend()}, not nccl")
    spec_for, _ = simulate()
    plan, st = ngt.assemble(spec_for("BayesR"), vshards=V_MAIN)
    mesh = multihost.global_mesh(1, 1)
    step = sharded.make_sharded_sweep(plan, mesh)
    local = sharded.distribute(plan, st, mesh, 1)
    out, ends, counted = {}, {}, {}
    for arm, sweep, s0 in (("sharded", step, local), ("make_sweep", ngt.make_sweep(plan), st)):
        _cuda.reset_launches()
        ends[arm], out[f"ms_{arm}"] = sweeps_ms(sweep, s0, PhiloxStream(SHARD_SEED, DEV, torch.float32),
                                                SHARD_SWEEPS)
        counted[arm] = dict(_cuda.LAUNCHES)
    a, b = ends["sharded"], ends["make_sweep"]
    pairs = dict(ycorr=(a.ycorr, b.ycorr), beta=(a.markers[0].beta, b.markers[0].beta),
                 delta=(a.markers[0].delta, b.markers[0].delta), var_e=(a.e.var_e, b.e.var_e),
                 pi=(a.markers[0].pi_hat, b.markers[0].pi_hat))
    for name, (x, y) in pairs.items():
        check(torch.equal(x, y), f"13a: {name} of the 1 x 1 mesh differs from make_sweep's")
    for counter in ("pack2_matvec", "r_block_scan_v", "pack2_rank_update"):
        check(counted["sharded"][counter] > 0, f"13a: {counter} not launched on the sharded run")
    out["route"] = shard_route(step.ctx, a.ycorr)
    out.update(psum_costs(step.ctx, a))
    print(f"[13a] NCCL world of one: {SHARD_SWEEPS} sweeps through make_sharded_sweep and make_sweep the same "
          f"bits (ycorr, beta, delta, varE, pi); psum route {out['route']}; ms/sweep sharded "
          f"{out['ms_sharded']:.4f}, make_sweep {out['ms_make_sweep']:.4f}; a psum of {a.ycorr.numel():,} "
          f"floats {out['psum_ms_vector']:.4f} ms, of one {out['psum_ms_scalar']:.4f}")
    dist.destroy_process_group()
    return dict(out, counted={"shards NCCL 1x1": counted["sharded"]})


def rank_mesh(rank, world, port, root):
    """13b on every rank of a gloo world of four on the card, a (2 x 2)
    mesh, then 13c on ranks 0 and 1, a (1 x 2) mesh."""
    import torch.distributed as dist

    from nextgp_tpu_torch.parallel import multihost, sharded
    from nextgp_tpu_torch.runtime import chain_seed

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    out, counted, tag = {}, {}, f" rank{rank}"
    spec = simulate()[0]("BayesR")
    plan, st = ngt.assemble(spec, vshards=V_MAIN)
    mesh = multihost.global_mesh(2, 2)
    c, s = mesh.coords()

    def stream():
        return keyed.KeyedStream(chain_seed(SHARD_SEED, c), DEV, torch.float32)

    ref, out["ms_single"] = sweeps_ms(ngt.make_sweep(plan), st, stream(), SHARD_RULE)
    local = sharded.distribute(plan, st, mesh, 2)
    del st
    ms = local.markers[0]
    check(ms.mt.shape[1] == V_MAIN // 2 and ms.mt.is_contiguous() and ms.gram.shape[2] == V_MAIN // 2,
          f"13b: the share's layout {tuple(ms.mt.shape)}")
    held_share(plan, local, "_shard" + tag.replace(" ", "_"))
    step = sharded.make_sharded_sweep(plan, mesh)
    _cuda.reset_launches()
    strm = stream()
    loc = step(local, strm)
    for _ in range(SHARD_RULE - 1):
        loc = step(loc, strm)
    g = sharded.gather_chain(loc, plan, step.ctx)
    out["rule"] = rule_vs(f"13b chain {c} shard {s}", (g.markers[0].beta, g.ycorr),
                          (ref.markers[0].beta, ref.ycorr))
    loc, out["ms_sharded"] = sweeps_ms(step, loc, strm, SHARD_SWEEPS - SHARD_RULE)
    counted[f"shards 2x2{tag}"] = dict(_cuda.LAUNCHES)
    for counter in ("pack2_matvec", "r_block_scan_v", "pack2_rank_update", "keyed_rng"):
        check(counted[f"shards 2x2{tag}"][counter] > 0, f"13b: {counter} not launched on rank {rank}")
    fit = loc.fixed[0].x @ loc.fixed[0].b + step.ctx.psum(ngt.genomic_values_state(plan, loc))
    out["drift"] = ((loc.ycorr - (loc.y - fit)).abs().max() / loc.y.abs().max()).item()
    check(out["drift"] < 1e-2, f"13b: ycorr drift {out['drift']:.3e} after {SHARD_SWEEPS} sweeps")
    finite = [loc.markers[0].beta, *replicated(loc)]
    check(all(torch.isfinite(x).all().item() for x in finite), "13b: a draw is not finite")
    out["route"] = shard_route(step.ctx, loc.ycorr)
    out.update(psum_costs(step.ctx, loc))
    out["checksum"] = multihost.chain_checksum(replicated(loc))
    out["digest"] = digest(*replicated(loc))
    print(f"[13b rank {rank}] chain {c} shard {s}: V = {loc.markers[0].mt.shape[1]} of {V_MAIN} "
          f"({loc.markers[0].mt.shape[1] * BLOCK:,} rows a step), drift {out['drift']:.3e}, psum route "
          f"{out['route']} ({out['psum_ms_vector']:.4f} ms over the residual, {out['psum_ms_scalar']:.4f} over a "
          f"scalar), checksum of the replicated fields {out['checksum']!r}")
    rows = [None] * world
    dist.all_gather_object(rows, (c, out["checksum"], out["digest"]))
    for c2, sum2, dig2 in rows:
        if c2 == c:
            check(sum2 == out["checksum"] and dig2 == out["digest"],
                  f"13b: the ranks of chain {c} hold different replicated fields")
        else:
            check(sum2 != out["checksum"], "13b: the two chains hold the same fields")
    del loc, local, ref, g

    _cuda.reset_launches()
    res = ngt.run_chains(spec, n_chains=2, mesh=mesh, vshards=V_MAIN, out_folder=os.path.join(root, "chains"),
                         streams=[keyed.KeyedStream(chain_seed(SHARD_SEED, k), DEV, torch.float32)
                                  for k in range(2)], **SHARD_CHAINS)
    counted[f"shards run_chains{tag}"] = dict(_cuda.LAUNCHES)
    flat = [np.ascontiguousarray(v) for what in ("draws", "rhat", "ess") for _, v in sorted(res[what].items())]
    out["run_chains"] = dict(rhat_varE=float(np.asarray(res["rhat"]["varE"]).reshape(-1)[0]),
                             digest=hashlib.sha256(b"".join(a.tobytes() for a in flat)).hexdigest()[:16])
    check(np.isfinite(out["run_chains"]["rhat_varE"]), "13b: run_chains' R-hat of varE is not finite")
    rows = [None] * world
    dist.all_gather_object(rows, out["run_chains"]["digest"])
    check(len(set(rows)) == 1, f"13b: the ranks' run_chains results differ: {rows}")
    del res

    mesh_c = sharded.make_mesh(1, 2, ranks=[0, 1])  # every rank makes the row's group
    if rank < 2:
        counted.update(rank_corr(rank, mesh_c, tag))
    dist.barrier()
    dist.destroy_process_group()
    return dict(out, counted=counted)


def rank_corr(rank, mesh, tag):
    """13c on one rank of a (1 x 2) mesh: MultiBreed at CORR_SHARD, its
    share held (CM1, CM1r), SHARD_RULE sweeps held to the single-rank V
    chain by the packed rule, then to SHARD_SWEEPS: every covariance
    positive definite, the draws finite."""
    from nextgp_tpu_torch.parallel import sharded

    spec, _ = simulate_corr(CORR_SHARD["n"], CORR_SHARD["p"])
    plan, st = ngt.assemble(spec, vshards=CORR_SHARD["V"])
    ref, _ = sweeps_ms(ngt.make_sweep(plan), st, PhiloxStream(SHARD_SEED, DEV, torch.float32), SHARD_RULE)
    local = sharded.distribute(plan, st, mesh, 1)
    del st
    check(local.corr_markers[0].mt.shape[1] == CORR_SHARD["V"] // 2, "13c: the share's layout")
    held_corr_share(plan, local, "_shard" + tag.replace(" ", "_"))
    step = sharded.make_sharded_sweep(plan, mesh)
    stream = PhiloxStream(SHARD_SEED, DEV, torch.float32)
    _cuda.reset_launches()
    loc, covs = local, []
    for i in range(SHARD_SWEEPS):
        loc = step(loc, stream)
        covs.append(loc.corr_markers[0].var_beta)
        if i + 1 == SHARD_RULE:
            g = sharded.gather_chain(loc, plan, step.ctx)
            rule_vs(f"13c rank {rank}", (g.corr_markers[0].beta, g.ycorr), (ref.corr_markers[0].beta, ref.ycorr))
    counts = dict(_cuda.LAUNCHES)
    for counter in ("pack2_matvec", "corr_rule", "corr_block_scan_v", "pack2_rank_update"):
        check(counts[counter] > 0, f"13c: {counter} not launched on rank {rank}")
    eig = torch.linalg.eigvalsh(torch.stack(covs).double())
    check(torch.isfinite(eig).all().item() and (eig > 0).all().item(),
          "13c: a kept covariance is not positive definite")
    check(torch.isfinite(loc.corr_markers[0].beta).all().item() and torch.isfinite(loc.ycorr).all().item(),
          "13c: a draw is not finite")
    print(f"[13c rank {rank}] MultiBreed {CORR_SHARD['n']:,} x {CORR_SHARD['p']:,} x 2 at V = "
          f"{CORR_SHARD['V']} (local {loc.corr_markers[0].mt.shape[1]}): {SHARD_SWEEPS} sweeps, "
          f"{len(covs) * covs[0].shape[0]} covariances positive definite (smallest eigenvalue "
          f"{eig.min().item():.3e})")
    return {f"shards corr{tag}": counts}


def shard_rank(role, rank, world, port, out_file):
    """A rank's process (`chip_smoke.py shard-rank ROLE RANK WORLD PORT
    FILE`, started by shards_phase): its part of phase 13 on the card, its
    numbers and launch counters written to FILE as JSON. It never builds:
    the parent built the kernels before any rank started."""
    check(torch.cuda.is_available(), "a rank without a CUDA device: no rank runs on the CPU")
    check(any(_cuda.BUILD_ROOT.glob("*/libnextgp_torch_kernels.so")), "the parent did not build the kernels")
    rank, world = int(rank), int(world)
    if role == "nccl":
        out = rank_nccl(port)
    else:
        out = rank_mesh(rank, world, port, os.path.dirname(out_file))
    out["timings"] = {k: v for k, v in TIMINGS.items() if "_shard" in k}
    Path(out_file).write_text(json.dumps(out))


def start_ranks(role, world, root):
    """Start a group of ranks (this script's shard-rank mode) on a free
    localhost port; returns their processes and output files."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo") if role == "nccl" else dict(os.environ)
    files = [os.path.join(root, f"{role}{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "shard-rank", role, str(r),
                               str(world), str(port), files[r]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    return procs, files


def wait_ranks(role, procs, files):
    """Each rank's output printed and its JSON read; the phase fails if any
    rank exits non-zero or outlasts SHARD_TIMEOUT (all are killed then)."""
    try:
        outs = [p.communicate(timeout=SHARD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            print(f"  [{role} rank {r}] {line}")
        check(p.returncode == 0, f"13 {role}: rank {r} exited {p.returncode}")
    return [json.loads(Path(f).read_text()) for f in files]


def shards_phase(card):
    """Phase 13: the chains x shards mesh (ROADMAP M14). The kernels are
    built (phase 2) before any rank starts; each group of ranks runs as
    child processes of this one, which reads back a JSON file from each.
    13a: one rank, NCCL, a world of one; 13b: four ranks, a gloo world on
    this one card, a (2 x 2) mesh; 13c: ranks 0 and 1 of it, a (1 x 2) mesh
    over a correlated set. NCCL with two or more ranks needs a card a rank,
    which this machine does not have."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="shards-")
    try:
        (a,) = wait_ranks("nccl", *start_ranks("nccl", 1, root))
        ranks = wait_ranks("mesh", *start_ranks("mesh", 4, root))
        folders = sorted(os.listdir(os.path.join(root, "chains")))
        check(folders == ["chain1", "chain2"], f"13b: run_chains wrote {folders}")
        kept = SHARD_CHAINS["n_chain"] - SHARD_CHAINS["n_burn"]
        for f in folders:
            lines = Path(root, "chains", f, "varEOut").read_text().splitlines()
            check(len(lines) == 1 + kept // SHARD_CHAINS["n_thin"], f"13b: {f}/varEOut has {len(lines)} lines")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counted = dict(a.pop("counted"))
    for r in ranks:
        counted.update(r.pop("counted"))
    out = {"13a": a, "13b": ranks, "seconds": time.perf_counter() - t0}
    print(f"[13 shards] {card}: ms/sweep 13a make_sweep {a['ms_make_sweep']:.4f}, make_sharded_sweep "
          f"{a['ms_sharded']:.4f} (NCCL world of one); 13b single-rank V={V_MAIN} "
          + ", ".join(f"{r['ms_single']:.4f}" for r in ranks) + f", sharded V={V_MAIN // 2} a rank "
          + ", ".join(f"{r['ms_sharded']:.4f}" for r in ranks) + f" (ranks 0-3). Note: {SHARED_CARD}")
    print(f"[13 shards] psum routes and ms a psum (the residual, a scalar): 13a {a['route']} "
          f"{a['psum_ms_vector']:.4f}, {a['psum_ms_scalar']:.4f}; 13b "
          + "; ".join(f"{r['route']} {r['psum_ms_vector']:.4f}, {r['psum_ms_scalar']:.4f}" for r in ranks))
    print(f"[13 shards] phase 13 passed in {out['seconds']:.1f} s")
    return out, counted


# ------------------------------------------------------------------ phase 14

TOL_F64 = 1e-12  # the float64 instances against their plain versions (float64 too), of the output's scale
TOL_F64_CHAIN = 1e-9  # 14b: the float64 kernel chain against the float64 plain chain, of scale
F64_SWEEPS = 20  # 14b: sweeps of both chains at V=96
F64_SMALL = dict(n=2_000, p=8_192, sweeps=3)  # 14b at V=1: a smaller panel and 3 sweeps, the plain scans' loops
F64_RULE = 3  # 14d, 14e: sweeps held by the packed rule
F64_PATHS_V96 = ("BayesB", "BayesC", "BayesC+D", "BayesPR")  # 14b beside BayesR at V=96
# 14c beside BayesR at V=96: (path, V); BayesC and BayesLV at V=1, where phase 4 holds their EBV
F64_REPLAYED = (("BayesB", V_MAIN), ("BayesC", 1), ("BayesC+D", V_MAIN), ("BayesPR", V_MAIN), ("BayesLV", 1))


def f64_passes(st):
    """14a: K1, K2, K1' and K2' float64 on the BayesR model's panel (a V=96
    step, t = 1, and the whole panel), each twice the same bits."""
    ms = st.markers[0]
    T, V, B, q = ms.mt.shape
    rows = V * B
    mt_rows = ms.mt.view(-1, q)
    g = torch.Generator(device=DEV).manual_seed(1)
    y4 = pack2.y_planar(Step0(st).y)
    u = torch.randn(rows, generator=g, dtype=torch.float64, device=DEV) * 0.01
    u_all = torch.randn(T * rows, generator=g, dtype=torch.float64, device=DEV) * 0.01
    sl = mt_rows[rows:2 * rows]
    for name, kern, plain, n_rows in (
            ("pack2_matvec_f64", lambda: pack2.matvec_step(mt_rows, 1, y4, rows),
             lambda: pack2.matvec_plain(sl, y4), rows),
            ("pack2_rank_update_f64", lambda: pack2.rank_update_step(mt_rows, 1, u),
             lambda: pack2.rank_update_plain(sl, u), rows),
            ("pack2_matvec_panel_f64", lambda: pack2.matvec(mt_rows, y4),
             lambda: pack2.matvec_plain(mt_rows, y4), T * rows),
            ("pack2_rank_update_panel_f64", lambda: pack2.rank_update(mt_rows, u_all),
             lambda: pack2.rank_update_plain(mt_rows, u_all), T * rows)):
        got = kern()
        check(got.dtype == torch.float64 and torch.equal(got, kern()), f"{name}: two runs differ")
        DIGESTS[name] = dict(outputs=digest(got))
        e, s = rel_err(got, plain())
        report(name, e, s, TOL_F64, median_ms(kern, 20), median_ms(plain, 5), pass_work(n_rows, q, 8),
               f" ({n_rows} x {q}, float64)", dev_ms=device_ms(kern, 20), phase="14 f64",
               flops=F64_FLOP_PER_S)


def f64_scan_rows(st, seed=2):
    """A first sweep's BayesR coefficient rows at step 0 of st's marker set
    (Step0), their uniforms and generator: (step, make_rows, unif, gen, K)."""
    ms, dt = st.markers[0], st.ycorr.dtype
    step = Step0(st)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    var_e = st.ycorr.var()
    p_pad = ms.beta.shape[0]
    unif = torch.rand(p_pad, generator=gen, dtype=dt, device=DEV)
    z = torch.randn(p_pad, generator=gen, dtype=dt, device=DEV)
    flat = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1))

    def make_rows(un):
        return step.rows(gibbs_kernels.r_block_pack(ms.beta, z, un, **flat, varc=ms.var_beta[0] * ms.v_class,
                                                    logpi=ms.log_pi, ive=1.0 / var_e, var_e=var_e))
    return step, make_rows, unif, gen, ms.v_class.numel()


def f64_kernels(spec, spec_w):
    """14a: the float64 instances of K1, K2 (and K1', K2'), K3, K6, K8 and
    K10 against their plain versions at the main path's shapes, the scans at
    V=96 and at V=1 (K4, K5, K7, K9), within TOL_F64 of scale, delta exact,
    twice the same bits, timed beside their bounds (the same bytes with the
    vectors, the Gram, the rows and the outputs in 8 bytes, the operations
    at the float64 rate; K6 also beside the float64 triangular solve). K6
    and K8 run on the BayesR model's Gram (spec), K10 on the weighted
    model's two (spec_w)."""
    for V, tag in ((V_MAIN, ""), (1, "_v1")):
        plan, st = ngt.assemble(spec, vshards=V, dtype=torch.float64)
        ms = st.markers[0]
        T, _, B, q = ms.mt.shape
        check(st.ycorr.dtype == ms.gram.dtype == torch.float64 and ms.mt.dtype == torch.uint8,
              "14a: the float64 model is not float64 on packed rows")
        if V == V_MAIN:
            f64_passes(st)
        step, make_rows, unif, gen, K = f64_scan_rows(st)
        gram0 = ms.gram[0]
        held_scan(f"r_block_scan_v{tag}_f64", lambda pk_t: gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, K),
                  lambda pk_t: gibbs_kernels.r_block_scan_v_plain(gram0, pk_t, K), make_rows, unif, gen, step,
                  lambda pk_t, uu: cdf_near(gram0, pk_t, uu, K),
                  scan_work(V, B, 8 + 4 * K, 1, 2.5, 10 * K, itemsize=8), f"V={V}, B={B}, K={K}, float64",
                  phase="14 f64", tol=TOL_F64, flops=F64_FLOP_PER_S)
        z = torch.randn(ms.beta.shape[0], generator=gen, dtype=torch.float64, device=DEV)
        var_e = st.ycorr.var()
        f64_scan8 = dict(phase="14 f64", tol=TOL_F64, flops=F64_FLOP_PER_S)
        scan8_kernels(st, z, var_e, unif, gen, tag, **f64_scan8)
        del plan, st, step
        _, st_w = ngt.assemble(spec_w, vshards=V, dtype=torch.float64)
        scan8_kernels(st_w, z, var_e, unif, gen, tag, **f64_scan8)
        del st_w


def build_report(instance, tag, n):
    """What ptxas and the SASS say of the built library's kernels whose
    mangled names `instance` maps to a name (the rest map to None):
    registers, spill bytes, local-memory loads and stores (LDL, STL) and
    shared-memory loads behind a predicate (@P LDS), each printed. There
    must be n such instances, and a float64 instance may hold no more
    predicated shared loads than its float32 counterpart. Returns
    {instance: ...}."""
    so = _cuda.build()
    out, cur = {}, None
    for line in (so.parent / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = instance(m.group(1))
            if cur:
                out[cur] = {}
        elif cur and "spill" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            out[cur].update(spill_stores=int(stores), spill_loads=int(loads))
        elif cur and "Used" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    for f in library_sass():
        name = instance(f.split("\n", 1)[0])
        if name:
            lines = f.splitlines()
            out[name]["predicated_lds"] = sum(1 for ln in lines if re.search(r"@!?P\d+\s+LDS\b", ln))
            out[name]["ldl_stl"] = sum(1 for ln in lines if re.search(r"\b(LDL|STL)\b", ln))
    check(len(out) == n and all(len(v) == 5 for v in out.values()),
          f"{tag}: the instances in ptxas.log and the SASS: {out}")
    for name in sorted(out):
        print(f"[14 f64] {name}: {out[name]}")
    more = [n for n in out if "f64" in n and out[n]["predicated_lds"] > out[n.replace("f64", "f32")]["predicated_lds"]]
    check(not more, f"{tag}: float64 instances with more predicated shared loads than float32: {more}")
    return out


def scan8_build():
    """14a: build_report of K6's, K8's and K10's instances (float32 and
    float64, blocks of up to 256 and of 1,024 threads); a float64 instance
    loads a row's words before the rule's compare, as its float32 one."""
    def instance(mangled):
        m = re.search(r"(GaussRule|BcRule)I([fd])(?:Li(\d)E)?E+Li(\d+)E", mangled)
        if m is None:
            return None
        kernel = {"GaussRule": "K6", "BcRule": "K8" if m.group(3) == "1" else "K10"}[m.group(1)]
        return f"{kernel} {'f64' if m.group(2) == 'd' else 'f32'} MAXT={m.group(4)}"

    return build_report(instance, "14a K6/K8/K10", 12)


def instance_turns(spec, spec_w):
    """14f: K1, K2, K3, K6, K8 and K10 on the card alone on one V=96 step
    of the main path, the float32 instance (P) and the float64 one (C) in
    turns P, C, C, P (device_ms, 20 calls a window). Returns {kernel: [P,
    C, C, P]}."""
    arms = {}
    for dt in (torch.float32, torch.float64):
        _, st = ngt.assemble(spec, vshards=V_MAIN, dtype=dt)
        _, st_w = ngt.assemble(spec_w, vshards=V_MAIN, dtype=dt)
        ms = st.markers[0]
        T, V, B, q = ms.mt.shape
        rows, mt_rows = V * B, ms.mt.view(-1, q)
        y4 = pack2.y_planar(Step0(st).y)
        u = torch.randn(rows, generator=torch.Generator(device=DEV).manual_seed(1), dtype=dt,
                        device=DEV) * 0.01
        _, make_rows, unif, gen, K = f64_scan_rows(st)
        pk_t = make_rows(unif)
        arms[dt] = {"K1": lambda m=mt_rows, y=y4, r=rows: pack2.matvec_step(m, 1, y, r),
                    "K2": lambda m=mt_rows, uu=u: pack2.rank_update_step(m, 1, uu),
                    "K3": lambda ms=ms, p=pk_t, k=K: gibbs_kernels.r_block_scan_v((ms.gram, 0), p, k)}
        z = torch.randn(ms.beta.shape[0], generator=gen, dtype=dt, device=DEV)
        cases = scan8_cases(st, z, st.ycorr.var())[1] + scan8_cases(st_w, z, st.ycorr.var())[1]
        for (_, kern, _, rows_of, *_), name in zip(cases, ("K6", "K8", "K10")):
            arms[dt][name] = lambda kern=kern, p=rows_of(unif): kern(p)
    out = {}
    for name in ("K1", "K2", "K3", "K6", "K8", "K10"):
        out[name] = [device_ms(arms[dt][name], 20)
                     for dt in (torch.float32, torch.float64, torch.float64, torch.float32)]
        out[name + " graph_ms"] = [graph_ms(arms[dt][name]) for dt in (torch.float32, torch.float64)]
        shown = ", ".join("not measured" if t is None else f"{t:.4f}" for t in out[name])
        print(f"[14 f64] {name} on the card alone, turns f32 / f64 / f64 / f32 (ms): {shown}; events around a "
              "graph of 20 calls f32 / f64: " + " / ".join(f"{t:.4f}" for t in out[name + " graph_ms"]))
    for name, line in (("K2", "pack2_rank_update_f64"), ("K10", "bc_block_scan_wv_f64")):
        print(f"[14 f64] {name} f64 on the card alone, ms: the kernels line's profiler window "
              f"{TIMINGS[line]['device_ms']}, the turns' windows {out[name][1]} / {out[name][2]}, events around "
              f"a graph of 20 calls {out[name + ' graph_ms'][1]:.4f}")
    return out


@contextlib.contextmanager
def plain_sweep_kernels():
    """The sweep's kernels, K1, K2, K3, K6, K8, K10, K12, K14, CM1, CM1r,
    RE1 and RE2 (engine/samplers/markers.py and random_effects.py call them
    through these module attributes), go to their plain versions on the
    card's tensors: the plain chain of the same stream."""
    def step_of(gram_t):
        return gram_t[0][gram_t[1]]

    plain = {
        (pack2, "matvec_step"): lambda pk_all, t, y4, rows: pack2.matvec_plain(
            pk_all[t * rows:(t + 1) * rows], y4),
        (pack2, "rank_update_step"): lambda pk_all, t, u: pack2.rank_update_plain(
            pk_all[t * u.shape[0]:(t + 1) * u.shape[0]], u),
        (gibbs_kernels, "r_block_scan_v"): lambda gram_t, pk, K: gibbs_kernels.r_block_scan_v_plain(
            step_of(gram_t), pk, K),
        (gibbs_kernels, "gauss_block_scan_v"): lambda gram_t, pk: gibbs_kernels.gauss_block_scan_v_plain(
            step_of(gram_t), pk),
        (gibbs_kernels, "bc_block_scan_v"): lambda gram_t, pk: gibbs_kernels.bc_block_scan_v_plain(
            step_of(gram_t), pk),
        (gibbs_kernels, "bc_block_scan_wv"): lambda gram_t, graw_t, pk: gibbs_kernels.bc_block_scan_wv_plain(
            step_of(gram_t), step_of(graw_t), pk),
        (gibbs_kernels, "rcpi_block_scan_v"): lambda gram_t, pk, A, K: gibbs_kernels.rcpi_block_scan_v_plain(
            step_of(gram_t), pk, A, K),
        (gibbs_kernels, "rcplus_block_scan_v"): lambda gram_t, pk, A, K: gibbs_kernels.rcplus_block_scan_v_plain(
            step_of(gram_t), pk, A, K),
        (corr_scan, "corr_rule"): corr_scan.corr_rule_plain,
        (corr_scan, "corr_block_step"): lambda gram_t, pk_g, r0, cb, sum_y, beta: corr_scan.corr_block_step_plain(
            step_of(gram_t), pk_g, gram_t[1], r0, cb, sum_y, beta),
        (random_effects, "level_scan"): random_scan.level_scan_plain,
        (random_effects, "corr_level_scan"): random_scan.corr_level_scan_plain,
    }
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def f64_sweeps(spec, V, n, stream_seed=5, dtype=torch.float64, pack=None):
    """n eager sweeps of the model from a fresh assemble with one
    KeyedStream; returns (plan, state, launches counted from 0)."""
    plan, st = ngt.assemble(spec, vshards=V, dtype=dtype, pack2=pack)
    stream = keyed.KeyedStream(stream_seed, DEV, dtype)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    for _ in range(n):
        st = sweep(st, stream)
    torch.cuda.synchronize()
    return plan, st, dict(_cuda.LAUNCHES)


def f64_chain_vs_plain(spec, V, n, tag, path="BayesR", random=None):
    """14b, 14h: n float64 sweeps of the path's kernel chain against its
    float64 plain chain (plain_sweep_kernels) on one KeyedStream: delta the
    same, beta and ycorr (and the random term's u) within TOL_F64_CHAIN of
    scale; the kernel chain launches K1, K2 (on packed rows), the path's
    scan and the random term's level scan (random: "level_scan" or
    "corr_level_scan", where the model has one) as float64 alone, and
    nothing else but R1, the plain chain none of the sweep's kernels."""
    _, _, scan, gathers = {**PATHS, **EXTRA_PATHS}[path]
    plan, st, counted = f64_sweeps(spec, V, n)
    T = plan.markers[0].n_blocks // V
    path_kernels = {"pack2_matvec_f64": gathers * n * T, "pack2_rank_update_f64": n * T, scan + "_f64": n * T}
    if random:
        path_kernels[random + "_f64"] = n
    expect = {k: 0 for k in counted}
    expect.update(path_kernels, keyed_rng=counted["keyed_rng"])
    check(counted == expect, f"{tag}: kernel chain launches {counted}")
    t0 = time.perf_counter()
    with plain_sweep_kernels():
        _, sp, plain_counted = f64_sweeps(spec, V, n)
    plain_s = time.perf_counter() - t0
    check(not any(v for k, v in plain_counted.items() if k != "keyed_rng"),
          f"{tag}: the plain chain launched {plain_counted}")
    mk, mp_ = st.markers[0], sp.markers[0]
    e_b, s_b = rel_err(mk.beta, mp_.beta)
    e_y, s_y = rel_err(st.ycorr, sp.ycorr)
    e_u, s_u = rel_err(st.random[0].u, sp.random[0].u) if random else (0.0, 1.0)
    same = torch.equal(mk.delta, mp_.delta)
    u_shown = f"u {e_u:.3e} of scale {s_u:.3e}, " if random else ""
    print(f"[14 {tag}] {n} float64 sweeps of one KeyedStream, kernel chain against plain chain: beta "
          f"{e_b:.3e} of scale {s_b:.3e}, ycorr {e_y:.3e} of scale {s_y:.3e}, {u_shown}(limit "
          f"{TOL_F64_CHAIN:g} x scale), delta {'identical' if same else 'DIFFERS'} ({int((mk.delta > 0).sum())} "
          f"loci with delta > 0); the plain chain took {plain_s:.1f} s; kernel launches {path_kernels}")
    check(same, f"{tag}: delta differs between the float64 kernel and plain chains")
    check(e_b <= TOL_F64_CHAIN * s_b and e_y <= TOL_F64_CHAIN * s_y and e_u <= TOL_F64_CHAIN * s_u,
          f"{tag}: the float64 kernel chain departs from the float64 plain chain")
    out = dict(beta_err=e_b, beta_scale=s_b, ycorr_err=e_y, ycorr_scale=s_y, plain_s=plain_s)
    if random:
        out.update(u_err=e_u, u_scale=s_u)
    return counted, out


def replay_turns(spec):
    """14f: the replayed BayesR sweep (KeyedStream, V=96) in float32 (P) and
    float64 (C) in turns P, C, C, P: ms/sweep (CUDA events around
    F64_TURN_WINDOW replays), device busy from 10 profiled replays, and the
    idle share 1 - busy / ms."""
    reps = {}
    for dt in (torch.float32, torch.float64):
        plan, st = ngt.assemble(spec, vshards=V_MAIN, dtype=dt)
        reps[dt] = engine_sweep.ReplayedSweep(plan, st, keyed.KeyedStream(7, DEV, dt))
    out = []
    for dt in (torch.float32, torch.float64, torch.float64, torch.float32):
        ms = steady_ms(lambda r=reps[dt]: r.run(1), 50)
        busy, nodes, missed, _, _ = replay_window(reps[dt], 10)
        out.append(dict(dtype=str(dt).removeprefix("torch."), ms_per_sweep=ms, busy_ms=busy, nodes=nodes,
                        missed=missed, idle_share=1.0 - busy / ms))
    print("[14 f64] replayed BayesR V=96, turns f32 / f64 / f64 / f32: ms/sweep "
          + " / ".join(f"{r['ms_per_sweep']:.4f}" for r in out) + "; busy ms "
          + " / ".join(f"{r['busy_ms']:.4f}" for r in out) + "; idle share "
          + " / ".join(f"{r['idle_share']:.4f}" for r in out) + "; nodes "
          + " / ".join(str(r["nodes"]) for r in out))
    del reps
    return out


def method_spec(geno, y, path, prior=None):
    """The path's model over dosages on the card (from_device_array: packed
    by assemble, or int8 rows under pack2=False), as phase 4's (the weighted
    residual of simulate for "+D"); prior, where given, replaces the path's
    (BayesLV's covariates on another panel's loci)."""
    path_prior, weighted = {**PATHS, **EXTRA_PATHS}[path][:2]
    n = geno.shape[0]
    return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                         markers=[ngt.MarkerTerm("M1", ngt.from_device_array(geno), prior or path_prior)],
                         residual=ngt.RandomEffect(np.random.default_rng(3).uniform(0.5, 2.0, n), 1.0)
                         if weighted else None, block_size=BLOCK)


def f64_phase():
    """14: float64 on the card through the float64 instances of K1, K2, K3,
    K6, K8 and K10, at bench.py:131-144's configuration (10,000 x 49,152,
    packed, V=96, estimatePi; phase 4's simulated panel, kept as int8
    dosages on the card so that the same data also runs on int8 rows),
    nothing cut: (a) the kernels against their plain versions, and what
    ptxas and the SASS say of K6's, K8's and K10's instances; (b) 20 float64
    sweeps of the kernel chain against the float64 plain chain on one
    KeyedStream for BayesR, BayesB, BayesC, BayesC+D and BayesPR at V=96,
    and 3 at V=1 on a 2,000 x 8,192 panel for BayesR and BayesLV (BayesLV
    departs from its V=1 chain at V=96 by design); (c) 100 float64 sweeps
    of BayesR, BayesB, BayesC+D, BayesPR (V=96), BayesC and BayesLV (V=1)
    through run_lmem, eager and replayed with the same bits, drift < 1e-9
    of max|y|, phase 4's EBV and varE limits where it has them; (d) the
    float32 BayesR kernel chain held to the float64 one by the packed rule
    after 3 sweeps; (e) float64 on int8 rows (pack2=False) held to the
    packed float64 chain by the same rule, for BayesR and BayesC+D; (f) in
    turns f32 / f64 / f64 / f32, K1, K2, K3, K6, K8 and K10 on the card
    alone (and each by events around a graph of 20 calls) and the replayed
    BayesR sweep; (g)-(j) the float64 level scans, RE1 and RE2, and the
    random-effect models through them (f64_random_phase: the instances
    against their plain versions, timed; BayesR+A and BayesR+A2 kernel
    chains against plain chains at 2,000 animals; BayesR+A, GBLUP and
    BayesR+A2 at full width eager and replayed; RE1 and RE2 in turns f32 /
    f64 / f64 / f32); (k)-(n) K12, K14, CM1 and CM1r in float64 and the
    models through them (f64_rc_corr_phase: the build's report, the
    instances against their plain versions at phase 3's and phase 9's
    shapes, kernel chains against plain chains of BayesRCpi, BayesRCplus
    and MultiBreed, and those models eager and replayed at full width).
    Returns (numbers, launches by run)."""
    t0 = time.perf_counter()
    out, counted = {}, {}
    geno, _, y, sig, _ = simulate_panel()
    spec, spec_w = method_spec(geno, y, "BayesR"), method_spec(geno, y, "BayesC+D")
    out["14a build"] = scan8_build()
    f64_kernels(spec, spec_w)
    counted["f64 V=96"], out["14b V=96"] = f64_chain_vs_plain(spec, V_MAIN, F64_SWEEPS, f"f64 V={V_MAIN}")
    for path in F64_PATHS_V96:
        counted[f"f64 {path} V={V_MAIN}"], out[f"14b {path} V=96"] = f64_chain_vs_plain(
            spec_w if path == "BayesC+D" else method_spec(geno, y, path), V_MAIN, F64_SWEEPS,
            f"f64 {path} V={V_MAIN}", path)
    n_s, p_s = F64_SMALL["n"], F64_SMALL["p"]
    small, _, y_small, _, _ = simulate_panel(n_s, p_s)
    counted["f64 V=1"], out["14b V=1"] = f64_chain_vs_plain(
        method_spec(small, y_small, "BayesR"), 1, F64_SMALL["sweeps"], f"f64 V=1 {n_s:,} x {p_s:,}")
    lv_small = ngt.BayesLV(V_LV, annotations(p_s)[1], VZETA_LV)
    counted["f64 BayesLV V=1"], out["14b BayesLV V=1"] = f64_chain_vs_plain(
        method_spec(small, y_small, "BayesLV", lv_small), 1, F64_SMALL["sweeps"],
        f"f64 BayesLV V=1 {n_s:,} x {p_s:,}", "BayesLV")
    del small
    rec = graph_path("BayesR", spec, sig, V_MAIN, N_CHAIN, N_BURN, N_THIN, EBV_LIMITS[("BayesR", V_MAIN)],
                     tag=" f64", dtype=torch.float64, phase="14", drift_limit=1e-9)
    counted[f"f64 keyed V={V_MAIN}"] = rec.pop("eager_launches")
    out["14c"] = rec
    for path, V in F64_REPLAYED:
        rec = graph_path(path, spec_w if path == "BayesC+D" else method_spec(geno, y, path), sig, V, N_CHAIN,
                         N_BURN, N_THIN, EBV_LIMITS.get((path, V)), tag=" f64", dtype=torch.float64, phase="14",
                         drift_limit=1e-9, var_e_limit=VAR_E_LIMITS.get((path, V)),
                         n_window=50 if V == V_MAIN else 20)
        counted[f"f64 keyed {path} V={V}"] = rec.pop("eager_launches")
        out[f"14c {path} V={V}"] = rec
    plan64, st64, _ = f64_sweeps(spec, V_MAIN, F64_RULE)
    _, st32, _ = f64_sweeps(spec, V_MAIN, F64_RULE, dtype=torch.float32)
    out["14d"] = packed_rule("float32 / float64 kernel chains", (st32.markers[0].beta, st32.ycorr),
                             (st64.markers[0].beta, st64.ycorr), phase="14")
    for path, sp, scan in (("BayesR", spec, "r_block_scan_v_f64"), ("BayesC+D", spec_w, "bc_block_scan_wv_f64")):
        key = "f64 int8" if path == "BayesR" else f"f64 {path} int8"
        _, st8, counted[key] = f64_sweeps(sp, V_MAIN, F64_RULE, pack=False)
        _, stp, _ = (None, st64, None) if path == "BayesR" else f64_sweeps(sp, V_MAIN, F64_RULE)
        check(st8.markers[0].mt.dtype == torch.int8 and counted[key][scan] > 0
              and not counted[key]["pack2_matvec_f64"] and not counted[key]["pack2_rank_update_f64"],
              f"14e: {path} int8 launches {counted[key]}")
        out["14e" if path == "BayesR" else f"14e {path}"] = packed_rule(
            f"float64 {path} int8 / packed chains", (st8.markers[0].beta, st8.ycorr),
            (stp.markers[0].beta, stp.ycorr), phase="14")
        e_y, s_y = rel_err(st8.ycorr, stp.ycorr)
        print(f"[14 f64 {path} int8 / packed] ycorr {e_y:.3e} of scale {s_y:.3e} apart after {F64_RULE} sweeps")
        del st8, stp
    _cuda.reset_launches()
    gv = ngt.genomic_values_state(plan64, st64)
    torch.cuda.synchronize()
    counted["f64 serving"] = dict(_cuda.LAUNCHES)
    check(gv.dtype == torch.float64 and counted["f64 serving"]["pack2_rank_update_f64"] == 1,
          f"14: serving in float64 launches {counted['f64 serving']}")
    del plan64, st64, st32, gv
    out["14f kernels"] = instance_turns(spec, spec_w)
    out["14f replayed"] = replay_turns(spec)
    del spec, spec_w
    re_out, by_run = f64_random_phase(geno, y, sig)
    out.update(re_out)
    counted.update(by_run)
    rc_out, by_run = f64_rc_corr_phase(geno, y, sig)
    out.update(rc_out)
    counted.update(by_run)
    del geno
    out["seconds"] = time.perf_counter() - t0
    print(f"[14 f64] phase 14 in {out['seconds']:.1f} s")
    return out, counted


# 14g-14j: RE1 and RE2 in float64
RE2_F64_NTS = (1, 2, 3, 4, 5)  # 14g at q = 10,000: the cooperative form's nT and the generic form's 5
# 14g: the library's float64 solve at nT <= 3; its (q nT)^2 matrix takes 12.8 GB at nT = 4, 20 GB at 5
RE2_F64_LIBRARY = (1, 2, 3)
RE2_F64_EDGES = (1, 31, 33, 193, 3001)  # 14g: phase 9's edges
F64_RANDOM = dict(gen_size=400, sweeps=10)  # 14h: 5 generations of 400 animals (2,000), 10 sweeps
LEVEL_KERNELS = ("coop_prep_kernel", "coop_scan_kernel", "generic_chain_kernel", "row_dots_kernel",
                 "prep_kernel", "scan_kernel")  # csrc/level_scan.cu's entries, longest names first


def level_build():
    """14g: build_report of every RE1 and RE2 instance (float32 and float64;
    RE2's cooperative form at nT = 1 .. 4 and its generic form); the
    float64 chain loads the next group's row before it selects, as the
    float32 one. Then the scan launch's shared memory as the kernel states
    it (ngt_level_scan_smem_bytes) against ops/random_scan's helper."""
    def instance(mangled):
        m = re.search(r"\d+(" + "|".join(LEVEL_KERNELS) + r")I([fd])(?:Li(\d)E)?E", mangled)
        if m is None or (m.group(1) == "scan_kernel" and "ScanArgs" not in mangled):
            return None  # grn_scan.cu has a scan_kernel of its own
        return f"{m.group(1)} {'f64' if m.group(2) == 'd' else 'f32'}" + (f" nT={m.group(3)}" if m.group(3) else "")

    out = build_report(instance, "14g RE1/RE2", 24)
    smem = {(n_t, f64): _cuda.lib().ngt_level_scan_smem_bytes(n_t, f64) for n_t in range(6) for f64 in (0, 1)}
    check(all(v == random_scan.level_scan_smem_bytes(n_t, 8 if f64 else 4) for (n_t, f64), v in smem.items()),
          f"14g: the scan launch's shared memory in csrc/level_scan.cu {smem} is not what "
          "ops/random_scan.level_scan_smem_bytes states")
    print(f"[14 f64] the scan launch's shared memory by (nT, float64), as the kernel and the wrapper state it: {smem}")
    return out


def timed_once(fn):
    """(fn's output, ms between CUDA events around the one call)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def held_level(name, kern, plain, system, view, work, note, dev_ms_of, with_library=True):
    """14g: one float64 level scan against its float64 plain version on the
    same inputs (within TOL_F64 of u's scale, twice the same bits), timed
    beside its bound and, where with_library, the library's float64
    triangular solve of the same system (built outside the timed window,
    held to the plain version within TOL_F64_CHAIN); view turns the solve's
    (q nT, 1) into u's shape. Times on the card alone: dev_ms_of(kern), and
    graph_ms for the library (late in the whole run the profiler drops
    records)."""
    out = kern()
    check(out.dtype == torch.float64 and torch.isfinite(out).all().item() and torch.equal(out, kern()),
          f"{name}: not float64 and finite, or two runs differ")
    ref, ms_p = timed_once(plain)  # the plain version loops over levels: one call
    e, sc = rel_err(out, ref)
    lib_ms = lib_dev = None
    e_l = "not measured"
    if with_library:
        mat, rhs = system()

        def library():
            return torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)

        err_l, _ = rel_err(view(library()), ref)
        check(err_l <= TOL_F64_CHAIN * sc, f"{name}: the library's float64 solve differs by {err_l:.3e}")
        lib_ms, lib_dev, e_l = median_ms(library, 10), graph_ms(library, 10, 3), f"{err_l:.3e}"
        del mat, rhs
    report(name, e, sc, TOL_F64, median_ms(kern, 10), ms_p, work,
           f"{note}; the library's float64 solve's max_abs_err {e_l})", phase="14 f64", dev_ms=dev_ms_of(kern),
           library_ms=lib_ms, library_dev_ms=lib_dev, flops=F64_FLOP_PER_S)
    return dict(device_ms=TIMINGS[name]["device_ms"], library_device_ms=lib_dev, max_abs_err=e, scale=sc)


def f64_level_kernels(ainv):
    """14g: RE1's and RE2's float64 instances against their float64 plain
    versions at q = 10,000 on phase 8's A^-1 (RE2 at nT = 1 .. 4 and 5, the
    generic form) and at phase 8's and phase 9's edges on random
    structures, each within TOL_F64 of u's scale and twice the same bits;
    at q = 10,000 timed on the card alone beside the float64 byte bound (A's
    lower triangle in 8 bytes) and the library's float64 triangular solve.
    Returns the numbers by name."""
    q, dt, out = ainv.shape[0], torch.float64, {}
    g = torch.Generator(device=DEV).manual_seed(30)
    yi, z, u = (torch.randn(q, generator=g, dtype=dt, device=DEV) for _ in range(3))
    args = (ainv, yi, torch.rand(q, generator=g, dtype=dt, device=DEV) * 3, z, u,
            torch.tensor(1 / 1.7, dtype=dt, device=DEV), torch.tensor(0.6, dtype=dt, device=DEV))
    out["level_scan_f64"] = held_level(
        "level_scan_f64", lambda: random_scan.level_scan_kernel(*args), lambda: random_scan.level_scan_plain(*args),
        lambda: random_scan.level_scan_system(*args), lambda x: x[:, 0], work_re1(q, 8),
        f" (q = {q:,}, float64, the dense A^-1 of phase 8's pedigree, random inputs; 2 launches a call; on "
        "the card alone: CUDA events around a graph of 20 calls", graph_ms)
    for qs in RE1_EDGES:
        small = tuple(t.double() for t in re1_inputs(qs, *args[5:]))
        o, r = random_scan.level_scan_kernel(*small), random_scan.level_scan_plain(*small)
        e, sc = rel_err(o, r)
        same = torch.equal(o, random_scan.level_scan_kernel(*small))
        print(f"[14 f64] level_scan_f64 at q = {qs:,}: max_abs_err {e:.3e} (scale {sc:.3e}, tol {TOL_F64:g} x "
              f"scale); two launches {'bit-identical' if same else 'DIFFER'}")
        check(e <= TOL_F64 * sc and same, f"level_scan_f64 at q = {qs} disagrees with its plain version or itself")
    for n_t in RE2_F64_NTS:
        a2 = tuple(t.to(dt) for t in re2_inputs(q, n_t, ainv, seed=n_t))
        name = "corr_level_scan_f64" if n_t == 2 else f"corr_level_scan_nt{n_t}_f64"
        out[name] = held_level(
            name, lambda a2=a2: random_scan.corr_level_scan_kernel(*a2),
            lambda a2=a2: random_scan.corr_level_scan_plain(*a2),
            lambda a2=a2: random_scan.corr_level_scan_system(*a2), lambda x, n_t=n_t: x.view(q, n_t).T,
            work_re2(q, n_t, 8),
            f" (q = {q:,}, nT = {n_t}, float64, the dense A^-1 of phase 8's pedigree, random rule inputs; "
            + ("the generic form, its rule in torch; on the card alone: the sum of one profiled window's "
               "kernels over 10 calls" if n_t > random_scan.FAST_NT
               else "the cooperative form, its rule built in the prep launch; on the card alone: CUDA events "
               "around a graph of 20 calls"),
            graph_ms if n_t <= random_scan.FAST_NT else
            lambda kern: by_kernel(kern, 10, "14 f64", "corr_level_scan_f64 nT=5", quiet=True),
            with_library=n_t in RE2_F64_LIBRARY)
    for qs in RE2_F64_EDGES:
        for n_t in RE2_F64_NTS:
            a2 = tuple(t.double() for t in re2_inputs(qs, n_t, seed=qs + n_t))
            o, r = random_scan.corr_level_scan_kernel(*a2), random_scan.corr_level_scan_plain(*a2)
            e, sc = rel_err(o, r)
            same = torch.equal(o, random_scan.corr_level_scan_kernel(*a2))
            print(f"[14 f64] corr_level_scan_f64 at q = {qs:,}, nT = {n_t}: max_abs_err {e:.3e} (scale {sc:.3e}); "
                  f"two launches {'bit-identical' if same else 'DIFFER'}")
            check(e <= TOL_F64 * sc and same, f"corr_level_scan_f64 at q = {qs}, nT = {n_t} disagrees")
    return out


def f64_random_specs(geno, y, ainv, u1, x, u2, prior_a2=V_A2):
    """BayesR+A (y + u1, an animal effect on ainv) and BayesR+A2 (y + u1 + x
    u2, an (intercept, slope) animal group on ainv) over the panel geno,
    one animal a row."""
    base = method_spec(geno, y, "BayesR")
    eye = np.eye(geno.shape[0])
    spec_a = replace(base, y=y + u1, random=[ngt.RandomTerm("A", eye, prior=ngt.Random("A", VAR_A), ivstr=ainv)])
    spec_a2 = replace(base, y=y + u1 + x * u2, random=[ngt.RandomTerm(
        ("A", "S"), (eye, eye * x[:, None]), prior=ngt.Random("A", prior_a2), ivstr=ainv)])
    return spec_a, spec_a2


def f64_random_chains():
    """14h: BayesR+A and BayesR+A2 (V=96) at a smaller depth, 2,000
    individuals on phase 4's generator (49,152 loci) and a pedigree of 2,000
    animals (five generations of F64_RANDOM's 400): 10 float64 sweeps of
    the kernel chain against the float64 plain chain on one KeyedStream
    (f64_chain_vs_plain). Returns {run: (launches, numbers)}."""
    gs = F64_RANDOM["gen_size"]
    n = GENS * gs
    small, _, y_small, _, _ = simulate_panel(n, P)
    ped, u1 = simulate_pedigree(GENS, gs, seed=13)
    u2 = 0.5 * u1 + 0.75 ** 0.5 * henderson_values(ped, GENS, gs, np.random.default_rng(14))
    x = np.random.default_rng(15).normal(size=n)
    spec_a, spec_a2 = f64_random_specs(small, y_small, pedigree.a_inverse(ped), u1, x, u2)
    out = {}
    for tag, spec, scan in (("BayesR+A", spec_a, "level_scan"), ("BayesR+A2", spec_a2, "corr_level_scan")):
        out[tag] = f64_chain_vs_plain(spec, V_MAIN, F64_RANDOM["sweeps"], f"f64 {tag} {n:,} x {P:,}",
                                      random=scan)
    return out


def f64_random_path(tag, spec, V, truth, truth_name, corr_group=False, ebv_limit=None, marker_truth=None):
    """14i: one random-effect path in float64 at full width, as random_path
    and corr_path run it from one KeyedStream: N_CHAIN_RE sweeps eager (a
    loop of make_sweep, launches counted) and replayed (run_lmem), the same
    bits; drift < 1e-9 of max|y|, finite draws, varU > 0 (every kept
    covariance positive definite for a group), the posterior-mean u against
    the planted values (held to ebv_limit where given, else printed), the
    marker EBV printed; then the steady ms/sweep of both arms, the replays'
    device busy and idle share, and the float32 replayed sweep of the same
    model beside them. Returns (eager launches, numbers)."""
    ph, dt = f"14 {tag}", torch.float64
    plan, st0 = ngt.assemble(spec, vshards=V, dtype=dt)
    name = plan.random[0].name if isinstance(plan.random[0].name, str) else "_".join(plan.random[0].name)
    scan = "corr_level_scan_f64" if corr_group else "level_scan_f64"
    stream = keyed.KeyedStream(7, DEV, dt)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    st, kept = st0, []
    t0 = time.perf_counter()
    for i in range(1, N_CHAIN_RE + 1):
        st = sweep(st, stream)
        if i > N_BURN_RE and (i - N_BURN_RE) % N_THIN_RE == 0:
            kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    check(launches[scan] == N_CHAIN_RE and not any(v for k, v in launches.items()
                                                   if v and not k.endswith("_f64") and k != "keyed_rng"),
          f"{tag}: float64 eager launches {launches}")
    eager = {k: torch.stack([s[k] for s in kept]) for k in kept[0]}
    res = ngt.run_lmem(spec, n_chain=N_CHAIN_RE, n_burn=N_BURN_RE, n_thin=N_THIN_RE, out_folder=None, vshards=V,
                       stream=stream, dtype=dt)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), res.draws[k])]
    check(set(res.draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(res.state.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad, f"{tag}: kept draws of {bad} are not finite")
    var_u = res.draws[f"varU{name}"]
    if corr_group:
        pd = (torch.linalg.cholesky_ex(torch.from_numpy(var_u).reshape(-1, 2, 2))[1] == 0).all().item()
        check(pd, f"{tag}: a kept varU draw is not positive definite")
    else:
        check((var_u > 0).all(), f"{tag}: varU not > 0")
    drift = (corr_drift if corr_group else residual_drift)(res.plan, res.state)
    check(drift < 1e-9, f"{tag}: float64 ycorr drifted {drift:.3e} of max|y|")
    u_mean = torch.from_numpy(res.posterior_mean(f"u{name}")).to(DEV)
    cs = [corr(u_mean[t, :2048] if corr_group else u_mean[:2048], tr[:2048]) for t, tr in enumerate(truth)]
    shown = ", ".join(f"{c:.4f}" for c in cs)
    print(f"[{ph}] float64, {N_CHAIN_RE} sweeps eager and replayed from one KeyedStream: kept draws and ycorr "
          f"bit-identical; drift {drift:.3e} of max|y| (limit 1e-9); varU mean {np.round(var_u.mean(0), 4).tolist()}; "
          f"corr(posterior-mean u, {truth_name}) over 2,048 individuals {shown} "
          f"({'printed only' if ebv_limit is None else f'limit {ebv_limit}'}); eager launches "
          f"{({k: v for k, v in launches.items() if v})}")
    check(ebv_limit is None or min(cs) >= ebv_limit, f"{tag}: u correlation {shown} below {ebv_limit}")
    if plan.markers:
        gv = ngt.genomic_values_state(plan, res.state, beta=res.posterior_mean("betaM1"))
        print(f"[{ph}] marker EBV corr with the planted marker signal over 2,048 individuals "
              f"{corr(gv[:2048], marker_truth[:2048]):.4f} (printed only)")
    rep = engine_sweep.ReplayedSweep(plan, res.state, stream)
    state = [res.state]

    def eager_step():
        state[0] = sweep(state[0], stream)

    ms_eager = steady_ms(eager_step, 20)
    ms_replay = steady_ms(lambda: rep.run(1), 20)
    busy, per_sweep, missed, _, ms_by = replay_window(rep, 10)
    scan_ms = sum(v for k, v in ms_by.items() if "prep_kernel" in k or "scan_kernel" in k)
    del rep, state, res, st, st0, plan
    plan32, st32 = ngt.assemble(spec, vshards=V, dtype=torch.float32)
    rep32 = engine_sweep.ReplayedSweep(plan32, st32, keyed.KeyedStream(7, DEV, torch.float32))
    ms32 = steady_ms(lambda: rep32.run(1), 20)
    busy32 = replay_window(rep32, 10)[0]
    del rep32, plan32, st32
    print(f"[{ph}] steady, 20 sweeps between CUDA events: float64 eager {ms_eager:.4f} ms/sweep, replayed "
          f"{ms_replay:.4f} ms/sweep (eager loop {N_CHAIN_RE / eager_s:.2f} sweeps/s, host clock); 10 replays "
          f"under the profiler: device busy {busy:.4f} ms/sweep ({scan_ms:.4f} of it in the level scan's "
          f"launches), {per_sweep} kernels and copies a sweep ({missed} records missed), idle share "
          f"{1.0 - busy / ms_replay:.4f}; the float32 replayed sweep of the same model in this call "
          f"{ms32:.4f} ms/sweep, busy {busy32:.4f}")
    return launches, dict(eager_ms_per_sweep=ms_eager, replay_ms_per_sweep=ms_replay, replay_busy_ms_per_sweep=busy,
                          level_scan_busy_ms=scan_ms, idle_share=1.0 - busy / ms_replay, drift=drift, corr_u=cs,
                          f32_replay_ms_per_sweep=ms32, f32_replay_busy_ms_per_sweep=busy32)


def f64_random_paths(geno, y, sig, ped, ainv, u1):
    """14i: BayesR+A and GBLUP on phase 8's 10,000 animals and BayesR+A2 on
    phase 9's group, each f64_random_path at full width (BayesR+A and
    BayesR+A2 at V=96, GBLUP at V=1). Returns ({run: launches}, numbers)."""
    counted, out = {}, {}
    rng = np.random.default_rng(23)
    x = rng.normal(size=N)
    u2 = 0.5 * u1 + 0.75 ** 0.5 * henderson_values(ped, GENS, GEN_SIZE_A, np.random.default_rng(24))
    spec_a, spec_a2 = f64_random_specs(geno, y, ainv, u1, x, u2)
    u1_dev, u2_dev = (torch.from_numpy(v).to(DEV) for v in (u1, u2))
    counted["f64 keyed BayesR+A"], out["BayesR+A"] = f64_random_path(
        "BayesR+A", spec_a, V_MAIN, (u1_dev,), "planted polygenic u", marker_truth=sig)
    counted["f64 keyed BayesR+A2"], out["BayesR+A2"] = f64_random_path(
        "BayesR+A2", spec_a2, V_MAIN, (u1_dev, u2_dev), "planted intercept and slope", corr_group=True,
        marker_truth=sig)
    del spec_a, spec_a2
    t0 = time.perf_counter()
    ginv = ngt.make_g_inverse(geno.double())
    torch.cuda.synchronize()
    print(f"[14 GBLUP] G^-1 of the {N:,} x {P:,} panel (make_g_inverse, float64 on the card) in "
          f"{time.perf_counter() - t0:.2f} s")
    spec_g = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))], random=[
        ngt.RandomTerm("G", np.eye(N), prior=ngt.Random("G", VAR_A), ivstr=ginv)])
    del ginv
    counted["f64 keyed GBLUP"], out["GBLUP"] = f64_random_path(
        "GBLUP", spec_g, 1, (sig,), "the planted genetic value", ebv_limit=GBLUP_EBV_LIMIT)
    return counted, out


def level_turns(ainv32, ainv64):
    """14j: RE1 and RE2 (nT = 2) on the card alone at q = 10,000 on phase 8's
    A^-1, the float32 instance (P) and the float64 one (C) in turns P, C, C, P
    (graph_ms: CUDA events around a graph of 20 calls). Returns {kernel: [P,
    C, C, P]}."""
    arms = {}
    for dt, ainv in ((torch.float32, ainv32), (torch.float64, ainv64)):
        q = ainv.shape[0]
        g = torch.Generator(device=DEV).manual_seed(30)
        yi, z, u = (torch.randn(q, generator=g, dtype=dt, device=DEV) for _ in range(3))
        a1 = (ainv, yi, torch.rand(q, generator=g, dtype=dt, device=DEV) * 3, z, u,
              torch.tensor(1 / 1.7, dtype=dt, device=DEV), torch.tensor(0.6, dtype=dt, device=DEV))
        a2 = tuple(t.to(dt) for t in re2_inputs(q, 2, ainv, seed=2))
        arms[dt] = {"RE1": lambda a1=a1: random_scan.level_scan_kernel(*a1),
                    "RE2 nT=2": lambda a2=a2: random_scan.corr_level_scan_kernel(*a2)}
    out = {}
    for name in ("RE1", "RE2 nT=2"):
        out[name] = [graph_ms(arms[dt][name]) for dt in (torch.float32, torch.float64, torch.float64, torch.float32)]
        shown = ", ".join(f"{t:.4f}" for t in out[name])
        print(f"[14 f64] {name} on the card alone (a graph of 20 calls), q = 10,000, turns f32 / f64 / f64 / f32 "
              f"(ms): {shown}")
    return out


def f64_random_phase(geno, y, sig):
    """14g-14j: the float64 level scans (RE1, RE2) and the random-effect
    models through them. Returns (numbers, launches by run)."""
    t0 = time.perf_counter()
    out, counted = {}, {}
    out["14g build"] = level_build()
    t1 = time.perf_counter()
    ped, u1, ainv = phase8_pedigree()
    ainv64 = torch.as_tensor(ainv, dtype=torch.float64, device=DEV)
    print(f"[14 f64] the build's report in {t1 - t0:.2f} s; phase 8's pedigree and dense A^-1 in "
          f"{time.perf_counter() - t1:.2f} s")
    out["14g"] = f64_level_kernels(ainv64)
    for tag, (launches, rec) in f64_random_chains().items():
        counted[f"f64 {tag} small"], out[f"14h {tag}"] = launches, rec
    by_run, out["14i"] = f64_random_paths(geno, y, sig, ped, ainv, u1)
    counted.update(by_run)
    out["14j"] = level_turns(ainv64.float(), ainv64)
    out["seconds 14g-14j"] = time.perf_counter() - t0
    print(f"[14 f64] 14g-14j in {out['seconds 14g-14j']:.1f} s")
    return out, counted


# 14k-14o: K12, K14, CM1 and CM1r in float64
F64_SMALL_RC = dict(n=2_000, p=V_MAIN * BLOCK)  # 14m: BayesRCpi and BayesRCplus at V=96, one step of 96 blocks
F64_CORR = dict(n=2_000, p_v96=V_MAIN * BLOCK, p_v1=8_192)  # 14m: MultiBreed at V=96 (one step) and at V=1 (32)
F64_RC_REPLAYED = (("BayesRCpi", V_MAIN), ("BayesRCplus", V_MAIN), ("BayesRCpi", 1))  # 14n, at full width
F64_CORR_CHAIN = dict(n_chain=40, n_burn=20, n_thin=5)  # 14n: MultiBreed at full width, eager and replayed
RC_BITS_SHAPES = ((V_MAIN, 256, 3, 3), (V_MAIN, 256, 1, 1), (V_MAIN, 256, 8, 4), (1, 256, 3, 3), (3, 40, 11, 3))
CM1_BITS_SHAPES = ((V_MAIN, 256), (1, 256), (8, 1000))  # 14o: (V, B) of CM1 at nT = 1 .. 5 and CM1r at 1 .. 4


def rc_corr_build():
    """14k: build_report of K12's and K14's instances (float32 and float64,
    blocks of up to 256 and of 1,024 threads), CM1's (nT = 1 .. 4 by block
    size, and its generic form) and CM1r's (nT = 1 .. 4); then CM1's shared
    memory as the library states it (ngt_corr_block_step_smem_bytes)
    against ops/corr_scan's counterpart."""
    def instance(mangled):
        tp = {"f": "f32", "d": "f64"}
        m = re.search(r"RcRuleILi([01])E([fd])E+Li(\d+)E", mangled)
        if m:
            return f"{'K12' if m.group(1) == '0' else 'K14'} {tp[m.group(2)]} MAXT={m.group(3)}"
        m = re.search(r"corr_scan_kernelILi(\d)ELi(\d+)E([fd])E", mangled)
        if m:
            return f"CM1 {tp[m.group(3)]} nT={m.group(1)} MAXT={m.group(2)}"
        m = re.search(r"corr_scan_generic_kernelI([fd])E", mangled)
        if m:
            return f"CM1 generic {tp[m.group(1)]}"
        m = re.search(r"corr_rule_kernelILi(\d)E([fd])E", mangled)
        return f"CM1r {tp[m.group(2)]} nT={m.group(1)}" if m else None

    out = build_report(instance, "14k K12/K14/CM1/CM1r", 34)
    lib = _cuda.lib()
    smem = {(n_t, B, f64): lib.ngt_corr_block_step_smem_bytes(n_t, B, f64)
            for n_t in range(1, 6) for B in (32, 96, 256, 1000, 1024) for f64 in (0, 1)}
    bad = {k: v for k, v in smem.items() if v != corr_scan.block_step_smem_bytes(k[0], k[1], 8 if k[2] else 4)}
    check(not bad, f"14k: CM1's shared memory in csrc/corr_scan.cu {bad} is not what "
                   "ops/corr_scan.block_step_smem_bytes states")
    print(f"[14 f64] CM1's shared memory by (nT, B, float64), as the kernel and the wrapper state it: {smem}")
    return out


def f64_cm1(plan, st, tag):
    """14l: CM1's float64 instance against its float64 plain block-step on a
    CM1Case of the float64 MultiBreed state (V as assembled), within TOL_F64
    of beta's and u's scale, the same bits twice and the buffer's other
    steps untouched, timed on the card alone (profiler and a graph of 20
    calls) beside its float64 bound and the library's batched float64
    triangular solve of the same systems; at V > 1 also CM1r's float64
    instance against the float64 torch pack. Returns the numbers."""
    case = CM1Case(plan, st)
    cs, cp = st.corr_markers[0], plan.corr_markers[0]
    n_t, V, B = case.n_t, case.V, case.B
    name = f"corr_block_scan_v{tag}_f64"
    ref = torch.zeros_like(case.beta)

    def kern():
        return corr_scan.corr_block_step_kernel(case.gram_t, case.pk_g, *case.fold(), case.beta)

    def plain():
        return corr_scan.corr_block_step_plain(cs.gram[0], case.pk_g, 0, *case.fold(), ref)

    u, (ru, ms_p) = kern(), timed_once(plain)
    b = case.beta[:, 0].clone()
    check(u.dtype == b.dtype == torch.float64 and torch.isfinite(b).all().item() and torch.equal(u, kern())
          and torch.equal(b, case.beta[:, 0]), f"{name}: not float64 and finite, or two runs differ")
    check(not case.beta[:, 1:].any().item(), f"{name}: wrote outside its step of the beta buffer")
    e, sc = rel_err(b, ref[:, 0])
    eu, scu = rel_err(u, ru)
    check(eu <= TOL_F64 * scu, f"{name}: u max_abs_err {eu:.3e} of {scu:.3e}")
    mat, rhs = corr_scan.corr_block_system(cs.gram[0], case.rows, n_t)

    def library():
        return torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)

    e_l, _ = rel_err(library().view(V, B, n_t), ru)
    check(mat.dtype == torch.float64 and e_l <= TOL_F64 * scu, f"{name}: the library solve differs by {e_l:.3e}")
    report(name, e, sc, TOL_F64, median_ms(kern, 20), ms_p, work_cm1(V, B, n_t, 8),
           f" (V = {V}, B = {B}, nT = {n_t}, float64, the MultiBreed panels' Gram, the rule's rows of a random "
           f"state with r0, the step's centres and sum(y) folded in; u max_abs_err {eu:.3e} of {scu:.3e}; the "
           f"plain version timed by one call; the library's batched float64 solve's max_abs_err {e_l:.3e}, its "
           "systems built outside the timed window)", phase="14 f64", dev_ms=device_ms(kern, 20),
           flops=F64_FLOP_PER_S, library_ms=median_ms(library, 20),
           library_dev_ms=device_ms(library, 20, records_per_launch=0))
    TIMINGS[name]["graph_ms"] = graph_ms(kern)
    print(f"[14 f64] {name} on the card alone: profiler {TIMINGS[name]['device_ms']} ms, events around a graph "
          f"of 20 calls {TIMINGS[name]['graph_ms']:.4f} ms")
    out = {name: dict(device_ms=TIMINGS[name]["device_ms"], graph_ms=TIMINGS[name]["graph_ms"], max_abs_err=e,
                      scale=sc, library_device_ms=TIMINGS[name]["library_device_ms"])}
    if V == 1:
        return out

    def rule():
        return corr_scan.corr_rule_kernel(*case.rule_args)

    def rule_plain():
        return corr_scan.corr_rule_plain(*case.rule_args)

    W = corr_scan.pack_width(n_t)
    o, r = rule(), rule_plain()
    check(o.dtype == torch.float64 and torch.equal(o, rule()) and torch.isfinite(o).all().item(),
          "corr_rule_f64: not float64 and finite, or two runs differ")
    check(torch.equal(o[:, n_t:2 * n_t], r[:, n_t:2 * n_t]), "corr_rule_f64: bold not copied")
    errs = {part: rel_err(o[:, sl], r[:, sl])
            for part, sl in (("adj", slice(0, n_t)), ("c", slice(2 * n_t, 3 * n_t)), ("M", slice(3 * n_t, W)))}
    for part, (ep, sp) in errs.items():
        check(ep <= TOL_F64 * sp, f"corr_rule_f64: {part} within {ep:.3e} of {sp:.3e}")
    e_r, s_r = max(errs.values(), key=lambda v: v[0] / v[1])
    dev_p = device_ms(rule_plain, 20, records_per_launch=0)
    report("corr_rule_f64", e_r, s_r, TOL_F64, median_ms(rule, 20), median_ms(rule_plain, 20),
           work_rule(cp.p_pad, cp.n_regions, n_t, 8),
           f" (p = {cp.p_pad:,} loci, {cp.n_regions} regions, nT = {n_t}, float64: adj, c, M within "
           + ", ".join(f"{k} {v[0]:.3e} of {v[1]:.3e}" for k, v in errs.items())
           + f"; the float64 torch pack on the card alone {dev_p} ms)", phase="14 f64", dev_ms=device_ms(rule, 20),
           flops=F64_FLOP_PER_S)
    TIMINGS["corr_rule_f64"]["graph_ms"] = graph_ms(rule)
    print(f"[14 f64] corr_rule_f64 on the card alone: profiler {TIMINGS['corr_rule_f64']['device_ms']} ms, events "
          f"around a graph of 20 calls {TIMINGS['corr_rule_f64']['graph_ms']:.4f} ms")
    out["corr_rule_f64"] = dict(device_ms=TIMINGS["corr_rule_f64"]["device_ms"],
                                graph_ms=TIMINGS["corr_rule_f64"]["graph_ms"], plain_device_ms=dev_p,
                                errors={k: v[0] for k, v in errs.items()})
    return out


def f64_rc_corr_kernels(geno, y, spec_corr):
    """14l: K12's and K14's float64 instances at phase 3's shapes (rc_kernels:
    V=96 with the floors and A = 8, K = 4, and V=1) on the BayesRCpi model of
    phase 14's panel, and CM1's and CM1r's at phase 9's (f64_cm1 on
    MultiBreed's 10,000 x 49,152 panels at V=96 and V=1)."""
    z = torch.randn(P, generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    for V, tag in ((V_MAIN, ""), (1, "_v1")):
        rc_kernels(lambda path: method_spec(geno, y, path), z, V, tag, dtype=torch.float64, full=V == V_MAIN)
    out = {}
    for V, tag in ((V_MAIN, ""), (1, "_v1")):
        plan, st = ngt.assemble(spec_corr, vshards=V, dtype=torch.float64)
        check(st.corr_markers[0].gram.dtype == torch.float64, "14l: the float64 MultiBreed Gram is not float64")
        out.update(f64_cm1(plan, st, tag))
        del plan, st
    return out


def f64_corr_chain_vs_plain(spec, V, n, tag):
    """14m: n float64 sweeps of MultiBreed's kernel chain against its float64
    plain chain (plain_sweep_kernels) on one KeyedStream: both sets' beta
    and ycorr within TOL_F64_CHAIN of scale; the kernel chain launches K1,
    CM1 and K2 a block-step and CM1r a sweep, all float64, and nothing else
    but R1; the plain chain none of them."""
    plan, st, counted = f64_sweeps(spec, V, n)
    T = plan.corr_markers[0].n_blocks // V
    path_kernels = {"pack2_matvec_f64": n * T, "pack2_rank_update_f64": n * T, "corr_block_scan_v_f64": n * T,
                    "corr_rule_f64": n}
    expect = {k: 0 for k in counted}
    expect.update(path_kernels, keyed_rng=counted["keyed_rng"])
    check(counted == expect, f"{tag}: kernel chain launches {counted}")
    t0 = time.perf_counter()
    with plain_sweep_kernels():
        _, sp, plain_counted = f64_sweeps(spec, V, n)
    plain_s = time.perf_counter() - t0
    check(not any(v for k, v in plain_counted.items() if k != "keyed_rng"),
          f"{tag}: the plain chain launched {plain_counted}")
    e_b, s_b = rel_err(st.corr_markers[0].beta, sp.corr_markers[0].beta)
    e_y, s_y = rel_err(st.ycorr, sp.ycorr)
    e_v, s_v = rel_err(st.corr_markers[0].var_beta, sp.corr_markers[0].var_beta)
    print(f"[14 {tag}] {n} float64 sweeps of one KeyedStream, kernel chain against plain chain: beta {e_b:.3e} "
          f"of scale {s_b:.3e}, ycorr {e_y:.3e} of scale {s_y:.3e}, the regions' covariances {e_v:.3e} of scale "
          f"{s_v:.3e} (limit {TOL_F64_CHAIN:g} x scale); the plain chain took {plain_s:.1f} s; kernel launches "
          f"{path_kernels}")
    check(e_b <= TOL_F64_CHAIN * s_b and e_y <= TOL_F64_CHAIN * s_y and e_v <= TOL_F64_CHAIN * s_v,
          f"{tag}: the float64 kernel chain departs from the float64 plain chain")
    return counted, dict(beta_err=e_b, beta_scale=s_b, ycorr_err=e_y, ycorr_scale=s_y, var_beta_err=e_v,
                         plain_s=plain_s)


def f64_rc_corr_chains():
    """14m: 20 float64 sweeps of the kernel chain against the float64 plain
    chain for BayesRCpi and BayesRCplus at V=96 on a 2,000 x 24,576 panel
    (one step of 96 blocks: the plain scans loop over 256 loci a step) and
    MultiBreed at V=96 on two 2,000 x 24,576 panels and at V=1 on two
    2,000 x 8,192. Returns ({run: launches}, numbers)."""
    counted, out = {}, {}
    n, p = F64_SMALL_RC["n"], F64_SMALL_RC["p"]
    small, _, y_small, _, _ = simulate_panel(n, p)
    annot = annotations(p)[0]
    for path in ("BayesRCpi", "BayesRCplus"):
        prior = (ngt.BayesRCpi(annot=annot, estimatePi=True, **PRIOR_RC) if path == "BayesRCpi"
                 else ngt.BayesRCplus(annot=annot, **PRIOR_RC))
        counted[f"f64 {path} V={V_MAIN}"], out[f"14m {path} V={V_MAIN}"] = f64_chain_vs_plain(
            method_spec(small, y_small, path, prior), V_MAIN, F64_SWEEPS, f"f64 {path} V={V_MAIN} {n:,} x {p:,}", path)
    del small
    for V, p in ((V_MAIN, F64_CORR["p_v96"]), (1, F64_CORR["p_v1"])):
        spec, _ = simulate_corr(F64_CORR["n"], p)
        counted[f"f64 MultiBreed V={V}"], out[f"14m MultiBreed V={V}"] = f64_corr_chain_vs_plain(
            spec, V, F64_SWEEPS, f"f64 MultiBreed V={V} {F64_CORR['n']:,} x {p:,}")
        del spec
    return counted, out


def replayed_f32(spec, V):
    """The float32 replayed sweep of the model (KeyedStream): steady ms/sweep
    (events around 20 replays) and device busy (10 profiled replays)."""
    plan, st = ngt.assemble(spec, vshards=V, dtype=torch.float32)
    rep = engine_sweep.ReplayedSweep(plan, st, keyed.KeyedStream(7, DEV, torch.float32))
    ms = steady_ms(lambda: rep.run(1), 20)
    busy = replay_window(rep, 10)[0]
    del rep, plan, st
    return ms, busy


def f64_corr_replayed(tag, spec, V):
    """14n: MultiBreed in float64 at full width from one KeyedStream:
    F64_CORR_CHAIN's sweeps eager (a loop of make_sweep, launches counted)
    and replayed (run_lmem) with the same bits; drift < 1e-9 of max|y|,
    finite draws, every kept covariance positive definite; the steady
    replayed ms/sweep and device busy beside the float32 replayed sweep's.
    Returns (eager launches, numbers)."""
    ph, dt = f"14 {tag}", torch.float64
    n_chain, n_burn, n_thin = F64_CORR_CHAIN["n_chain"], F64_CORR_CHAIN["n_burn"], F64_CORR_CHAIN["n_thin"]
    plan, st0 = ngt.assemble(spec, vshards=V, dtype=dt)
    T = plan.corr_markers[0].n_blocks // V
    stream = keyed.KeyedStream(7, DEV, dt)
    sweep = ngt.make_sweep(plan)
    _cuda.reset_launches()
    st, kept = st0, []
    t0 = time.perf_counter()
    for i in range(1, n_chain + 1):
        st = sweep(st, stream)
        if i > n_burn and (i - n_burn) % n_thin == 0:
            kept.append(ngt.collect_sample(st, plan))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    expect = {k: 0 for k in launches}
    expect.update({"pack2_matvec_f64": n_chain * T, "pack2_rank_update_f64": n_chain * T,
                   "corr_block_scan_v_f64": n_chain * T, "corr_rule_f64": n_chain,
                   "keyed_rng": launches["keyed_rng"]})
    check(launches == expect and launches["keyed_rng"] > 0, f"{tag}: float64 eager launches {launches}")
    eager = {k: torch.stack([s[k] for s in kept]) for k in kept[0]}
    res = ngt.run_lmem(spec, n_chain=n_chain, n_burn=n_burn, n_thin=n_thin, out_folder=None, vshards=V,
                       stream=stream, dtype=dt)
    differ = [k for k in eager if not np.array_equal(eager[k].cpu().numpy(), res.draws[k])]
    check(set(res.draws) == set(eager) and not differ, f"{tag}: replayed draws {differ} differ from eager")
    check(torch.equal(res.state.ycorr, st.ycorr), f"{tag}: replayed ycorr differs from eager")
    bad = [k for k, a in res.draws.items() if not np.isfinite(a).all()]
    check(not bad, f"{tag}: kept draws of {bad} are not finite")
    for k, a in res.draws.items():
        if k.startswith("var") and a.ndim == 3:
            mats = torch.from_numpy(a).reshape(-1, 2, 2)
            check((torch.linalg.cholesky_ex(mats)[1] == 0).all().item(), f"{tag}: a kept {k} draw is not positive definite")
    drift = corr_drift(res.plan, res.state)
    check(drift < 1e-9, f"{tag}: float64 ycorr drifted {drift:.3e} of max|y|")
    rep = engine_sweep.ReplayedSweep(plan, res.state, stream)
    ms_replay = steady_ms(lambda: rep.run(1), 20)
    busy, per_sweep, missed, _, ms_by = replay_window(rep, 10)
    cm1_ms = sum(v for k, v in ms_by.items() if "corr_scan" in k or "corr_rule" in k)
    del rep, res, st, st0, plan
    ms32, busy32 = replayed_f32(spec, V)
    print(f"[{ph}] float64, {n_chain} sweeps eager and replayed from one KeyedStream: kept draws and ycorr "
          f"bit-identical; drift {drift:.3e} of max|y| (limit 1e-9); every kept covariance positive definite; "
          f"eager {n_chain / eager_s:.2f} sweeps/s (host clock); replayed {ms_replay:.4f} ms/sweep (events around "
          f"20 replays), device busy {busy:.4f} ms/sweep ({cm1_ms:.4f} of it in CM1 and CM1r), {per_sweep} kernels "
          f"and copies a sweep ({missed} records missed), idle share {1.0 - busy / ms_replay:.4f}; the float32 "
          f"replayed sweep of the same model in this call {ms32:.4f} ms/sweep, busy {busy32:.4f}")
    return launches, dict(replay_ms_per_sweep=ms_replay, replay_busy_ms_per_sweep=busy, cm1_busy_ms=cm1_ms,
                          idle_share=1.0 - busy / ms_replay, drift=drift, f32_replay_ms_per_sweep=ms32,
                          f32_replay_busy_ms_per_sweep=busy32)


def f64_rc_corr_replayed(geno, y, sig, spec_corr):
    """14n: BayesRCpi and BayesRCplus at V=96 and BayesRCpi at V=1 (phase 4's
    EBV limit 0.95) through graph_path in float64 at full width, each beside
    its float32 replayed sweep; MultiBreed at V=96 and V=1 through
    f64_corr_replayed. Returns ({run: launches}, numbers)."""
    counted, out = {}, {}
    for path, V in F64_RC_REPLAYED:
        spec = method_spec(geno, y, path)
        rec = graph_path(path, spec, sig, V, N_CHAIN, N_BURN, N_THIN, EBV_LIMITS.get((path, V)), tag=" f64",
                         dtype=torch.float64, phase="14", drift_limit=1e-9, n_window=50 if V == V_MAIN else 20)
        counted[f"f64 keyed {path} V={V}"] = rec.pop("eager_launches")
        rec["f32_replay_ms_per_sweep"], rec["f32_replay_busy_ms_per_sweep"] = replayed_f32(spec, V)
        print(f"[14 {path} f64 V={V}] replayed ms/sweep float64 {rec['replay_ms_per_sweep']:.4f}, float32 in this "
              f"call {rec['f32_replay_ms_per_sweep']:.4f} (busy {rec['replay_busy_ms_per_sweep']:.4f} / "
              f"{rec['f32_replay_busy_ms_per_sweep']:.4f})")
        out[f"14n {path} V={V}"] = rec
    for V in (V_MAIN, 1):
        counted[f"f64 keyed MultiBreed V={V}"], out[f"14n MultiBreed V={V}"] = f64_corr_replayed(
            f"MultiBreed f64 V={V}", spec_corr, V)
    return counted, out


def f64_rc_corr_phase(geno, y, sig):
    """14k-14n: the float64 instances of K12, K14, CM1 and CM1r and the
    models through them. Returns (numbers, launches by run)."""
    t0 = time.perf_counter()
    out, counted = {"14k build": rc_corr_build()}, {}
    spec_corr, _ = simulate_corr()
    out["14l"] = f64_rc_corr_kernels(geno, y, spec_corr)
    by_run, out["14m"] = f64_rc_corr_chains()
    counted.update(by_run)
    by_run, out["14n"] = f64_rc_corr_replayed(geno, y, sig, spec_corr)
    counted.update(by_run)
    out["seconds 14k-14n"] = time.perf_counter() - t0
    print(f"[14 f64] 14k-14n in {out['seconds 14k-14n']:.1f} s")
    return out, counted


def rc_bits_inputs(V, B, A, K, kind, seed):
    """Random float32 inputs of K12 (kind "rcpi") or K14 ("rcplus") at (V, B,
    A, K): a (1, B, V, B) Gram from random normals with a diagonal near 30,
    and coefficient rows from the port's pack (the first annotation on every
    locus, the last three loci of each chain padded)."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=DEV)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    m = min(2 * B, 256)
    a = randn(V, B, m)
    gram = (torch.einsum("vbn,vcn->bvc", a, a) * (30.0 / m))[None].contiguous()
    p = V * B
    mask = (torch.arange(B, device=DEV) < B - 3).repeat(V)
    anz = rand(p, A) < 0.5
    anz[:, 0] = True
    anz &= mask[:, None]
    varc = (0.5 + 1.5 * rand(A, 1)) * torch.cat([torch.zeros(1, device=DEV), 1e-3 + 0.1 * rand(K - 1)])
    common = dict(beta_old=0.1 * randn(p) * mask, mpm=torch.einsum("bvb->vb", gram[0]).reshape(-1) * mask,
                  lss=rand(p), rss=0.1 * randn(p), mask=mask, varc=varc,
                  logpi=torch.log_softmax(randn(A, K), dim=-1), ive=torch.tensor(0.7, device=DEV),
                  var_e=torch.tensor(1 / 0.7, device=DEV))
    if kind == "rcpi":
        pk = gibbs_kernels.rcpi_block_pack(
            z=randn(p), ua=rand(p), uv=rand(p), g1=torch._standard_gamma(anz.float().clamp(min=1e-6), generator=g),
            g2=torch._standard_gamma(anz.float() + 1.0, generator=g), aprob=anz / anz.sum(-1, keepdim=True).clamp(min=1),
            anz=anz, **common)
    else:
        pk = gibbs_kernels.rcplus_block_pack(z=randn(p, A), ua=rand(p, A), anz=anz, **common)
    pk = pk.reshape(V, B, -1).contiguous()
    pk[:, :, 0] += 5.0 * randn(V, B)
    return gram, pk


def cm1_bits_inputs(V, B, n_t, seed):
    """Random float32 inputs of CM1 and CM1r at (V, B, nT): the rule's
    arguments for V B loci (seven regions, the last four loci padded), a
    step's (B, nT, V, B, nT) Gram from random dosages, and the fold's r0,
    centres and sum(y)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    p = V * B
    bold, z = (torch.randn(p, n_t, generator=g, device=DEV) * s for s in (0.1, 1.0))
    x = torch.randn(p, 40, n_t, generator=g, device=DEV)
    mpm = torch.einsum("lkt,lku->ltu", x, x).contiguous()
    m = torch.randn(7, n_t, n_t, generator=g, device=DEV)
    var_beta = (m @ m.transpose(1, 2) / n_t * 0.01 + 0.01 * torch.eye(n_t, device=DEV)).contiguous()
    region = torch.randint(0, 8, (p,), generator=g, device=DEV, dtype=torch.int32)
    mask = torch.arange(p, device=DEV) < p - 4
    rule = (bold, z, var_beta, region, mpm, mask, torch.tensor(1.3, device=DEV))
    X = torch.randint(0, 3, (V, B, n_t, 200), generator=g, device=DEV).float()
    X = X - X.mean(-1, keepdim=True)
    gram = torch.einsum("vjtn,vkwn->jtvkw", X, X)[None].contiguous()
    r0, cb = (torch.randn(V, B, n_t, generator=g, device=DEV) for _ in range(2))
    return rule, gram, (r0, cb, torch.tensor(2.5, device=DEV))


@contextlib.contextmanager
def kernels_of(lib):
    """The scan wrappers (gibbs_kernels) launch through lib's C interface."""
    saved, _cuda._lib = _cuda._lib, lib
    try:
        yield
    finally:
        _cuda._lib = saved


def f32_turns(lib):
    """14o: this tree's float32 K12 and K14 (phase 3's A = K = 3 at B = 256,
    V = 96 and 1), CM1 (nT = 2, MultiBreed's, V = 96 and 1) and CM1r (nT =
    2, 96 x 256 loci) and another build's (lib), each through this tree's
    launcher on the same inputs, in turns P (lib), C, C, P: the mean time
    on the card alone of 20 calls. Returns {kernel: [P, C, C, P] ms}."""
    calls = [0]
    arms = {}
    for V in (V_MAIN, 1):
        for kind in ("rcpi", "rcplus"):
            gram, pk = rc_bits_inputs(V, 256, 3, 3, kind, V + 7)
            scan = getattr(gibbs_kernels, f"{kind}_block_scan_v")

            def rc(L, scan=scan, gram=gram, pk=pk):
                with kernels_of(L):
                    return scan((gram, 0), pk, 3, 3)
            arms[f"{kind} V={V}"] = rc
        rule, gram, fold = cm1_bits_inputs(V, 256, 2, V + 2)
        pk_g = corr_scan.corr_rule_plain(*rule).view(V, 1, 256, -1)
        beta = torch.zeros((V, 1, 256, 2), device=DEV)
        step = ((gram, 0), pk_g, *fold, beta)
        arms[f"CM1 V={V}"] = lambda L, step=step: corr_scan.corr_block_step_with(L, *step)
        if V > 1:
            arms[f"CM1r V={V}"] = lambda L, rule=rule: corr_scan.corr_rule_with(L, *rule)
    out = {}
    for name, go in arms.items():
        out[name] = []
        for arm in "PCCP":
            L = lib if arm == "P" else _cuda.lib()

            def fn(go=go, L=L):
                calls[0] += 1
                return go(L)
            out[name].append(device_ms(fn, 20, calls=lambda: calls[0]))
    print("[14o] float32 K12, K14, CM1 and CM1r, ms on the card alone in turns P (the other build), C, C, P: "
          + "; ".join(f"{k} " + " / ".join(str(v) for v in rows) for k, rows in out.items()))
    return out


def f32_bits_vs(src):
    """14o (`f64 DIR`): this tree's float32 K12, K14, CM1 and CM1r against
    DIR's (another tree's csrc/, rc_scan.cu and corr_scan.cu built alone
    with this tree's flags and called through its own C interface), on the
    same inputs: every output bit for bit. K12 and K14 at RC_BITS_SHAPES
    (phase 3's main shape, the floors, A = 8, K = 4, V=1, the rule on one
    thread), CM1 (nT = 1 .. 5) and CM1r (nT = 1 .. 4) at CM1_BITS_SHAPES;
    then both timed in turns (f32_turns)."""
    label, so, proc = start_build(src, "f32_bits", ["rc_scan.cu", "corr_scan.cu"])
    lib = finish_build(label, so, proc)
    ptr, num = ctypes.c_void_p, ctypes.c_longlong
    lib.ngt_rcpi_block_scan_v.argtypes = [ptr] * 7 + [num] * 4 + [ptr]
    lib.ngt_rcplus_block_scan_v.argtypes = [ptr] * 8 + [num] * 4 + [ptr]
    _cuda.bind_cm1(lib)
    same = {}
    for V, B, A, K in RC_BITS_SHAPES:
        for kind in ("rcpi", "rcplus"):
            gram, pk = rc_bits_inputs(V, B, A, K, kind, V + B + A + K)
            scan = getattr(gibbs_kernels, f"{kind}_block_scan_v")
            ours = scan((gram, 0), pk, A, K)
            with kernels_of(lib):
                theirs = scan((gram, 0), pk, A, K)
            torch.cuda.synchronize()
            same[f"{kind} V={V} B={B} A={A} K={K}"] = all(torch.equal(a, b) for a, b in zip(ours, theirs))
    for V, B in CM1_BITS_SHAPES:
        for n_t in range(1, 6):
            rule, gram, fold = cm1_bits_inputs(V, B, n_t, V + B + n_t)
            pk = corr_scan.corr_rule_plain(*rule)
            if n_t <= corr_scan.FAST_NT:
                ours, theirs = (corr_scan.corr_rule_with(L, *rule) for L in (_cuda.lib(), lib))
                same[f"rule V={V} B={B} nT={n_t}"] = torch.equal(ours, theirs)
                pk = ours
            pk_g = pk.view(V, 1, B, -1)
            outs = []
            for L in (_cuda.lib(), lib):
                beta = torch.zeros((V, 1, B, n_t), device=DEV)
                outs.append((corr_scan.corr_block_step_with(L, (gram, 0), pk_g, *fold, beta), beta))
            torch.cuda.synchronize()
            same[f"CM1 V={V} B={B} nT={n_t}"] = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"[14o] float32 K12, K14, CM1 and CM1r of this tree against {label}'s build, on the same inputs: "
          + ", ".join(f"{k} {'bit-identical' if v else 'DIFFER'}" for k, v in same.items()))
    check(all(same.values()), f"14o: float32 outputs differ from {label}'s: {[k for k, v in same.items() if not v]}")
    return dict(bits=same, turns_ms=f32_turns(lib))


def levels_only(card, other_src=None):
    """`python3 chip_smoke.py levels [DIR]`: RE1 and RE2 alone, the quick form
    for work on csrc/level_scan.cu: ptxas's and the SASS's report of every
    instance (14g), phase 9.1 (RE2 in float32 at q = 10,000 on phase 8's
    A^-1 for nT = 1, 2, 3 and at its edges, beside RE1) and 14g (both
    float64 instances); with DIR (another tree's csrc/, built alone with its
    own C interface), RE1 at q = 10,000 and 3,001 and RE2 at nT = 1, 2, 3
    also against DIR's in float32, bit for bit, and in turns P, C, C, P. One
    JSON line of its numbers, and no result line."""
    _, _, ainv_np = phase8_pedigree()
    ainv = torch.as_tensor(ainv_np, dtype=torch.float32, device=DEV)
    out = {"build": level_build()}
    other2 = None if other_src is None else other_corr_level_scan(other_src)
    out["RE2"] = re2_phase(ainv, other2)
    if other_src is not None:
        q = ainv.shape[0]
        g = torch.Generator(device=DEV).manual_seed(30)
        yi, z, u = (torch.randn(q, generator=g, device=DEV) for _ in range(3))
        args = (ainv, yi, torch.rand(q, generator=g, device=DEV) * 3, z, u, torch.tensor(1 / 1.7, device=DEV),
                torch.tensor(0.6, device=DEV))
        out["RE1 arms"] = re1_arms(other_level_scan(other_src),
                                   [(f"q = {q:,}", args), ("q = 3,001", re1_inputs(3001, *args[5:]))])
    out["14g"] = f64_level_kernels(torch.as_tensor(ainv_np, dtype=torch.float64, device=DEV))
    print(json.dumps({"card": card, "levels": out,
                      "timings": {k: v for k, v in TIMINGS.items() if "level_scan" in k}}))


def f64_only(card, other_src=None):
    """`python3 chip_smoke.py f64 [DIR]`: phase 14 alone; with DIR (another
    tree's csrc/, e.g. a `git archive` of the parent under `_checkout/`),
    first 14o: this tree's float32 K12, K14, CM1 and CM1r against DIR's, bit
    for bit and in turns (f32_bits_vs). One JSON line of its numbers, the kernels' times
    and launch counts, and no result line."""
    bits = None if other_src is None else f32_bits_vs(other_src)
    out, counted = f64_phase()
    if bits is not None:
        out["14o"] = bits
    print(json.dumps({"card": card, "f64": out, "launches": counted,
                      "timings": {k: v for k, v in TIMINGS.items() if k.endswith("_f64")}}))


# ------------------------------------------------------------------ phase 15

# 15a: replayed BayesR sweeps at every divisor V of the block count, at these
# (n, p): the main path, 50,000 individuals, a block count with odd divisors
# (196 = 2^2 7^2) and a wide panel (nb = 2,304), taken from V = VRULE_WIDE_FROM
# (below it a sweep runs 288 and more block-steps: plainly slower); then the
# main path in float64. The table the rule's cost is read from: the rule has
# no speed part (a block-step costs ~0.06 ms wherever it runs, so the fastest
# V is at or next to T = 1, which the gate refuses)
VRULE_SHAPES = ((N, P), (N_50K, P), (N, 50_000), (N, 589_824))
VRULE_WIDE_P, VRULE_WIDE_FROM = 589_824, 8
VRULE_REPLAYS, VRULE_RUNS = 20, 3  # replays between CUDA events a run; runs a V, their median kept
# 15b: 100 replayed sweeps of each method at these V on the main path's panel,
# which the caps are read from, and on the CLI's 2,000 x 8,192 (nb 32), which
# holds the rule's scaling by records; (method, V) is admitted where the
# posterior-mean varE is within GATE_VAR_E (relative) of the V = 1 chain's
# and the EBV correlation at least V = 1's minus GATE_EBV (fixed before the
# first run)
VRULE_GATES = {(N, P): (1, 8, 32, V_MAIN, P // BLOCK), (CLI_N, CLI_P): (1, 2, 4, 8, 16, CLI_P // BLOCK)}
VRULE_METHODS = ("BayesR", "BayesB", "BayesC", "BayesC+D", "BayesPR", "BayesRCpi", "BayesRCplus", "BayesLV")
GATE_VAR_E, GATE_EBV = 0.10, 0.01


def divisors(nb, least=1):
    return [v for v in range(least, nb + 1) if nb % v == 0]


def rule_picks(nb, n):
    """What vshards="auto" gives each method for a set of nb blocks of
    BLOCK loci on n records (engine/plan._card_vshards)."""
    from nextgp_tpu_torch.engine import plan as engine_plan

    return {path: engine_plan._card_vshards(nb, BLOCK, n, path) for path in VRULE_METHODS}


def vrule_speed(spec, nb, tag, dtype=None, least=1):
    """15a: the replayed sweep (KeyedStream, ReplayedSweep) of spec's marker
    set at every divisor V >= least of its block count: the capture's
    seconds (one eager sweep and the capture), the median of VRULE_RUNS runs
    of CUDA events around VRULE_REPLAYS replays, and the device busy and
    nodes a sweep from 10 replays under the profiler. Returns ({V: numbers},
    the fastest V)."""
    rows = {}
    for V in divisors(nb, least):
        plan, st = ngt.assemble(spec, vshards=V, dtype=dtype)
        check(plan.markers[0].vshards == V, f"15a {tag}: V = {plan.markers[0].vshards}, asked for {V}")
        stream = keyed.KeyedStream(7, DEV, plan.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = engine_sweep.ReplayedSweep(plan, st, stream)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        runs = [steady_ms(lambda: rep.run(1), VRULE_REPLAYS) for _ in range(VRULE_RUNS)]
        busy, nodes, missed, _, _ = replay_window(rep, 10)
        ms = statistics.median(runs)
        rows[V] = dict(ms=ms, runs=runs, busy_ms=busy, busy_share=busy / ms, nodes=nodes, capture_s=capture_s)
        print(f"[15a {tag}] V={V} (T={nb // V}): replayed {ms:.4f} ms/sweep (runs "
              f"{', '.join(f'{r:.4f}' for r in runs)}), device busy {busy:.4f} ms ({busy / ms:.3f}), {nodes} "
              f"nodes a sweep ({missed} records missed), capture {capture_s:.2f} s")
        del rep, plan, st
        torch.cuda.empty_cache()
    fastest = min(rows, key=lambda v: rows[v]["ms"])
    print(f"[15a {tag}] fastest V={fastest} ({rows[fastest]['ms']:.4f} ms/sweep)")
    return rows, fastest


def vrule_chain(spec, V, sig):
    """15b: one 100-sweep chain replayed from one KeyedStream: its
    posterior-mean varE and EBV correlation."""
    res = ngt.run_lmem(spec, n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, out_folder=None, vshards=V,
                       dtype=torch.float32, stream=keyed.KeyedStream(7, DEV, torch.float32))
    check(res.plan.markers[0].vshards == V, f"15b: V = {res.plan.markers[0].vshards}, asked for {V}")
    var_e = float(np.mean(res.draws["varE"]))
    return var_e, ebv_corr(ngt.genomic_values_state(res.plan, res.state, beta=res.posterior_mean("betaM1")), sig)


def vrule_quality(spec_for, sig, vs, tag):
    """15b: each method (and BayesC+D) at each V of vs: posterior-mean varE,
    EBV correlation and whether the gate admitted it against the V = 1 chain.
    Returns {method: {"rows": {V: (varE, EBV, admitted)}, "cap": the
    largest V admitted}}."""
    out = {}
    for path in VRULE_METHODS:
        spec = spec_for(path)
        got = {V: vrule_chain(spec, V, sig) for V in vs}
        e1, c1 = got[1]
        rows = {V: (e, c, bool(abs(e - e1) <= GATE_VAR_E * e1 and c >= c1 - GATE_EBV)) for V, (e, c) in got.items()}
        cap = max(V for V, r in rows.items() if r[2])
        out[path] = dict(rows=rows, cap=cap)
        print(f"[15b {tag} {path}] " + "; ".join(f"V={V} varE {e:.4f} EBV {c:.4f} {'admitted' if a else 'refused'}"
                                                 for V, (e, c, a) in rows.items()) + f"; largest admitted V={cap}")
    return out


def step_passes(st, tag):
    """K1 and K2 on the last block-step of st's marker set (an offset into
    the panel where T > 1) against their plain versions, as phase 3 holds
    them."""
    ms = st.markers[0]
    T, V, B, q = ms.mt.shape
    rows, t = V * B, T - 1
    mt_rows = ms.mt.view(-1, q)
    y4 = pack2.y_planar(Step0(st).y)
    u = torch.randn(rows, generator=torch.Generator(device=DEV).manual_seed(1), device=DEV) * 0.01
    sl = mt_rows[t * rows:(t + 1) * rows]
    for name, kern, plain in ((f"pack2_matvec{tag}", lambda: pack2.matvec_step(mt_rows, t, y4, rows),
                               lambda: pack2.matvec_plain(sl, y4)),
                              (f"pack2_rank_update{tag}", lambda: pack2.rank_update_step(mt_rows, t, u),
                               lambda: pack2.rank_update_plain(sl, u))):
        got = kern()
        check(torch.equal(got, kern()), f"{name}: two runs differ")
        DIGESTS[name] = dict(outputs=digest(got))
        e, s = rel_err(got, plain())
        report(name, e, s, TOL_PASS, median_ms(kern, 20), median_ms(plain, 5), pass_work(rows, q),
               f" ({rows} x {q} step t = {t} of T = {T})", dev_ms=device_ms(kern, 20), phase="15 kernels")


def rule_kernels(spec_for, pass_vs, scan_vs):
    """K1 and K2 at each V of pass_vs (BayesR's V at the main path's block
    count) and every scan of phase 3 at those V and at each V of scan_vs
    (the Vs that "auto" gives the other methods, or that the gate
    admitted), against their plain versions at phase 3's tolerances. Phase
    3 holds V = 1 and V_MAIN already."""
    for V in sorted(set(pass_vs) - {1, V_MAIN}):
        plan, st = ngt.assemble(spec_for("BayesR"), vshards=V)
        step_passes(st, f"_v{V}")
        k1_grids(st)
        del plan, st
    for V in sorted((set(pass_vs) | set(scan_vs)) - {1, V_MAIN}):
        kernels_phase(spec_for, V, f"_v{V}", full=False)


def shape_kernels(spec, vs, tag):
    """K1, K2 and K3 against their plain versions at each V of vs on spec's
    BayesR set (a shape other than the main path's)."""
    for V in sorted(vs):
        plan, st = ngt.assemble(spec, vshards=V)
        step_passes(st, f"_{tag}_v{V}")
        gen = torch.Generator(device=DEV).manual_seed(2)
        unif = torch.rand(plan.markers[0].p_pad, generator=gen, device=DEV)
        z = torch.randn(plan.markers[0].p_pad, generator=gen, device=DEV)
        ms = st.markers[0]
        r_scan_held(f"r_block_scan_v_{tag}_v{V}", st, Step0(st), unif, z, gen, ms.var_beta[0] * ms.v_class,
                    ms.log_pi, phase="15 kernels")
        del plan, st, ms


def auto_phase(spec_for, sig, card, scan_vs=()):
    """15c: run_lmem's default vshards ("auto") on the card at the main
    path: BayesR resolves to the rule's V (> 1) and passes phase 4's limits
    (EBV >= 0.95, drift < 1e-2) with n_chain * nb / V launches of K3;
    BayesC resolves to its cap; each chain held to the gate against the V =
    1 chain of its stream (phase 4's, or run here). A correlated set stays
    at V = 1 (phase 11's MultiBreed). Then K1 and K2 at BayesR's V, and
    every scan at each V the rule gives a method and at scan_vs. Returns
    the resolved V by method and the launch counts by run."""
    nb = P // BLOCK
    picked = rule_picks(nb, N)
    check(picked["BayesR"] > 1, f"15c: the rule gives BayesR V = {picked['BayesR']} at nb = {nb}")
    print(f"[15c auto] nb = {nb}, {N:,} records, B = {BLOCK}: the rule gives {picked}")
    counted = {}
    for path in ("BayesR", "BayesC"):
        if f"{path} V=1" not in FITS:
            slice_phase(path, spec_for(path), sig, card, 1)
        V = picked[path]
        launches, res = slice_phase(path, spec_for(path), sig, card, V, tag=" auto",
                                    ebv_limit=EBV_LIMITS[("BayesR", V_MAIN)] if path == "BayesR" else None,
                                    auto=True)
        del res
        (e, c), (e1, c1) = FITS[f"{path} auto V={V}"], FITS[f"{path} V=1"]
        print(f"[15c auto] {path} at V={V}: posterior-mean varE {e:.4f}, EBV {c:.4f}; at V=1 {e1:.4f}, {c1:.4f} "
              f"(the gate: varE within {GATE_VAR_E:.0%}, EBV at least V=1's - {GATE_EBV})")
        check(abs(e - e1) <= GATE_VAR_E * e1 and c >= c1 - GATE_EBV,
              f"15c: {path} at V={V} falls outside the gate against V=1")
        # the kernels line counts a V = 1 run under the single-chain kernels' rows
        ran, other = (f"auto {path}", f"auto {path} V=1")[::1 if V > 1 else -1]
        counted[ran], counted[other] = launches, dict.fromkeys(launches, 0)
    rule_kernels(spec_for, {picked["BayesR"]}, set(picked.values()) | set(scan_vs))
    return picked, counted


def vrule_only(card):
    """`python3 chip_smoke.py vrule`: phase 15 alone. 15a the table of
    replayed ms/sweep by V (VRULE_SHAPES, then the main path in float64),
    with K1, K2 and K3 at BayesR's V by the rule at the other shapes; 15b
    the quality gate on the main path's panel and on the CLI's (VRULE_GATES);
    15c run_lmem's default and the kernels at the rule's V and at each V
    the gate admits for B/C. Then the rule held to the gate: at each gate
    panel the V it gives each method admitted there, and at the main path
    the largest V admitted below T = 1. One JSON line of its numbers, and
    no result line."""
    speed, quality, misses = {}, {}, []
    for n, p in VRULE_SHAPES + tuple(sh for sh in VRULE_GATES if sh not in VRULE_SHAPES):
        wide = p == VRULE_WIDE_P
        t0 = time.perf_counter()
        spec_for, sig = simulate(n, p, chunk=1024 if wide else 8192)
        print(f"[15 {n:,} x {p:,}] simulated in {time.perf_counter() - t0:.1f} s")
        nb = -(-p // BLOCK)
        picked = rule_picks(nb, n)
        if (n, p) in VRULE_SHAPES:
            shapes = [(f"{n:,} x {p:,}", None)] + ([(f"{n:,} x {p:,} f64", torch.float64)] if (n, p) == (N, P)
                                                   else [])
            for tag, dtype in shapes:
                rows, fastest = vrule_speed(spec_for("BayesR"), nb, tag, dtype, VRULE_WIDE_FROM if wide else 1)
                v_r = picked["BayesR"]
                print(f"[15a {tag}] BayesR's V by the rule {v_r}: "
                      + (f"{rows[v_r]['ms']:.4f} ms/sweep, {rows[v_r]['ms'] / rows[fastest]['ms']:.3f}x the "
                         f"fastest" if v_r in rows else "not measured"))
                speed[tag] = dict(nb=nb, rows=rows, fastest=fastest, bayesr=v_r)
        if (n, p) in VRULE_GATES:
            tag = f"{n:,} x {p:,}"
            quality[tag] = got = vrule_quality(spec_for, sig, VRULE_GATES[n, p], tag)
            for path, q in got.items():
                rows, v = q["rows"], picked[path]
                if v not in rows or not rows[v][2]:
                    misses.append(f"{tag} {path}: the rule's V={v} is " + ("not measured" if v not in rows
                                                                           else "refused by the gate"))
                want = max(V for V, r in rows.items() if r[2] and V < nb)
                if (n, p) == (N, P) and v != want:
                    misses.append(f"{tag} {path}: the rule gives V={v}, the gate's largest admitted V below "
                                  f"T = 1 is {want}")
        if (n, p) == (N, P):
            auto, counted = auto_phase(spec_for, sig, card, scan_vs={
                v for path in ("BayesB", "BayesC", "BayesC+D") for v, r in got[path]["rows"].items()
                if r[2] and v < nb})
        else:
            shape_kernels(spec_for("BayesR"), {picked["BayesR"]}, f"{n // 1000}k_{p}")
        del spec_for, sig
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "speed": speed, "quality": quality, "auto": auto,
                      "launches": {run: {k: v for k, v in c.items() if v} for run, c in counted.items()},
                      "misses": misses}))
    check(not misses, "15: the rule does not follow the gate: " + "; ".join(misses))


CU = "nextgp_tpu_torch/csrc/"
GK = "nextgp_tpu/ops/gibbs_kernels.py:"
V96, V1 = tuple(PATHS), tuple(f"{p} V=1" for p in PATHS)
CORR_RUNS = (f"MultiBreed V={V_MAIN}", "MultiBreed V=1", "BayesR+A2")
STEP_LADDER, PANEL_LADDER = ("ladder fused", "ladder frontier"), ("ladder load32", "ladder matvec")
RUNTIME_RUNS = ("runtime BayesR", "runtime chains")  # phase 10's replayed BayesR runs
# phase 11's eager runs of BayesR at V=96 on int8, packed and float storage
STORAGE_R = ("storage BayesR int8", "storage BayesR packed", "storage BayesR float")
STORAGE_KEYED = STORAGE_R + ("storage BayesC+D int8", "storage CLI")
GRN_RUNS = ("GRN f32 eager", "GRN f32 replayed", "GRN f32 eager wide", "GRN f32 replayed wide", "GRN f64 kernel",
            "GRN est_grn")  # phase 12's GRN1 runs
# phase 13's runs: 13a's sharded sweeps, each 13b rank's sweeps (KeyedStream) and
# run_chains, each 13c rank's MultiBreed sweeps
SHARD_MESH = tuple(f"shards 2x2 rank{r}" for r in range(4)) + tuple(f"shards run_chains rank{r}" for r in range(4))
SHARD_CORR = ("shards corr rank0", "shards corr rank1")
SHARD_RUNS = ("shards NCCL 1x1",) + SHARD_MESH
# phase 14's runs: BayesR's and the other paths' (14b, 14c), all on packed rows
F64_R_RUNS = ("f64 V=96", "f64 V=1", f"f64 keyed V={V_MAIN}")
F64_OTHER_RUNS = (tuple(f"f64 {p} V={V_MAIN}" for p in F64_PATHS_V96) + ("f64 BayesLV V=1",)
                  + tuple(f"f64 keyed {p} V={V}" for p, V in F64_REPLAYED))
F64_PATH_RUNS = F64_R_RUNS + F64_OTHER_RUNS
# phase 14's random-effect runs (14h at 2,000 animals, 14i at full width)
F64_RE1_RUNS = ("f64 BayesR+A small", "f64 keyed BayesR+A", "f64 keyed GBLUP")
F64_RE2_RUNS = ("f64 BayesR+A2 small", "f64 keyed BayesR+A2")
# phase 14's K12, K14 and CM1 runs (14m on the small panels, 14n at full width)
F64_CORR_V96 = (f"f64 MultiBreed V={V_MAIN}", f"f64 keyed MultiBreed V={V_MAIN}")
F64_CORR_V1 = ("f64 MultiBreed V=1", "f64 keyed MultiBreed V=1")
AUTO_RUNS = ("auto BayesR", "auto BayesC")  # phase 15c's run_lmem with vshards="auto" where it gave V > 1


def f64_runs(path, V):
    """Phase 14's runs of a path at V (V_MAIN, or 1 for V=1)."""
    return tuple(r for r in F64_OTHER_RUNS if r.split()[-2] == path and r.endswith(f"V={V}"))


# kernels-line name -> (source, the TPU kernel it replaces, its launch counter,
# the runs whose launches count for it). The single-chain scans (K4, K5, K7,
# K9, K11, K13) are the V=1 launches of the batched kernels; K1' and K2' are
# K1 and K2 over a whole panel, which the ladder launches.
SOURCES = {
    "pack2_matvec": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:302", "pack2_matvec",
                     V96 + STEP_LADDER + CORR_RUNS + RUNTIME_RUNS + ("storage BayesR packed",) + SHARD_RUNS
                     + SHARD_CORR + AUTO_RUNS),
    "pack2_matvec_panel": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:171", "pack2_matvec", PANEL_LADDER),
    "pack2_rank_update": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:329", "pack2_rank_update",
                          V96 + STEP_LADDER + CORR_RUNS + RUNTIME_RUNS + ("storage BayesR packed",) + SHARD_RUNS
                          + SHARD_CORR + AUTO_RUNS),
    "pack2_rank_update_panel": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:261", "pack2_rank_update",
                                ("ladder matvec", "runtime serving")),
    "pack2_matvec_50k": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:302", "pack2_matvec", ("BayesR 50k",)),
    "pack2_rank_update_50k": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:329", "pack2_rank_update",
                              ("BayesR 50k",)),
    "r_block_scan_v": (CU + "r_scan.cu", GK + "518", "r_block_scan_v",
                       V96 + RUNTIME_RUNS + STORAGE_R + SHARD_RUNS + ("auto BayesR", "storage CLI")),
    "r_block_scan_v_v1": (CU + "r_scan.cu", GK + "265", "r_block_scan_v", V1 + ("auto BayesR V=1",)),
    "gauss_block_scan_v": (CU + "gauss_bc_scan.cu", GK + "389", "gauss_block_scan_v", V96),
    "gauss_block_scan_v_v1": (CU + "gauss_bc_scan.cu", GK + "107", "gauss_block_scan_v", V1),
    "bc_block_scan_v": (CU + "gauss_bc_scan.cu", GK + "422", "bc_block_scan_v", V96 + ("auto BayesC",)),
    "bc_block_scan_v_v1": (CU + "gauss_bc_scan.cu", GK + "162", "bc_block_scan_v", V1 + ("auto BayesC V=1",)),
    "bc_block_scan_wv": (CU + "gauss_bc_scan.cu", GK + "457", "bc_block_scan_wv",
                         V96 + ("storage BayesC+D int8",)),
    "bc_block_scan_wv_v1": (CU + "gauss_bc_scan.cu", GK + "189", "bc_block_scan_wv", V1),
    "rcpi_block_scan_v": (CU + "rc_scan.cu", GK + "718", "rcpi_block_scan_v", V96),
    "rcpi_block_scan_v_v1": (CU + "rc_scan.cu", GK + "627", "rcpi_block_scan_v", V1),
    "rcplus_block_scan_v": (CU + "rc_scan.cu", GK + "952", "rcplus_block_scan_v", V96),
    "rcplus_block_scan_v_v1": (CU + "rc_scan.cu", GK + "847", "rcplus_block_scan_v", V1),
    "gather_width1": (CU + "micro.cu", "scripts/micro_load32.py:80", "gather_width1", ("ladder load32",)),
    "gather_width4": (CU + "micro.cu", "scripts/micro_load32.py:95", "gather_width4", ("ladder load32",)),
    "dense_gather": (CU + "micro.cu", "scripts/micro_matvec.py:69", "dense_gather", ("ladder matvec",)),
    "dense_scatter": (CU + "micro.cu", "scripts/micro_matvec.py:94", "dense_scatter", ("ladder matvec",)),
    "fused_step": (CU + "micro.cu", "scripts/micro_fused.py:118", "fused_step", ("ladder fused",)),
    "read_step": (CU + "micro.cu", "scripts/micro_frontier.py:87", "read_step", ("ladder frontier",)),
    "keyed_rng": (CU + "keyed_rng.cu", "nextgp_tpu/engine/rng.py:31", "keyed_rng",
                  tuple(f"{p} keyed V={V_MAIN}" for p in PATHS) + ("BayesR keyed V=1",
                                                                  f"BayesR 50k keyed V={V_MAIN}")
                  + tuple(f"{r} keyed" if r == "BayesR+A2" else r.replace(" V=", " keyed V=")
                          for r in CORR_RUNS) + RUNTIME_RUNS + ("runtime A-cg",) + STORAGE_KEYED + GRN_RUNS
                  + SHARD_MESH),
    "level_scan": (CU + "level_scan.cu", "nextgp_tpu/engine/samplers/random_effects.py:29",
                   "level_scan", ("BayesR+A", "GBLUP", "storage CLI")),
    "corr_level_scan": (CU + "level_scan.cu", "nextgp_tpu/engine/samplers/random_effects.py:133",
                        "corr_level_scan", ("BayesR+A2",)),
    "corr_block_scan_v": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:911",
                          "corr_block_scan_v", (f"MultiBreed V={V_MAIN}",) + SHARD_CORR),
    "corr_block_scan_v_v1": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:911",
                             "corr_block_scan_v", ("MultiBreed V=1", "storage MultiBreed float V=1")),
    "corr_rule": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:901", "corr_rule",
                  (f"MultiBreed V={V_MAIN}", "MultiBreed V=1", "storage MultiBreed float V=1") + SHARD_CORR),
    "cg_solve": (CU + "cg_solve.cu", "nextgp_tpu/ops/cg.py:49", "cg_solve", ("A-cg", "runtime A-cg")),
    "grn_scan": (CU + "grn_scan.cu", "nextgp_tpu/grn/sampler.py:183", "grn_scan", GRN_RUNS),
    # the float64 instances (phase 14); K1' in float64 runs on no path, so it is timed in
    # phase 14 and left out of this line
    "pack2_matvec_f64": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:302", "pack2_matvec_f64", F64_PATH_RUNS),
    "pack2_rank_update_f64": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:329", "pack2_rank_update_f64",
                              F64_PATH_RUNS),
    "pack2_rank_update_panel_f64": (CU + "pack2.cu", "nextgp_tpu/ops/pack2.py:261", "pack2_rank_update_f64",
                                    ("f64 serving",)),
    "r_block_scan_v_f64": (CU + "r_scan.cu", GK + "518", "r_block_scan_v_f64",
                           ("f64 V=96", f"f64 keyed V={V_MAIN}", "f64 int8")),
    "r_block_scan_v_v1_f64": (CU + "r_scan.cu", GK + "265", "r_block_scan_v_f64", ("f64 V=1",)),
    # K10 in float64 at V=1 runs on no path, so it is timed in phase 14 and left out of this line
    "gauss_block_scan_v_f64": (CU + "gauss_bc_scan.cu", GK + "389", "gauss_block_scan_v_f64",
                               f64_runs("BayesPR", V_MAIN)),
    "gauss_block_scan_v_v1_f64": (CU + "gauss_bc_scan.cu", GK + "107", "gauss_block_scan_v_f64",
                                  f64_runs("BayesLV", 1)),
    "bc_block_scan_v_f64": (CU + "gauss_bc_scan.cu", GK + "422", "bc_block_scan_v_f64",
                            f64_runs("BayesB", V_MAIN) + f64_runs("BayesC", V_MAIN)),
    "bc_block_scan_v_v1_f64": (CU + "gauss_bc_scan.cu", GK + "162", "bc_block_scan_v_f64", f64_runs("BayesC", 1)),
    "bc_block_scan_wv_f64": (CU + "gauss_bc_scan.cu", GK + "457", "bc_block_scan_wv_f64",
                             f64_runs("BayesC+D", V_MAIN) + ("f64 BayesC+D int8",)),
    "level_scan_f64": (CU + "level_scan.cu", "nextgp_tpu/engine/samplers/random_effects.py:29",
                       "level_scan_f64", F64_RE1_RUNS),
    "corr_level_scan_f64": (CU + "level_scan.cu", "nextgp_tpu/engine/samplers/random_effects.py:133",
                            "corr_level_scan_f64", F64_RE2_RUNS),
    # K14 in float64 at V=1 (K13) runs on no path, so it is timed in phase 14 and left out of this line
    "rcpi_block_scan_v_f64": (CU + "rc_scan.cu", GK + "718", "rcpi_block_scan_v_f64",
                              (f"f64 BayesRCpi V={V_MAIN}", f"f64 keyed BayesRCpi V={V_MAIN}")),
    "rcpi_block_scan_v_v1_f64": (CU + "rc_scan.cu", GK + "627", "rcpi_block_scan_v_f64", ("f64 keyed BayesRCpi V=1",)),
    "rcplus_block_scan_v_f64": (CU + "rc_scan.cu", GK + "952", "rcplus_block_scan_v_f64",
                                (f"f64 BayesRCplus V={V_MAIN}", f"f64 keyed BayesRCplus V={V_MAIN}")),
    "corr_block_scan_v_f64": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:911",
                              "corr_block_scan_v_f64", F64_CORR_V96),
    "corr_block_scan_v_v1_f64": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:911",
                                 "corr_block_scan_v_f64", F64_CORR_V1),
    "corr_rule_f64": (CU + "corr_scan.cu", "nextgp_tpu/engine/samplers/markers.py:901", "corr_rule_f64",
                      F64_CORR_V96 + F64_CORR_V1),
}
NOTES = {"keyed_rng": "not a TPU kernel: the counterpart of jax.random under fold_in "
                      "(nextgp_tpu/engine/rng.py:31-36); launches from the eager KeyedStream runs of "
                      "phase 7 and, counted at capture, phase 10's replayed runs",
         "level_scan": "not a TPU kernel: the counterpart of the lax.scan over levels of "
                       "sample_random_uni (nextgp_tpu/engine/samplers/random_effects.py:29-37); "
                       "launches from phase 8's run_lmem (PhiloxStream, eager) runs",
         "corr_level_scan": "RE2; not a TPU kernel: the counterpart of the lax.scan over levels of "
                            "sample_random_corr (nextgp_tpu/engine/samplers/random_effects.py:"
                            "120-133); timed at nT = 2 (nT = 1, 3: corr_level_scan_nt1/_nt3 in "
                            "phase 9's output); launches from phase 9's run_lmem (PhiloxStream, "
                            "eager) run",
         "corr_block_scan_v": "CM1; not a TPU kernel: the counterpart of the lax.scan over a block's "
                              "loci of sample_corr_marker_set (nextgp_tpu/engine/samplers/markers.py:"
                              "898-916); launches from phase 9's run_lmem (PhiloxStream, eager) run",
         "cg_solve": "CG1; not a TPU kernel: the counterpart of the lax.while_loop of cg_solve "
                     "(nextgp_tpu/ops/cg.py:49) under sample_random_cg (nextgp_tpu/engine/samplers/"
                     "random_effects.py:45-106); timed at a second sweep's system of the "
                     "100,000-animal model (float64); launches from phase 8.4's run_lmem "
                     "(PhiloxStream, eager) run and, counted at capture, phase 10's replayed A-cg "
                     "runs with checkpoints and resume",
         "grn_scan": "GRN1; not a TPU kernel: the counterpart of the lax.scan of gene_scan "
                     "(nextgp_tpu/grn/sampler.py:169-188), vmapped over genes; timed at G = 100, S = 200 "
                     "in float32 (bench_grn's other shapes and float64 as grn_scan_<G>x<S>[_f64] in "
                     "phase 12's output); launches from phase 12's eager runs (one an iteration) and, "
                     "counted at capture, its replayed runs and est_grn",
         "corr_block_scan_v_v1": "CM1 at V = 1, as corr_block_scan_v",
         "pack2_matvec_f64": "K1's float64 instance (ngt_pack2_matvec_f64); launches from phase 14's "
                             "float64 runs",
         "pack2_rank_update_f64": "K2's float64 instance (ngt_pack2_rank_update_f64); launches from "
                                  "phase 14's float64 runs",
         "pack2_rank_update_panel_f64": "K2' in float64: genomic_values_state on a float64 state",
         "r_block_scan_v_f64": "K3's float64 instance (ngt_r_block_scan_v_f64); launches from phase 14's "
                               "float64 runs, the replayed one counted at capture",
         "r_block_scan_v_v1_f64": "K4 in float64: K3's float64 instance at V = 1",
         "gauss_block_scan_v_f64": "K6's float64 instance (ngt_gauss_block_scan_v_f64); launches from "
                                   "phase 14's float64 BayesPR runs, the replayed one counted at capture",
         "gauss_block_scan_v_v1_f64": "K5 in float64: K6's float64 instance at V = 1, BayesLV's",
         "bc_block_scan_v_f64": "K8's float64 instance (ngt_bc_block_scan_v_f64); launches from phase 14's "
                                "float64 BayesB and BayesC runs",
         "bc_block_scan_v_v1_f64": "K7 in float64: K8's float64 instance at V = 1, BayesC's",
         "bc_block_scan_wv_f64": "K10's float64 instance (ngt_bc_block_scan_wv_f64); launches from phase "
                                 "14's float64 BayesC+D runs on packed and int8 rows",
         "level_scan_f64": "RE1's float64 instance (ngt_level_scan_f64); not a TPU kernel (see "
                           "level_scan); launches from phase 14's float64 BayesR+A and GBLUP runs, "
                           "eager",
         "corr_level_scan_f64": "RE2's float64 instance (ngt_corr_level_scan_f64); not a TPU kernel (see "
                                "corr_level_scan); timed at nT = 2 (nT = 1, 3, 4, 5: "
                                "corr_level_scan_nt<n>_f64 in phase 14's output); launches from phase "
                                "14's float64 BayesR+A2 runs, eager",
         "rcpi_block_scan_v_f64": "K12's float64 instance (ngt_rcpi_block_scan_v_f64); launches from phase "
                                  "14's float64 BayesRCpi runs, the replayed one counted at capture",
         "rcpi_block_scan_v_v1_f64": "K11 in float64: K12's float64 instance at V = 1",
         "rcplus_block_scan_v_f64": "K14's float64 instance (ngt_rcplus_block_scan_v_f64); launches from "
                                    "phase 14's float64 BayesRCplus runs",
         "corr_block_scan_v_f64": "CM1's float64 instance (ngt_corr_block_step_f64); not a TPU kernel (see "
                                  "corr_block_scan_v); launches from phase 14's float64 MultiBreed runs, eager",
         "corr_block_scan_v_v1_f64": "CM1's float64 instance at V = 1",
         "corr_rule_f64": "CM1r's float64 instance (ngt_corr_rule_f64); not a TPU kernel (see corr_rule); "
                          "launches from phase 14's float64 MultiBreed runs, eager",
         "corr_rule": "CM1's rule launch; not a TPU kernel: the counterpart of the per-locus rule "
                      "(the region inverse, inv, sym, cholesky) in the block lax.scan of "
                      "sample_corr_marker_set (nextgp_tpu/engine/samplers/markers.py:877-878, "
                      "901-905); launches from phase 9's run_lmem (PhiloxStream, eager) runs"}
# the scripts' other kernels compute what these compute; the ladder launches these at their shapes
ALSO_REPLACES = {
    "pack2_matvec": ["scripts/micro_frontier.py:111"],
    "pack2_rank_update": ["scripts/micro_frontier.py:135"],
    "pack2_matvec_panel": ["scripts/micro_matvec.py:163", "scripts/micro_matvec.py:226"],
    "pack2_rank_update_panel": ["scripts/micro_matvec.py:191"],
}


def scans_only(spec_for, card, which):
    """`python3 chip_smoke.py scans` (every scan of phase 3, as phase 3 holds
    and times them, at V=96 and V=1) or `rc` (K12 and K14 alone): the quick
    forms for work on the scan kernels. They print one JSON line of times and
    digests, and no result line. `scans` keeps to shapes that every version
    of the kernels has taken (K3 at K = 20 is the full run's), so that the
    same script can time two trees and compare their digests."""
    z = torch.randn(P, generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    for V, tag in ((V_MAIN, ""), (1, "_v1")):
        if which == "scans":
            kernels_phase(spec_for, V, tag, full=False)
        else:
            rc_kernels(spec_for, z, V, tag)
    print(json.dumps({"card": card, "ms": {name: t["ms"] for name, t in TIMINGS.items()},
                      "device_ms": {name: t["device_ms"] for name, t in TIMINGS.items()},
                      "digests": DIGESTS}))


def passes_only(spec_for, card):
    """`python3 chip_smoke.py passes`: K1, K2, K1' and K2' as phase 3 holds
    and times them (with the 50k and 100k steps), the ladder's frontier and
    fused experiments, and the 50k BayesR path of phase 4: the quick form for
    work on the panel passes. One JSON line of times, digests and the 50k
    sweep's numbers, and no result line. It calls only what every tree of
    the port has, so that the same script can time two trees."""
    _, st = ngt.assemble(spec_for("BayesR"), vshards=V_MAIN)
    pass_kernels(st)
    del st
    ladder = {}
    for name in ("frontier", "fused"):
        print(f"[6 ladder] {name}:")
        ladder[name], = micro.main([name])
    _, wide = wide_phase(card)
    print(json.dumps({"card": card, "ms": {name: t["ms"] for name, t in TIMINGS.items()},
                      "device_ms": {name: t["device_ms"] for name, t in TIMINGS.items()},
                      "digests": DIGESTS, "ladder": ladder, "bayesr_50k": wide}))


def chains_only(spec_for, card):
    """`python3 chip_smoke.py chains`: phase 4's chains as run_lmem runs them
    by default (PhiloxStream, eager sweeps), every path at V=96 and at V=1,
    with a digest of each chain's kept draws and of its final ycorr and its
    sweeps/s. One JSON line, and no result line. It calls only what every
    tree of the port has, so the same script run beside a `git archive` of
    another tree (as `chip_smoke_chains.py`) shows whether a change moved a
    chain's bits."""
    out = {}
    for V in (V_MAIN, 1):
        for path in PATHS:
            res = ngt.run_lmem(spec_for(path), n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, seed=7,
                               out_folder=None, vshards=V)
            draws = [torch.from_numpy(np.ascontiguousarray(res.draws[k])) for k in sorted(res.draws)]
            out[f"{path} V={V}"] = dict(draws=digest(*draws), ycorr=digest(res.state.ycorr),
                                        sweeps_per_s=res.sweeps_per_sec)
            print(f"[chains] {path} V={V}: {out[f'{path} V={V}']}")
    print(json.dumps({"card": card, "chains": out}))


def graph_only(spec_for, sig, card):
    """`python3 chip_smoke.py graph`: phase 7 alone, the quick form for work
    on the stream and the replayed runners. One JSON line of its numbers,
    and no result line."""
    out, counted = graph_phase(spec_for, sig)
    print(json.dumps({"card": card, "graph": out, "launches": counted,
                      "keyed_rng": TIMINGS.get("keyed_rng")}))


def keyed_only(card, srcs):
    """`python3 chip_smoke.py keyed [DIR ...]`: phase 7a alone, the quick
    form for work on R1; with DIRs (other trees' csrc/, e.g. a `git archive`
    of the parent under _checkout/), their R1 timed beside this tree's in
    turns. One JSON line of its numbers, and no result line."""
    out = keyed_phase(other_keyed_rng(srcs) if srcs else None)
    print(json.dumps({"card": card, "keyed_rng": out, "timing": TIMINGS.get("keyed_rng")}))


def shards_only(card):
    """`python3 chip_smoke.py shards`: phase 13 alone. One JSON line of its
    numbers and launch counts, and no result line."""
    out, counted = shards_phase(card)
    print(json.dumps({"card": card, "shards": out, "launches": counted}))


def main(argv=()):
    if list(argv[:1]) == ["shard-rank"]:
        return shard_rank(*argv[1:])
    t_start = time.perf_counter()
    card = device_phase()
    build_phase()
    if list(argv) == ["shards"]:
        return shards_only(card)
    if list(argv[:1]) == ["keyed"]:
        return keyed_only(card, argv[1:])
    if list(argv[:1]) == ["gathers"]:
        return gathers_only(card, argv[1:])
    if list(argv[:1]) == ["cg"] and len(argv) <= 2:
        return cg_only(card, *argv[1:])
    if list(argv) == ["storage"]:
        return storage_only(card)
    if list(argv[:1]) == ["f64"] and len(argv) <= 2:
        return f64_only(card, *argv[1:])
    if list(argv[:1]) == ["levels"] and len(argv) <= 2:
        return levels_only(card, *argv[1:])
    if list(argv[:1]) == ["grn"] and len(argv) <= 2:
        return grn_only(card, *argv[1:])
    if list(argv) == ["vrule"]:
        return vrule_only(card)
    spec_for, sig = simulate()
    if list(argv) in (["scans"], ["rc"]):
        return scans_only(spec_for, card, argv[0])
    if list(argv) == ["passes"]:
        return passes_only(spec_for, card)
    if list(argv) == ["graph"]:
        return graph_only(spec_for, sig, card)
    if list(argv) == ["chains"]:
        return chains_only(spec_for, card)
    if list(argv[:1]) == ["random"] and len(argv) <= 2:
        return random_only(spec_for, sig, card, *argv[1:])
    if list(argv[:1]) == ["corr"] and len(argv) <= 2:
        return corr_only(spec_for, sig, card, *argv[1:])
    if list(argv) == ["runtime"]:
        return runtime_only(spec_for, sig, card)
    check(not argv, f"unknown arguments {list(argv)}: none, scans, rc, passes, graph, chains, "
                    "keyed [DIR ...], gathers [DIR ...], random [DIR], cg [DIR], corr [DIR], runtime, "
                    "storage, grn [DIR], shards, f64 [DIR], levels [DIR] or vrule")
    kernels_phase(spec_for)
    kernels_phase(spec_for, V=1, tag="_v1")
    print(f"[3 digests] {json.dumps(DIGESTS)}")
    counted = {}  # run -> launches by counter, each read from 0
    for path in PATHS:
        counted[path], res = slice_phase(path, spec_for(path), sig, card, V_MAIN)
        timing_window(path, res)
        if path == "BayesR":
            stage_phase(path, res)
        del res
    for path in PATHS:
        counted[f"{path} V=1"], _ = slice_phase(path, spec_for(path), sig, card, 1)
    # BayesLV between the two schedules, and with a column of ones in its design
    for path, V in (("BayesLV", 8), ("BayesLV", 32), (LV_ONES, V_MAIN), (LV_ONES, 1)):
        slice_phase(path, spec_for(path), sig, card, V)
    counted["BayesR 50k"], wide = wide_phase(card)
    chain_phase()
    counted.update(ladder_phase(card))
    graph, by_run = graph_phase(spec_for, sig, wide["median_ms_per_sweep"])
    counted.update(by_run)
    print(f"[7 graph] {json.dumps(graph)}")
    random_out, by_run = random_phase(spec_for, sig)
    counted.update(by_run)
    print(f"[8 random] {json.dumps(random_out)}")
    corr_out, by_run = corr_phase(spec_for, sig)
    counted.update(by_run)
    print(f"[9 corr] {json.dumps(corr_out)}")
    runtime_out, by_run = runtime_phase(spec_for, sig)
    counted.update(by_run)
    print(f"[10 runtime] {json.dumps(runtime_out)}")
    auto_out, by_run = auto_phase(spec_for, sig, card)
    counted.update(by_run)
    print(f"[15c auto] {json.dumps(auto_out)}")
    del spec_for, sig
    storage_out, by_run = storage_phase()
    counted.update(by_run)
    print(f"[11 storage] {json.dumps(storage_out)}")
    grn_out, by_run = grn_phase()
    counted.update(by_run)
    print(f"[12 grn] {json.dumps(grn_out)}")
    shards_out, by_run = shards_phase(card)
    counted.update(by_run)
    print(f"[13 shards] {json.dumps(shards_out)}")
    f64_out, by_run = f64_phase()
    counted.update(by_run)
    print(f"[14 f64] {json.dumps(f64_out)}")
    kernels = []
    for name, (src, rep, counter, runs) in SOURCES.items():
        by_path = {run: counted[run][counter] for run in runs if counted[run][counter]}
        check(by_path, f"{name}: launched in none of its runs {runs}")
        extra = {"note": NOTES[name]} if name in NOTES else {}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep, **extra,
                            also_replaces=ALSO_REPLACES.get(name, []),
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            **TIMINGS[name]))
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
