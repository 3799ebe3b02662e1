#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main paths — the single-device Nekbone Jacobi-PCG solve
with the hand-written axhelm CUDA kernels, once for each of the five axhelm
variants, and the mixed-precision `bf16_x32` refined solve through the
bf16-storage kernels, with single and stacked right-hand sides, and the
solve service that batches requests into bucketed block solves; LM
serving, qwen3-0.6b at full width behind the continuous-batching engine;
LM training of qwen3-0.6b at full width, with checkpoints and restarts;
the MoE family, moonshot-v1-16b-a3b served at full width and full
depth and trained at full width with its depth cut; the hybrid family,
zamba2-2.7b served at full width and full depth and trained at full
width with its depth cut; the VLM stub, phi-3-vision-4.2b prefilled with
patches, decoded and trained at full width; the xLSTM family, xlstm-350m
served at full width and full depth and trained at full width and depth
with its sequence cut; and the enc-dec/audio family, seamless-m4t-medium
prefilled with frames, decoded and trained at full width and depth
— through the entry points a user calls (`setup_problem`,
`rhs_from_solution`, `solve`, `resilience.retry.solve_resilient`,
`serving.solve_service.SolveService`, `launch.serve`,
`serving.engine.ServeEngine`, `launch.train`,
`training.fault_tolerance.run_resilient`), and holds every kernel, fp32
and bf16, against its plain PyTorch version on the card.  Every solve runs
its PCG loops as replayed CUDA graphs (`core.graphs`), as users run it,
unless a phase says it runs one eagerly to compare.  Phases, one line
each:

  1. device   nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc builds the kernels from the sources in this checkout
              (the column and line bodies in five parts each, all at once);
              registers, shared memory and spills of every instantiation,
              with the body each runs (K2, K5: one thread per node column;
              K1, K3, K4: one thread per node line, each at every N1 from 2
              to 16; every entry point's
              generic body, slab body (its two launches: the pass over
              slabs of t-planes, each variant's own, and the transposed
              t contraction every variant shares), plane body (its three
              launches: the t
              contraction and its transpose shared by the five variants,
              the plane pass each variant's own) and staged body (its
              six launches: the r and s contractions and the three
              transposed ones, shared by the five variants, and the t
              contraction with the factors, each variant's own; six
              kernels an application), N1 a runtime argument; and the
              timing-only one-thread-per-node `_rowwise` twins of K1-K5); no
              instantiation may spill
  3. kernels  every kernel against its plain version: Poisson and
              Helmholtz with random per-node lam0/lam1 (merged: Helmholtz
              only, Lam2/Lam3 of them; partial: Poisson only, gScale): the
              tuned bodies at every N1 from 2 to 16, E in {1, 3, 37}, c in
              {1, 4}; at N1 in {4, 8} also c in {1, 3, nrhs*d = 2*3}, E =
              37, and each variant's main-path shape; the slab body
              (`ops.slab`) at every N1 from 17 to 24, E in {1, 3, 216}, c
              in {1, 4}, and at the order-19 main path's shape (the
              6x6x6 box); the generic body (`ops.generic`, the timing twin
              phase 6 holds the slab body against) at N1 = 17, 20 and 24,
              E = 3, c in {1, 4};
              max|y_k - y_p| / max|y_p| <= 1e-4
  3b. kernels_bf16  the same cases with bf16 storage, c in {1, 3, 6};
              <= 8e-3 (one bf16 ulp of the largest entry); and against
              the correctly rounded result (the plain version in float64,
              rounded once): at most 1e-3 of a kernel's outputs round to
              another bf16 value, none by more than one ulp (but within
              1e-6 max|y|; the share judged on a call of at least 1,000
              outputs, the smaller ones pooled by entry point); counts of
              0, 1 and more ulps for kernel and plain version
  4. converge 8x8x8, N=7, kernels and reference backend: precomputed,
              trilinear and partial Poisson on the trilinear mesh,
              parallelepiped and precomputed Poisson on the affine mesh,
              merged and trilinear Helmholtz; and at N=5 (the README's
              --order 5 path, the tuned bodies) every variant on its main
              equation;
              CONVERGED, iterations within +-1 of the other backend and of
              the same operator reached through another variant, one
              kernel launch per operator application (a launch captured
              in a graph counts once for every replay)
  4b. refine_8  8x8x8, N=7, bf16_x32 (Jacobi, max_iter 3000, b of
              `nekbone.random_rhs`: standard normal from numpy seed 0,
              zero on the boundary, norm 30 a column): at tol 0.03
              precomputed, trilinear and partial Poisson, parallelepiped
              Poisson on the affine mesh, merged Helmholtz (Dirichlet),
              trilinear Poisson with nrhs 4 and unmasked trilinear
              Helmholtz; trilinear Poisson at tol 1e-4.  Each through the
              kernels as users run it (the gather sums in a fixed order,
              so it repeats exactly) beside the ensemble of the plain
              version's roundings, run eagerly (the reference backend, the
              correctly rounded operator and 6 re-rounded ones, see
              WITNESS_SEEDS): the solve ends in a status some member ends
              in, with iterations within max(3, 5%) of the members' range
              — where all members agree, the same status and iterations
              as the reference backend; the fp32 true residual <= 1.5 tol
              when
              CONVERGED, one bf16 launch per inner operator application;
              trilinear Poisson CONVERGED at tol 0.03 where the reference
              converges (nrhs 1, and 3 of the 4 columns of nrhs 4) and
              STAGNATED at 1e-4, unmasked Helmholtz STAGNATED, through the
              kernels and the reference backend; the bf16 global operator
              through the kernels, the plain version and correctly
              rounded, as counts of outputs 0, 1 and more ulps apart;
              refine_generic: every variant at N=5 (the bf16 tuned
              bodies), tol 0.03, held to the ensemble the same way
  5. config   the Nekbone config (16x16x16, N=7, fp32, Jacobi, 200
              iterations) through the kernels — the main path of each
              variant: precomputed, trilinear and partial Poisson,
              parallelepiped Poisson on the affinely deformed box, merged
              and trilinear Helmholtz; captured and eager in turns (see
              5c); status and iterations (+-1) of the reference backend
              (solved once), at MAXITER its final residual within 1%; ms per
              iteration of the captured solve (median and quartiles),
              GFLOPS, GDOFS, peak memory
  5b. config_bf16  the main path of the bf16 slice: the config's trilinear
              Dirichlet Poisson with precision="bf16_x32" at nrhs 1 and 4,
              tol 3.0, 0.03 and 1e-4 (b as in 4b, max_iter 3000), beside the
              fp32 solve of the same b; 5 timed solves each after a warm-up
              (at tol 3.0 the bf16_x32 one in turns, see 5c); held to the
              plain version's ensemble as in 4b; CONVERGED at tol 3.0 with
              true residual <= 4.5
  5c. graph   the captured solves of 5 (six fp32 main paths) and 5b (tol
              3.0, nrhs 1 and 4) against the same solves run eagerly, in
              turns (eager, captured, captured, eager): the same statuses
              and iterations, x bitwise equal, no capture after the first
              solve; ms per iteration of both (median, quartiles), graph
              replays per iteration, capture times, peak memory of both
  5d. reproducible  the 8^3 bf16_x32 parallelepiped solve at tol 0.03,
              REPRODUCIBLE_RUNS times on two problems: one status, one
              iteration count, bitwise equal x
  5e. resilience  8^3 trilinear fp32 (tol 1e-6), captured: a NaN fault at
              iteration 3 DIVERGED after 3 iterations, a bitflip fault a
              failure status, `solve_resilient` clean in one attempt, a
              transient fault cured by the restart rung, a persistent one
              left failed by the default policy and cured by the backend
              rung where the policy asks for it, and a fault in column 1
              of an nrhs-4
              block that leaves the other columns' iterations alone
  5f. sharded  the element-sharded solve (`setup_problem(shard_ctx=)`) on
              gloo ranks, all on this one card (`distributed.launch.spawn`;
              NCCL needs a card per rank): every kernel at the element
              counts a shard gives it, against its plain version; then S=2
              (slab) and S=4 (the 2x2x1 box) ranks each repeat phase 4's
              six fp32 8^3 solves (the single-device kernel solve's status,
              iterations +-1, manufactured error < 1e-3, the same x on every
              rank, a repeat bitwise equal), at S=2 also the bf16_x32
              trilinear solve (tol 0.03: CONVERGED, true residual <= 1.5
              tol) and drop_exchange on shard 1 at iteration 2 under the
              ladder (rungs initial, restart; converged), and the config's
              trilinear solve (200 iterations) within SHARDED_RESIDUAL_BOUND
              and SHARDED_X_BOUND of the single-device eager one; ms per
              iteration on every rank, interface dofs and bytes an exchange,
              peak memory a rank, launches summed over the ranks.  gloo on
              one card: no multi-card number
  5g. sharded_neighbour  the same spawns with exchange="neighbour"
              (point-to-point rounds, each rank's buffers staged through
              pinned host memory: gloo takes CPU tensors only): the
              interface and interior launches of each shard (the sizes of
              its launch plan, 8^3 and 16^3) against their plain versions,
              every fp32 entry point and trilinear bf16; phase 4's six 8^3
              solves (single-device status, iterations +-1 of the psum run,
              error < 1e-3), the 8^3 bf16_x32 trilinear solve at tol 0.03 on
              the wires None, bf16 and int8 (CONVERGED, true residual <=
              1.5 tol, the bf16 wire bitwise the uncompressed one), at S=2
              drop_exchange under the ladder, the config's trilinear solve
              within the bounds of 5f; the interface dofs bitwise equal on
              every sharer after one exchange on each wire (a digest); no
              interface all_reduce; messages and bytes an application a
              rank on each wire beside the psum's, the host-staging copy
              time, and the interior launch's device time (the window the
              exchange overlaps).  gloo on one card: no multi-card number
  5h. serve   the solve service (`serving.SolveService`, buckets 1, 2, 4,
              8 of captured block solves, `serving.bucket_cache`) on the
              config's trilinear fp32 Poisson through the kernels: every
              kernel first held against its plain version at the bucket
              widths c = 2, 4, 8 (8^3 every fp32 entry point and trilinear
              bf16 at c = 2, 4; 16^3 trilinear); warm-up captures 8 graphs
              (4 solver loops, 4 verification operators) without solving;
              48 norm-30 requests at tol 0.03 arriving Poisson(3) and
              Poisson(6) a service step: no capture after warm-up, every
              request CONVERGED with true residual <= 1.5 tol, no error,
              more than one batch depth; p50/p95/p99 wall, queue and solve
              p50, requests a second, ms per block iteration at each
              width, warm-up seconds, peak memory, launches; 3 requests
              padded into bucket 4 and 1 in bucket 1 bitwise the direct
              `solve_resilient` of the unpadded block
  5i. serve_8 8^3, max_batch 4, 12 requests a stream: a service per
              kernel (precomputed, trilinear, partial Poisson; affine
              parallelepiped; merged Helmholtz), the bf16_x32 trilinear
              Poisson service (tol 1.0: rung initial) and the unmasked
              trilinear Helmholtz one (every request on precision:float32,
              its fallback ladder warmed); the gates of 5h on each
  6. timing   device time of each kernel (E=4096 and E=32768, N1=8,
              c=1; K1, K2, K3, K5 Poisson, K4 Helmholtz) from a replayed
              CUDA graph, and its time in eager calls back to back, beside
              its bound, the plain version's time and the share of a solve
              iteration spent in it; the same for each bf16 kernel beside
              its fp32 twin; K1-K5 in turns with their one-thread-per-node
              body (`ops.rowwise`: old, new, new, old); the slab body of
              each (`ops.slab`) at orders 16, 19 and 23, E=216, in turns
              with the generic body (`ops.generic`) and the plane body's
              timing-only twin (`ops.plane`), with bound and share; the
              gather at 16^3 in its fixed order in turns with index_add_
              (c = 1 and 4), bitwise repeatable
  6b. high_order  the plane body (`csrc/axhelm_plane.cu`: three launches,
              the t contraction, a pass a t-plane and its transpose, on
              register-tiled fp32 products, N1 above ops.N1_MAX = 24 up to
              ops.N1_PLANE_MAX = 48): every entry point at N1 =
              25, 32 and the cap (E = 64; 8 at the cap), c in {1, 4},
              random per-node lambdas, against its plain version (the
              tolerances and the one-ulp rule of 3 and 3b), and at the
              main path's shape; the order-31 main paths on the 4x4x4 box
              (64 elements, 1,953,125 dofs; the six of phase 5), 200
              iterations, captured and eager in turns (2 solves a turn):
              x bitwise equal, one entry-point launch per application; each
              on the 2x1x1 box against the reference backend (the same
              status, iterations +-1, Helmholtz within 1%, x within
              1e-3); each variant's bf16_x32 solve at tol 0.03 on the
              4x4x4 box, its status and inner iterations recorded; each
              plane entry point timed at E = 64 (a CUDA graph of 50
              calls) beside its bound and its plain version
  6c. staged  the staged body (`csrc/axhelm_staged.cu`: an application
              as six launches over fp32 scratch, 3xTF32 tensor-core
              contractions, N1 above ops.N1_PLANE_MAX = 48): every entry
              point at N1 = 49, 57, 64 and 96, E = 1, 3 and 8, c in {1,
              4}, and at the N1 on each side of its switch from 32 to 16
              lines an item (328 and 329), E = 1, c = 1, random per-node
              lambdas, against its plain version (the tolerances and the
              one-ulp rule of 3 and 3b); the order-63 main paths on the
              2x2x2 box (8 elements, 2,048,383 dofs; the six of phase 5),
              200 iterations, captured and eager in turns: x bitwise equal,
              one entry-point launch per application, the
              setup's peak memory; each on the 2x1x1 box at order 48
              against the reference backend (the rules of 6b); each
              variant's bf16_x32 solve at tol 0.03 on the 2x2x2 box; each
              staged entry point timed at E = 8, N1 = 64 (a CUDA graph of
              50 calls) beside its bound, its tensor-core bound
              (`staged_tensor_bound`), its plain version and the
              memory one call allocates and frees (its scratch, read from
              the allocator's peak), and the timing-only twin
              `ops.staged` at the plane body's N1 = 25, 32 and 48, E = 64,
              beside the plane body's times of 6b; the registers and
              spills of its instantiations
  6d. tuned  the tuned bodies at every N1 from 2 to 16 (their checks in
              3 and 3b): the 16^3 order-9 main path's calls against the
              plain version; its six fp32 main paths (3,048,625 dofs), 200
              iterations, captured and eager in turns: x bitwise equal, one
              entry-point launch per application; each on the 2x1x1 order-9
              box against the reference backend (the rules of 6b); each
              variant's bf16_x32 solve at tol 0.03, status and inner
              iterations recorded; every entry point timed at every N1, E =
              4096, c = 1 (a CUDA graph of 20 calls), beside the generic
              body's timing-only twin, its bound and its plain version;
              registers and shared memory of every instantiation
  6e. generic the main path of orders 16 to 23 (the slab body at order
              19): the 6x6x6 box at order 19 (1,520,875 dofs), its six fp32
              main paths and bf16_x32 solves, and the 2x1x1 order-19 box
              against the reference backend, as 6d runs its own
  6f. lint   every entry of the contract lint (`analysis.lint`, the
              reference's 14 names) on the card: the dense and refined
              solves' captured loop bodies recorded (aten ops and
              collectives) and replayed under sync debug mode "error"; the
              sharded psum, neighbour and compressed-wire solves on gloo
              ranks on this card; the service's capture counter after
              warm-up; each axhelm variant's resolved launch at N1 = 8, 10,
              20, 32, 64 against the card's shared memory, and its
              registers and spills from the build's ptxas report; every
              entry clean; each entry's checks and seconds
  6g. tune    the launch tuner (`kernels.axhelm.tune`) into a temporary
              cache: K1 and K2, fp32 and bf16, at N1 = 17, 24, 40, 48 (E =
              216, 64 above N1 = 24, c = 1), every candidate body timed (a
              CUDA graph of 20 calls, the median of 5 replays), µs and the
              winner; a fresh in-process cache resolves every winner from
              the file; each tuned route against its plain version (the
              tolerances of 3 and 3b) counted as its entry point's launch;
              with no cache file every entry point at every N1 from 2 to
              878 resolves to `ops.body_of`'s route
  6h. lm_serve  LM serving (`launch.serve`, `serving.engine`):
              qwen3-0.6b at full width (28 layers, d_model 1024, vocab
              151,936; bf16, weights from `torch.Generator` seed 0) behind
              the continuous-batching engine with `launch/serve.py --preset
              full`'s traffic (16 requests of 4-31 tokens from numpy seed
              0, 8 slots, max_len 256, 16 new tokens, no EOS), after one
              warm-up stream: every request done with 16 tokens; decode
              steps, tokens a second, slot utilisation, prefill ms an
              admission, decode-step ms (median, quartiles; a
              `synchronize()` at each end) beside its byte bound (the
              weights, the whole KV cache and the logits over
              PEAK_BYTES_PER_S), peak memory; and the logits of 3 slots
              over 8 teacher-forced ragged decode steps against a float32
              prefill of each whole sequence (no cache) on the same
              bf16-rounded weights: the float32 config within LM_F32_BOUND,
              the bf16 config within LM_BF16_BOUND (max |d| / max |logit|)
  6i. lm_train  LM training (`launch.train`, `training/`, `data/`):
              qwen3-0.6b at full width through `launch/train.py --preset
              full`'s run (bf16, remat "full", seq 4096, batch 4 of 256 in
              2 microbatches, float32 AdamW, weights from
              `torch.Generator` seed 0) under `run_resilient`: a warm-up
              step and 5 timed ones (ms median and quartiles on the host
              clock, a `synchronize()` at each end; forward and backward,
              clip and update on CUDA events), tokens a second, the
              losses, grad norms and rates, peak memory, the anchor
              checkpoint's bytes and seconds (in a temporary directory);
              the same at 8-bit AdamW for 3 steps (losses within
              LM_TRAIN_8BIT_BOUND of the float32 run's, equal at step 0;
              update ms, optimizer state bytes); bf16 against float32 at
              batch 1, seq 512 (loss, grad_norm); the reduced config
              learning (25 steps) and a run with failures at steps 6 and
              11 against an uninterrupted one (bitwise, or within 2 x the
              rates applied); the step's FLOP bound at PEAK_BF16_FLOP_PER_S
              and its share, and the float32 P.V products
  6j. lm_serve_moe  the MoE family behind the engine: moonshot-v1-16b-a3b
              at full width and full depth (48 layers, the first dense;
              64 experts, top-6, 2 shared; 28,386,592,768 parameters,
              56,785,903,616 bytes; bf16, weights from `torch.Generator`
              seed 0 written in place), after the dense models are freed;
              lm_serve's stream after a warm-up stream whose routes are
              recorded (the timed one repeats them): every request done
              with 16 tokens, tokens a second, decode-step ms (median,
              quartiles), prefill ms an admission, the build's and the
              stream's peak memory (under 80 GB); the share of routed
              assignments dropped by capacity at decode and at prefill; a
              decode step's byte bound as the reference computes it (every
              expert's weights) and counting only the experts its tokens
              were routed to; the logits of lm_serve's check on a depth-cut
              copy (the dense layer and two MoE layers, float32 and bf16
              from the same bf16-rounded weights, a capacity factor at which
              nothing is dropped): float32 within LM_F32_BOUND, bf16 within
              LM_MOE_BF16_BOUND, and the share of routes that flip between
              the two copies on the same sequences
  6k. lm_train_moe  moonshot at full width through `launch/train.py
              --preset full --layers 3` (the dense layer and two MoE
              layers; the cut printed): lm_train's batch, sequence and
              microbatches, 6 float32 AdamW steps (one a warm-up) and 3
              8-bit ones on the host clock, step 0 bitwise the same in
              both, 8-bit losses within LM_TRAIN_8BIT_BOUND; tokens a
              second, peak memory, the losses and aux losses; the step's
              FLOP bound over the active parameters and its share; the
              reduced config restarted twice under `run_resilient`,
              bitwise the uninterrupted run
  6l. lm_serve_hybrid  the hybrid family behind the engine: zamba2-2.7b
              at full width and full depth (54 Mamba-2 blocks, the shared
              attention block at 9 sites; 2,422,532,000 parameters; bf16,
              weights from `torch.Generator` seed 0) with lm_serve's
              warm-up and timed streams: every request done with 16
              tokens, tokens a second, decode-step ms (median, quartiles)
              beside its byte bound (the weights, the shared block read
              again at each further site, every block's ssm and conv
              states read and written, the KV cache, the logits, over
              PEAK_BYTES_PER_S), prefill ms an admission, peak memory;
              lm_serve's logit check against a float32 copy of the whole
              model (LM_F32_BOUND, LM_BF16_BOUND)
  6m. lm_train_hybrid  zamba2-2.7b through `launch/train.py --preset full
              --layers 12` (12 of 54 Mamba-2 blocks, 2 sites of the shared
              block; the cut printed): lm_train's batch, sequence and
              microbatches, 6
              float32 AdamW steps (one a warm-up) and 3 8-bit ones on the
              host clock, step 0 the same in both, 8-bit losses within
              LM_TRAIN_8BIT_BOUND; tokens a second, peak memory, optimizer
              state bytes; the step's FLOP bound (bf16 products at
              PEAK_BF16_FLOP_PER_S plus the SSD's float32 products at
              PEAK_FP32_FLOP_PER_S) and its share; the reduced config
              restarted twice, bitwise the uninterrupted run
  6n. lm_vlm  phi-3-vision-4.2b at full width and full depth (3,825,404,928
              parameters; bf16): a prefill at batch LM_VLM_BATCH of 144
              patches of width 1024 and LM_VLM_TEXT text tokens (numpy
              seed 1), 16 greedy decode steps through `decode_step` (ms
              each, beside the step's byte bound), every step's logits
              against a float32 copy's prefill of the longer sequence and
              the copy's own decode steps (LM_F32_BOUND, LM_BF16_BOUND);
              then trained as lm_train_hybrid, its depth cut to 8 layers
              (the cut printed)
  6o. lm_serve_xlstm  the xLSTM family behind the engine: xlstm-350m at
              full width and full depth (24 layers, 12 (mLSTM, sLSTM)
              pairs; 241,894,400 parameters; bf16) with lm_serve's
              warm-up and timed streams: every request done with 16
              tokens, tokens a second, decode-step ms (median, quartiles)
              beside its byte bound (the weights but the embedding table,
              whose rows are gathered, every pair's mLSTM and sLSTM states
              read and written, the logits, over PEAK_BYTES_PER_S),
              prefill ms an admission, peak memory; lm_serve's logit check
              against a float32 copy (LM_F32_BOUND, LM_BF16_BOUND)
  6p. lm_train_xlstm  xlstm-350m through `launch/train.py --preset full`
              at full depth, the sequence cut from 4096 to 256 (printed):
              lm_train_hybrid's steps and checks; the FLOP bound's float32
              part the sLSTM's input and recurrent products, the mLSTM's
              gates and its causal decay attention
  6q. lm_audio  seamless-m4t-medium at full width and full depth (12
              encoder and 12 decoder layers; 716,503,040 parameters;
              bf16): a prefill at batch 8 of 1,024 frames of width 1024
              and a 4-token prompt (numpy seed 1), 16 greedy decode steps
              through `decode_step` on the cross K/V at the encoder's
              length (ms each, beside the step's byte bound), every step's
              logits against a float32 copy's prefill of the longer
              sequence over the same frames and the copy's own decode
              steps (LM_F32_BOUND, LM_BF16_BOUND); then trained at full
              depth as lm_train_hybrid with 2,048 frames and 2,048 tokens
              (the cut printed), the encoder's and the cross-attention's
              products counted over all keys
  7. the `kernels` line (ten entry points, each launched on its main
     path and, as `launches_sharded`, on the sharded ones, psum and
     neighbour exchange together, and as `launches_serve` by the served
     streams of 5h and 5i, `launches_order9` on the order-9 solves, and
     their times at every N1 from 2 to 16 beside the generic body's
     (`by_n1`); their ten
     slab bodies, launched on the order-19 solves (`by_order`: beside the
     generic body and the plane twin at orders 16, 19, 23); their ten
     plane bodies, launched on the order-31 solves; and their ten
     staged bodies, launched on the order-63 solves),
     then the card line, then the result line.

Exits non-zero, printing no result, when a phase fails, when there is no
CUDA device, or when it is not run from a checkout of the repository.
Run:  python3 chip_smoke.py
"""

import contextlib
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# dense TF32 on the tensor cores; a 3xTF32 product takes three of them
PEAK_TF32_FLOP_PER_S = 495e12
RTOL_KERNEL = 1e-4
# bf16 storage: kernel and plain version each round one fp32 result once
RTOL_BF16 = 8e-3
# timed solves a turn of `in_turns` (eager, captured, captured, eager)
TURN_REPEATS = 4
# the `reproducible` phase: 8^3 bf16_x32 parallelepiped solves at tol 0.03
REPRODUCIBLE_RUNS = 8
REFINED_REPEATS = 5   # timed 16^3 bf16_x32 solves per tolerance and nrhs
REFINED_MAX_ITER = 3000
_CSRC = "src/repro_torch/kernels/axhelm/csrc"
# the body each entry point runs: one thread per node, per node column, or
# per node line
BODY = {"precomputed": "line", "trilinear": "column",
        "parallelepiped": "line", "merged": "line", "partial": "column"}
SOURCE = {"node": f"{_CSRC}/axhelm.cu", "column": f"{_CSRC}/axhelm_column.cu",
          "line": f"{_CSRC}/axhelm_line.cu", "any": f"{_CSRC}/axhelm.cu",
          "slab": f"{_CSRC}/axhelm_slab.cu",
          "plane": f"{_CSRC}/axhelm_plane.cu",
          "staged": f"{_CSRC}/axhelm_staged.cu"}
# The tuned bodies (csrc/axhelm_column.cu, axhelm_line.cu) run every N1 from
# 2 to ops.N1_TUNED_MAX = 16: phases 3 and 3b check them at every such N1 on
# TUNED_ELEMS elements (ragged blocks and groups), c = 1 and 4; phase
# `tuned` runs their main path at TUNED_ORDER, the config's 16^3 box at
# order 9 (N1 = 10; 3,048,625 dofs), as phase `high_order` runs its own, the
# 2x1x1 box at TUNED_ORDER against the reference backend, and times them
# at every N1 at E = 4096 (the config's box at each order; TUNED_TIMING_REPS
# calls a CUDA graph) beside the generic body's timing-only twin.  Phase 4's
# 8^3 solves at LOW_ORDER (the README's --order 5 path) run them too.
TUNED_ELEMS = (1, 3, 37)
TUNED_ORDER = 9
TUNED_TIMING_REPS = 20
LOW_ORDER = 5
# The orders from 16 to 23 (N1 above ops.N1_TUNED_MAX up to
# ops.N1_SLAB_MAX = 24), where the entry points run the slab body, checked
# against its plain version at every N1 of SLAB_N1 on SLAB_ELEMS elements
# (one, a few, the 6x6x6 box); the orders it is timed at beside the generic
# body and the plane twin (GENERIC_ORDERS; the generic body, a timing twin
# here, checked at their N1 on GENERIC_CHECK_ELEMS elements), and the one
# its main path runs: the GENERIC_BOX at
# GENERIC_MAIN_ORDER (216 elements, 1,520,875 dofs: the 16^3 order-7
# config's scale in fewer, larger elements), as phase `high_order` runs its
# own, the 2x1x1 box at that order against the reference backend
SLAB_N1 = tuple(range(17, 25))
SLAB_ELEMS = (1, 3, 216)
GENERIC_ORDERS = (16, 19, 23)
GENERIC_CHECK_ELEMS = 3
GENERIC_MAIN_ORDER = 19
GENERIC_BOX = (6, 6, 6)
# Phase `high_order`, the plane body (N1 above ops.N1_MAX = 24, up to
# ops.N1_PLANE_MAX = 48): the orders it is checked and timed at (N1 = 25,
# 32 and the cap), at PLANE_ELEMS elements (PLANE_ELEMS_CAP in the
# check at the cap); its main path, the order-31 solve on a 4x4x4 box (64
# elements, 1,953,125 dofs: the 16^3 order-7 config's scale in fewer,
# larger elements), HIGH_ORDER_ITERS iterations captured and eager in
# turns, HIGH_ORDER_REPEATS solves a turn; and the 2x1x1 box of its
# comparison with the reference backend (converged to HIGH_ORDER_TOL,
# status and iterations +-1, x within HIGH_ORDER_X_BOUND).
PLANE_ORDERS = (24, 31, 47)
PLANE_ELEMS = 64
PLANE_ELEMS_CAP = 8
HIGH_ORDER = 31
HIGH_ORDER_BOX = (4, 4, 4)
HIGH_ORDER_SMALL_BOX = (2, 1, 1)
HIGH_ORDER_ITERS = 200
HIGH_ORDER_REPEATS = 2
HIGH_ORDER_TOL = 1e-6
HIGH_ORDER_MAX_ITER = 2000
HIGH_ORDER_X_BOUND = 1e-3
# Unmasked Helmholtz needs ~700 iterations on that box, over which the fp32
# sums of the kernels and of the plain version, in other orders, drift
# apart: merged takes 697 iterations against the plain version's 694
# (phase `high_order`), inside the 694-700 that one-ulp re-roundings of the
# plain version's outputs take (scripts/helmholtz_spread.py).  Its
# iterations are held within this share of the reference backend's,
# Poisson's within +-1.
HIGH_ORDER_HELMHOLTZ_ITER_SHARE = 0.01
# Phase `staged`, the staged body (N1 above ops.N1_PLANE_MAX = 48): the
# orders it is checked at (N1 = 49, 57, 64, 96; 49 and 57 fit no
# power-of-two tile, 96 takes two tiles of output rows), each at the
# STAGED_ELEMS element counts; its main path, the order-63 solve on a
# 2x2x2 box (8 elements, 2,048,383 dofs: the 16^3 order-7 config's scale
# in 8 elements), run as phase `high_order` runs its own; the 2x1x1 box at
# STAGED_SMALL_ORDER of its comparison with the reference backend (the
# rules of `high_order`); its times at the main path's E and N1; and the
# timing-only twin `ops.staged` timed at the plane body's orders,
# PLANE_ELEMS elements, beside the plane body.
STAGED_ORDERS = (48, 56, 63, 95)
STAGED_ELEMS = (1, 3, 8)
# the orders on each side of the staged body's switch from 32 to 16 lines
# an item (ops.N1_STAGED_WIDE_MAX = 328), checked at E = 1, c = 1 (an
# element of 329^3 nodes is 142 MB in fp32)
STAGED_SWITCH_ORDERS = (327, 328)
STAGED_ORDER = 63
STAGED_BOX = (2, 2, 2)
STAGED_SMALL_ORDER = 48
STAGED_TWIN_ORDERS = PLANE_ORDERS
_TPU_KERNEL = "src/repro/kernels/axhelm/kernel.py"
REPLACES = {"precomputed": f"{_TPU_KERNEL}:122",
            "trilinear": f"{_TPU_KERNEL}:126",
            "parallelepiped": f"{_TPU_KERNEL}:132",
            "merged": f"{_TPU_KERNEL}:137",
            "partial": f"{_TPU_KERNEL}:154"}
# in the order of the GeomSource enum of the CUDA source
VARIANTS = ("precomputed", "trilinear", "parallelepiped", "merged", "partial")
DTYPES = ("f32", "bf16")     # the storage types: entry-point suffixes
WORD_BYTES = {"f32": 4, "bf16": 2}
# the equations each kernel takes (helmholtz flag), and the one its main
# path and its timing run solve
EQUATIONS = {"precomputed": (False, True), "trilinear": (False, True),
             "parallelepiped": (False, True), "merged": (True,),
             "partial": (False,)}
MAIN_HELMHOLTZ = {v: v == "merged" for v in VARIANTS}
# The 8^3 Helmholtz solve (lambda1 = 0.1, no Dirichlet mask) needs 700
# iterations to reach 1e-8, and its conditioning turns that residual into
# a manufactured error near 2e-4 (`python -m repro_torch.nekbone_solve
# --elements 8 8 8 --equation helmholtz --max-iter 1000 --device cpu`:
# 700 iterations, error 1.97e-4): the error bound there is 1e-3, not 1e-5.
CONVERGE_MAX_ITER = {False: 400, True: 1000}
CONVERGE_ERROR = {False: 1e-5, True: 1e-3}
# Phase 4b's 8^3 bf16_x32 solves (b of `nekbone.random_rhs`):
# (name, variant, mesh, helmholtz, dirichlet, nrhs, tol)
REFINE_CASES_8 = [
    ("trilinear", "trilinear", "trilinear", False, True, 1, 0.03),
    ("trilinear/nrhs4", "trilinear", "trilinear", False, True, 4, 0.03),
    ("precomputed", "precomputed", "trilinear", False, True, 1, 0.03),
    ("partial", "partial", "trilinear", False, True, 1, 0.03),
    ("parallelepiped", "parallelepiped", "affine", False, True, 1, 0.03),
    ("merged", "merged", "trilinear", True, True, 1, 0.03),
    ("trilinear/helmholtz_unmasked", "trilinear", "trilinear", True, False,
     1, 0.03),
    ("trilinear/tol1e-4", "trilinear", "trilinear", False, True, 1, 1e-4)]
# Phase 5b's 16^3 trilinear Dirichlet Poisson bf16_x32 solves: (nrhs, tol)
CONFIG_BF16_RUNS = [(nrhs, tol) for nrhs in (1, 4) for tol in (3.0, 0.03,
                                                               1e-4)]
# The columns of phase 4b's trilinear tol-0.03 solves that the JAX reference
# converges (`scripts/reference_refine.py`, Pallas and reference backends
# on the CPU): the nrhs-1 solve, and columns 1-3 of the nrhs-4 block; its
# column 0 lies outside refinement's envelope and ends STAGNATED in the
# reference too (true residual ~0.35 of a norm-30 b).
MUST_CONVERGE_8 = {"trilinear": (0,), "trilinear/nrhs4": (1, 2, 3)}
# The `sharded` phase: (shards, grid) of each spawn of gloo ranks on the one
# card, the 1-D slab and the (2, 2, 1) box; the phase 4 solves it repeats
# on every spawn (name, variant, helmholtz); its 16^3 bounds against the
# single-device eager solve after CONFIG.max_iter iterations (the final
# residual's relative difference and the iterates' relative L2 distance;
# PERF.md gives the spread scripts/sharded_spread.py measured at 8^3).
SHARDED = ((2, None), (4, (2, 2, 1)))
SHARDED_RUNS = [("precomputed", "precomputed", False),
                ("trilinear", "trilinear", False),
                ("partial", "partial", False),
                ("trilinear/helmholtz", "trilinear", True),
                ("merged", "merged", True),
                ("parallelepiped", "parallelepiped", False)]
SHARDED_RESIDUAL_BOUND = 0.01
SHARDED_X_BOUND = 1e-3
SHARDED_TIMEOUT_S = 300       # the gloo group's bound on one collective
# A bf16 kernel against the correctly rounded result (its plain version in
# float64, rounded once): at most this share of its outputs may round to
# another bf16 value, and none may lie more than one bf16 ulp away unless
# it is within ULP_ABS_FLOOR * max|y| (cancellation: a float32 sum's own
# error).  The plain version in float32 rounds 0-8e-5 of its outputs
# differently (`check` reports both).
ULP_RATE_BOUND = 1e-3
ULP_ABS_FLOOR = 1e-6
# Where a bf16_x32 solve ends is not a function of the operator alone: at
# the edge of refinement's envelope, a one-ulp change in a few outputs of
# the bf16 operator moves the sweep at which the true residual stops
# improving.  So the kernels are held to an ensemble of roundings of their
# plain version: the plain version itself (the reference backend), the
# correctly rounded result, and WITNESS_SEEDS runs that move a random
# WITNESS_FLIP_RATE share of the plain version's inexact outputs to their
# other bf16 neighbour — of the order of the 0-8e-5 of outputs that two
# correct float32 evaluations round apart.  Where every member agrees, the
# comparison is the plain one: same status, iterations within max(3, 5%).
WITNESS_SEEDS = 6
WITNESS_FLIP_RATE = 1e-4


# The `serve` phase: the config's trilinear Dirichlet Poisson behind the
# solve service, max_batch 8 (buckets 1, 2, 4, 8); requests the columns of
# `nekbone.random_rhs(prob, nrhs=SERVE_REQUESTS)` (norm 30 each) at tol
# 0.03 (1e-3 of the norm), arriving Poisson(rate) a service step from
# numpy seed 0, as the reference's benchmarks/bench_serve.py::serve_row
# drives its service.  `serve_8`: 8^3, max_batch 4, 12 requests a stream,
# one fp32 stream per kernel and two bf16_x32 ones: (name, variant, mesh,
# helmholtz, dirichlet, precision, tol, the rung every request must end
# on).  The bf16_x32 Poisson stream runs at tol 1.0: at 0.03 and 0.3,
# batched refinement at 8^3 stagnates on some requests (the plain version
# on the CPU), which the precision:float32 rung then answers; unmasked
# Helmholtz lies outside refinement's envelope, so every request climbs
# to precision:float32.
SERVE_MAX_BATCH = 8
SERVE_REQUESTS = 48
SERVE_RATES = (3.0, 6.0)
SERVE_TOL = 0.03
SERVE_MAX_ITER = 3000
SERVE_TIMED = 3          # timed block solves per bucket width
# the tune phase: K1 and K2 at N1 where more than one body can run them,
# on E = 216 elements up to N1_SLAB_MAX, 64 above, one column
TUNE_VARIANTS = ("precomputed", "trilinear")
TUNE_N1 = (17, 24, 40, 48)
TUNE_ELEMS = 216
TUNE_ELEMS_HIGH = 64
SERVE_8_MAX_BATCH = 4
SERVE_8_REQUESTS = 12
SERVE_8_RATE = 3.0
SERVE_8_STREAMS = [
    ("precomputed", "precomputed", "trilinear", False, True, None, 0.03,
     None),
    ("trilinear", "trilinear", "trilinear", False, True, None, 0.03, None),
    ("partial", "partial", "trilinear", False, True, None, 0.03, None),
    ("parallelepiped", "parallelepiped", "affine", False, True, None, 0.03,
     None),
    ("merged", "merged", "trilinear", True, False, None, 0.03, None),
    ("bf16_x32/trilinear", "trilinear", "trilinear", False, True,
     "bf16_x32", 1.0, "initial"),
    ("bf16_x32/trilinear/helmholtz_unmasked", "trilinear", "trilinear",
     True, False, "bf16_x32", 0.03, "precision:float32")]
SERVE_8_CHECK_COLS = (2, 4, 8)   # the bucket widths phase 3 never checked
# The lm_serve phase: the served model and `launch/serve.py --preset
# full`'s stream; the logit check's prompts (one a slot), its teacher-forced
# decode steps, and its bounds on max |d| / max |logit| against the float32
# prefill of the whole sequence: 1e-5 for the float32 config (tightened
# from 1e-4: 4.5e-7 measured on an H100), 5e-2 (the reference's bf16
# decode-vs-forward bound; 1.2e-2 measured) for the bf16 one.  Slot
# utilisation counts the decoded tokens (a request's first token comes
# from its prefill) over decode steps x slots.
LM_ARCH = "qwen3-0.6b"
LM_SLOTS = 8
LM_REQUESTS = 16
LM_MAX_LEN = 256
LM_NEW_TOKENS = 16
LM_WEIGHT_BYTES = 1_192_493_056
LM_CHECK_PROMPTS = (5, 17, 29)
LM_CHECK_STEPS = 8
LM_CHECK_MAX_LEN = 64
LM_F32_BOUND = 1e-5
LM_BF16_BOUND = 5e-2
# The lm_train phase: `launch/train.py --preset full`'s run of qwen3-0.6b
# (bf16, remat "full", seq 4096, the shape's global batch 256 cut to 4 in
# 2 microbatches, float32 AdamW), LM_TRAIN_STEPS steps of which the first
# is a warm-up; the same run at 8-bit AdamW for LM_TRAIN_8BIT_STEPS steps,
# its losses within LM_TRAIN_8BIT_BOUND of the float32 run's (equal at step
# 0; the schedule's rate is 0 at step 0, so step 2's loss is the first
# after an update); bf16 against float32 on the bf16-rounded weights at
# batch 1, seq LM_TRAIN_CHECK_SEQ (loss and grad_norm, relative); the
# reduced config learning (LM_TRAIN_LEARN_STEPS steps at lr 1e-2, warmup
# 5, grad_accum 2, the last loss below the first by more than
# LM_TRAIN_LEARN_DROP, as tests/test_training.py::test_loss_decreases asks
# of the reference) and restarting (failures at LM_TRAIN_FAIL_AT,
# checkpoints every 5, LM_TRAIN_RESTART_STEPS steps at lr 1e-2, warmup 2,
# against an uninterrupted run).
LM_TRAIN_STEPS = 6
LM_TRAIN_8BIT_STEPS = 3
LM_TRAIN_8BIT_BOUND = 1e-3
LM_TRAIN_CHECK_SEQ = 512
# tightened from 1e-2 and 5e-2: 9.6e-7 and 2.8e-5 measured on an H100
LM_TRAIN_LOSS_BOUND = 1e-4
LM_TRAIN_GNORM_BOUND = 1e-3
LM_TRAIN_LEARN_STEPS = 25
LM_TRAIN_LEARN_DROP = 0.3
LM_TRAIN_FAIL_AT = (6, 11)
LM_TRAIN_RESTART_STEPS = 15
LM_PARAMS = 596_180_992
# dense bf16 on the tensor cores (NVIDIA data sheet, SXM, 700 W)
PEAK_BF16_FLOP_PER_S = 989e12
# The lm_serve_moe phase: moonshot-v1-16b-a3b at full width and full
# depth (its parameters and weight bytes: the router and the norms are
# float32) behind the engine with lm_serve's stream.  Its logit check runs
# on a depth-cut copy (the dense layer and two MoE layers; a float32 copy
# of all 48 would be ~114 GB) at a capacity factor at which no assignment
# is dropped (capacity >= tokens: factor >= E / k), the float32 copy within
# LM_F32_BOUND and the bf16 one within LM_MOE_BF16_BOUND, the bound
# predicted before the first run: a route whose 6th and 7th experts lie
# closer than the bf16 rounding of the router's input flips, the share of
# such routes printed.
LM_MOE_ARCH = "moonshot-v1-16b-a3b"
LM_MOE_PARAMS = 28_386_592_768
LM_MOE_WEIGHT_BYTES = 56_785_903_616
LM_MOE_CHECK_LAYERS = 3
LM_MOE_CHECK_CAPACITY = 16.0
LM_MOE_BF16_BOUND = 1e-1
# The lm_train_moe phase: `launch/train.py --preset full --layers 3`'s
# run of moonshot (the dense layer and two MoE layers at full width; the
# whole model's float32 AdamW state alone would be ~340 GB), float32 and
# 8-bit AdamW for lm_train's steps; the reduced config restarted at
# lm_train's failures, bitwise the uninterrupted run.
LM_MOE_TRAIN_LAYERS = 3
# The lm_serve_hybrid phase: zamba2-2.7b at full width and full depth (54
# Mamba-2 blocks, the shared attention block at 9 sites; its parameters and
# weight bytes: a_log, dt_bias, d_skip and the norm scales are float32)
# behind the engine with lm_serve's stream, its logits checked as
# lm_serve's are (a float32 copy of the whole model fits beside it).
LM_HYBRID_ARCH = "zamba2-2.7b"
LM_HYBRID_PARAMS = 2_422_532_000
LM_HYBRID_WEIGHT_BYTES = 4_845_658_240
# The lm_train_hybrid phase: `launch/train.py --preset full --layers 12`
# of zamba2 (12 of its 54 Mamba-2 blocks, the shared block at 2 sites;
# the depth cut to fit the script in its time: full depth fits in 80 GB
# and took ~80 s); lm_train's steps, float32 then 8-bit AdamW, and the
# reduced config restarted at lm_train's failures.
LM_HYBRID_TRAIN_LAYERS = 12
# The lm_vlm phase: phi-3-vision-4.2b at full width and full depth, bf16:
# a prefill at batch LM_VLM_BATCH of 144 patches (width 1024) and
# LM_VLM_TEXT text tokens, then LM_NEW_TOKENS greedy decode steps through
# `decode_step` (no engine: it takes token prompts only), the logits held
# against a float32 copy's prefill of each longer sequence (LM_F32_BOUND,
# LM_BF16_BOUND); then `launch/train.py --preset full --layers 8`, as
# lm_train_hybrid (the depth cut from 32 to fit the script in its time).
LM_VLM_ARCH = "phi-3-vision-4.2b"
LM_VLM_PARAMS = 3_825_404_928
LM_VLM_WEIGHT_BYTES = 7_651_209_216
LM_VLM_BATCH = 8
LM_VLM_TEXT = 48
LM_VLM_MAX_LEN = 256
LM_VLM_TRAIN_LAYERS = 8
# The lm_serve_xlstm phase: xlstm-350m at full width and full depth (24
# layers, 12 (mLSTM, sLSTM) pairs; bf16, its gate weights, r, biases and
# norm scales float32) behind the engine with lm_serve's stream, its
# logits checked as lm_serve's are.  The lm_train_xlstm phase:
# `launch/train.py --preset full` at full depth with the sequence cut to
# LM_XLSTM_TRAIN_SEQ (the sLSTM runs ~20 ops a time step a layer, eagerly);
# lm_train's steps and checks otherwise.
LM_XLSTM_ARCH = "xlstm-350m"
LM_XLSTM_PARAMS = 241_894_400
LM_XLSTM_WEIGHT_BYTES = 509_349_888
LM_XLSTM_TRAIN_SEQ = 256
# The lm_audio phase: seamless-m4t-medium at full width and full depth (12
# encoder and 12 decoder layers; bf16): a prefill at batch LM_AUDIO_BATCH of
# LM_AUDIO_FRAMES frames of width 1024 and an LM_AUDIO_PROMPT-token prompt,
# LM_NEW_TOKENS greedy decode steps through `decode_step` (no engine: it
# takes token prompts only) on the self K/V widened to LM_AUDIO_MAX_LEN and
# the cross K/V at the encoder's length, the logits held against a float32
# copy's prefill of each longer sequence (LM_F32_BOUND, LM_BF16_BOUND); then
# `launch/train.py --preset full` at full depth with LM_AUDIO_TRAIN_SEQ
# frames and as many tokens (the shape's 4096 cut to fit the script in its
# time).
LM_AUDIO_ARCH = "seamless-m4t-medium"
LM_AUDIO_PARAMS = 716_503_040
LM_AUDIO_WEIGHT_BYTES = 1_433_133_056
LM_AUDIO_BATCH = 8
LM_AUDIO_FRAMES = 1024
LM_AUDIO_PROMPT = 4
LM_AUDIO_MAX_LEN = 256
LM_AUDIO_TRAIN_SEQ = 2048


def ulp_distance(a, b):
    """Per-entry distance in bf16 ulps between two bfloat16 tensors (the
    number of representable values between them, signs included)."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits + 32768), bits)
    return (ordered(a) - ordered(b)).abs()


def rounding_witness(compute, flip_rate: float = 0.0, seed: int = 0):
    """A stand-in for the kernels' plain version `ops.reference` for
    bfloat16 storage: the same arithmetic at `compute` precision, rounded
    once, then a random `flip_rate` share of the outputs that were not
    exact (numbers from torch `seed`) moved to their other bf16 neighbour.
    Other storage types go to the plain version unchanged."""
    import torch
    from repro_torch.kernels.axhelm import ops

    plain = ops.reference
    gens = {}

    def witness(x, basis, variant, geom, lam0=None, lam1=None,
                helmholtz=False):
        if x.dtype != torch.bfloat16:
            return plain(x, basis, variant, geom, lam0, lam1, helmholtz)
        y = ops.unrounded(x, basis, variant, geom, lam0, lam1, helmholtz,
                          compute=compute)
        yb = y.to(torch.bfloat16)
        if not flip_rate:
            return yb
        if x.device not in gens:
            gens[x.device] = torch.Generator(device=x.device).manual_seed(
                seed)
        wide = yb.to(y.dtype)
        up = y > wide
        pick = (torch.rand(y.shape, generator=gens[x.device],
                           device=x.device) < flip_rate) & (up | (y < wide)) \
            & (yb != 0)
        # toward +inf is one more for a positive value, one less for a
        # negative one (sign and magnitude)
        step = torch.where(up == (yb > 0), 1, -1).to(torch.int16)
        bits = yb.view(torch.int16)
        return torch.where(pick, bits + step, bits).view(torch.bfloat16)
    return witness


@contextlib.contextmanager
def plain_version(fn=None):
    """`setup_problem(backend="reference")` inside this block builds its
    operators on `fn` in place of the kernels' plain version (on the plain
    version itself when `fn` is None)."""
    from repro_torch.kernels.axhelm import ops

    saved = ops.reference
    ops.reference = fn or saved
    try:
        yield
    finally:
        ops.reference = saved


def witnesses():
    """The ensemble's members beside the reference backend: (name, plain
    version) — the correctly rounded result, then the re-rounded ones."""
    import torch

    out = [("correctly_rounded", rounding_witness(torch.float64))]
    out += [(f"rerounded_seed{s}",
             rounding_witness(torch.float32, WITNESS_FLIP_RATE, s))
            for s in range(WITNESS_SEEDS)]
    return out


def ensemble_verdict(run, members):
    """Hold one solve (`status` and `iterations` per column) against an
    ensemble of solves of the same problem: per column, its status must be
    one that a member ends in, and its iterations must lie within
    max(3, 5%) of the members' range.  Returns (problems, robust), robust
    per column: every member ends in the same status within max(3, 5%) of
    the first member's iterations."""
    problems, robust = [], []
    for c, (st, it) in enumerate(zip(run["status"], run["iterations"])):
        sts = [m["status"][c] for m in members]
        its = [m["iterations"][c] for m in members]
        lo, hi = min(its), max(its)
        robust.append(len(set(sts)) == 1 and all(
            abs(i - its[0]) <= max(3, 0.05 * its[0]) for i in its))
        if st not in sts:
            problems.append(f"column {c}: status {st} not among {sts}")
        if not lo - max(3, 0.05 * lo) <= it <= hi + max(3, 0.05 * hi):
            problems.append(f"column {c}: {it} iterations outside the "
                            f"ensemble's {lo}-{hi}")
    return problems, robust


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started (`t_s`)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def trilinear_geometry_flops(n1: int) -> int:
    """FLOPs per element of paper Alg. 3 with its shared terms: E0/E1 and
    F0/F1 per j and i (12 a component), the third Jacobian column per
    (j, i) (4 + 3 * 11), then per node the two-column assembly (12),
    K = J^T J (30), adj(K) (18), det (14), gscale (2), G (6) and gwj (2)."""
    return 2 * n1 * 3 * 12 + n1 ** 2 * (4 + 3 * 11) + n1 ** 3 * 84


def adjugate_geometry_flops(n1: int) -> int:
    """FLOPs per element of K4/K5's recomputation: Alg. 3's shared terms,
    then per node the two-column assembly (12), K = J^T J (30), adj(K) (18)
    and its scaling by the Lam2/gScale field (6) — no det, no division."""
    return 2 * n1 * 3 * 12 + n1 ** 2 * (4 + 3 * 11) + n1 ** 3 * 66


def axhelm_bound(variant: str, e: int, n1: int, helmholtz: bool = False,
                 ncols: int = 1, word: int = 4):
    """(bound_ms, bound_by, bytes, flops) of one call as the timing phase
    makes it (no user lambda fields): each input read once, the output
    written once, `word` bytes a value (4 for fp32, 2 for bf16 storage).
    Geometry words per element: K1 the 6(+1) factor fields, K2 24 vertex
    words, K3 7 words, K4 Lam2 + Lam3 + 24 words, K5 gScale + 24 words.
    The operations are fp32 in both storage types."""
    nodes = e * n1 ** 3
    nbytes = word * (2 * ncols * nodes)                    # x in, y out
    nbytes += word * {"precomputed": (6 + helmholtz) * nodes,
                   "trilinear": 24 * e,
                   "parallelepiped": 7 * e,
                   "merged": 2 * nodes + 24 * e,
                   "partial": nodes + 24 * e}[variant]
    # flop_count's F_ax
    flops = ncols * (12 * n1 ** 4 + (15 + 5 * helmholtz) * n1 ** 3) * e
    if variant == "trilinear":
        flops += e * trilinear_geometry_flops(n1)
    elif variant in ("merged", "partial"):
        flops += e * adjugate_geometry_flops(n1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def staged_tf32_products(word: int = 4) -> tuple[int, int]:
    """TF32 products the staged body issues a multiply-add in its
    gradients and in its transposed contractions at `word`-byte storage:
    (3, 3) for fp32 (lo.hi + hi.lo + hi.hi); (1, 2) for bf16, whose D-hat
    and x have no lo half (the source's kExactA, kExactB)."""
    return (3, 3) if word == 4 else (1, 2)


def staged_tensor_bound(variant: str, e: int, n1: int,
                        helmholtz: bool = False, ncols: int = 1,
                        word: int = 4):
    """(tensor_bound_ms, bound_by) of one staged-body call: axhelm_bound's
    bytes, and its operations with the 12 N1^4 products an element and
    column on the tensor cores and the rest at fp32 -- the least time a
    body that runs its contractions on the tensor cores could take, so
    that no share of the staged body reads over 100%.  Each product costs
    the TF32 products its operands need (staged_tf32_products): fp32
    storage three in all six contractions (3xTF32, PEAK_TF32 / 3); bf16
    storage, whose D-hat and x are exact in TF32, one in the three
    gradients and two in the three transposed contractions."""
    _, _, nbytes, flops = axhelm_bound(variant, e, n1, helmholtz, ncols,
                                       word)
    products = 12 * n1 ** 4 * ncols * e
    grad, transposed = staged_tf32_products(word)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (products / 2 * (grad + transposed) / PEAK_TF32_FLOP_PER_S
             + (flops - products) / PEAK_FP32_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Device time of one call: `reps` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events; the median replay over
    `reps`.  Back-to-back eager calls can be bound by the wrapper's host
    time (checks, ctypes), which a replay does not contain."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                                                # warm-up
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def drive_stream(svc, columns, rate: float, seed: int = 0):
    """Submit the tensors of `columns` as requests arriving Poisson(`rate`)
    a service step (numpy `seed`), stepping the service until every one is
    served.  Returns the requests, the depth of each served batch and the
    seconds from the first submit to the last answer (host clock after a
    synchronize)."""
    import numpy as np
    import torch
    from repro_torch.serving.solve_service import SolveRequest

    rng = np.random.default_rng(seed)
    reqs, depths = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(reqs) < len(columns) or svc.queue:
        for _ in range(min(int(rng.poisson(rate)),
                           len(columns) - len(reqs))):
            reqs.append(SolveRequest(uid=len(reqs), b=columns[len(reqs)]))
            svc.submit(reqs[-1])
        served = svc.step()
        if served:
            depths.append(served)
    torch.cuda.synchronize()
    return reqs, depths, time.perf_counter() - t0


def stream_row(svc, reqs, depths, elapsed: float, warm: int, tol: float):
    """One stream's record: captures after warm-up, batch depths,
    statuses, rungs and true residuals, wall/queue/solve percentiles in ms
    and requests a second."""
    import numpy as np

    walls = [1e3 * r.wall_s for r in reqs]
    done = [r for r in reqs if r.report is not None]
    return {
        "requests": len(reqs), "warmup_captures": warm,
        "captures_after_warmup": svc.trace_count - warm,
        "batch_depths": sorted(set(depths)), "blocks": len(depths),
        "depth_sequence": depths,
        "solve_ms": [1e3 * r.solve_s for r in reqs],
        "converged": sum(r.report.converged for r in done),
        "errors": svc.errors,
        "rungs": sorted({r.report.rung[0] for r in done}),
        "iterations": [int(r.report.iterations[0]) for r in done],
        "true_residual_max": max(float(r.report.true_residual[0])
                                 for r in done) if done else None,
        "true_residual_bound": 1.5 * tol,
        "wall_ms": {f"p{q}": float(np.percentile(walls, q))
                    for q in (50, 95, 99)},
        "queue_p50_ms": float(np.percentile([1e3 * r.queue_s
                                             for r in reqs], 50)),
        "solve_p50_ms": float(np.percentile([1e3 * r.solve_s
                                             for r in reqs], 50)),
        "requests_per_s": len(reqs) / elapsed, "seconds": elapsed}


def stream_gates(what: str, row: dict, rung=None) -> None:
    """The serving contract: nothing captured after warm-up, every
    request CONVERGED (on `rung` when given) with true residual <= 1.5
    tol, no error, more than one batch depth."""
    require(row["captures_after_warmup"] == 0,
            f"{what}: {row['captures_after_warmup']} captures after "
            f"warm-up: {row}")
    require(row["errors"] == 0 and row["converged"] == row["requests"],
            f"{what}: {row['converged']} of {row['requests']} converged, "
            f"{row['errors']} errors: {row}")
    require(row["true_residual_max"] <= row["true_residual_bound"],
            f"{what}: true residual {row['true_residual_max']} > "
            f"{row['true_residual_bound']}: {row}")
    require(len(row["batch_depths"]) > 1,
            f"{what}: one batch depth served, the gate is vacuous: {row}")
    require(rung is None or row["rungs"] == [rung],
            f"{what}: rungs {row['rungs']}, expected [{rung!r}]: {row}")


def padded_parity(what: str, svc, prob, columns, tol: float,
                  max_iter: int) -> dict:
    """Three requests served in bucket 4 (one zero-padded column) against
    the direct unpadded 3-column `solve_resilient`, and one request in
    bucket 1 against the direct single-RHS one: x bitwise equal, the same
    iterations, and nothing captured by the service."""
    import torch
    from repro_torch.resilience.retry import solve_resilient
    from repro_torch.serving.solve_service import SolveRequest

    before = svc.trace_count
    out = {}
    for n in (3, 1):
        reqs = [SolveRequest(uid=-1 - j, b=columns[j]) for j in range(n)]
        for r in reqs:
            svc.submit(r)
        require(svc.step() == n, f"{what}: {n} requests in one step")
        b = torch.stack(columns[:n], dim=-1) if n > 1 else columns[0]
        ref = solve_resilient(prob, b, tol=tol, max_iter=max_iter)
        cols = [ref.x[..., j] for j in range(n)] if n > 1 else [ref.x]
        bitwise = [torch.equal(r.report.x, x) for r, x in zip(reqs, cols)]
        iters = [[int(r.report.iterations[0]) for r in reqs],
                 [int(i) for i in ref.iterations]]
        out[f"{n}_in_bucket_{svc.cache.bucket_for(n)}"] = {
            "x_bitwise_equal": bitwise, "iterations": iters,
            "rungs": [r.report.rung[0] for r in reqs]}
        require(all(bitwise) and iters[0] == iters[1],
                f"{what}: {n} request(s) through bucket "
                f"{svc.cache.bucket_for(n)} against the direct solve: "
                f"bitwise {bitwise}, iterations {iters}")
    out["captures"] = svc.trace_count - before
    require(out["captures"] == 0, f"{what}: the parity requests captured "
            f"{out['captures']} graphs")
    return out


def sharded_rank(rank: int, world: int, grid, plan: dict) -> dict:
    """One gloo rank of the `sharded` phase (module level: the spawned
    ranks import it).  Every launch count is set to 0 before the rank
    drives each sharded main path (the psum exchange, then the neighbour
    exchange) and read after it.  `plan` carries the device (None: the
    card), the mesh sizes, the single-device numbers it is compared with
    and the files of the 16^3 right-hand side and single-device
    solution."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import gather_scatter as gs
    from repro_torch.core import mesh_gen, nekbone
    from repro_torch.distributed.context import make_solver_ctx
    from repro_torch.kernels.axhelm import ops
    from repro_torch.resilience.inject import FaultSpec
    from repro_torch.resilience.retry import solve_resilient
    from repro_torch.resilience.status import SolveStatus

    ctx = make_solver_ctx(devices=world, grid=grid, device=plan["device"])
    ctx_n = make_solver_ctx(devices=world, grid=grid, device=plan["device"],
                            exchange="neighbour")
    dev = ctx.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def mesh_of(variant, n):
        box = mesh_gen.box_mesh(n, n, n, plan["order"])
        if variant == "parallelepiped":
            return mesh_gen.deform_affine(box, seed=2)
        return mesh_gen.deform_trilinear(box, seed=3)

    def timed(prob, b, **kw):
        sync()
        t0 = time.perf_counter()
        res = nekbone.solve(prob, b, **kw)
        sync()
        return res, time.perf_counter() - t0

    def name_of(status):
        return [SolveStatus(int(c)).name for c in status.reshape(-1)]

    def sha1(t):
        return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()

    def solves_8(shard_ctx):
        """Phase 4's six fp32 8^3 solves on this shard context."""
        rows = {}
        for name, variant, helm in SHARDED_RUNS:
            prob = nekbone.setup_problem(mesh_of(variant, plan["n_conv"]),
                                         variant=variant, helmholtz=helm,
                                         backend=plan["backend"],
                                         shard_ctx=shard_ctx)
            x_true = nekbone.random_solution(prob, seed=0)
            b = nekbone.rhs_from_solution(prob, x_true)
            res, wall = timed(prob, b, tol=1e-8,
                              max_iter=plan["max_iter"][helm])
            rows[name] = {
                "status": name_of(res.status)[0],
                "iterations": int(res.iterations),
                "error": nekbone.manufactured_error(prob, res.x, x_true),
                "ms_per_iteration": wall * 1e3 / max(int(res.iterations), 1),
                "x_sha1": sha1(res.x)}
            if name == "trilinear":
                again, _ = timed(prob, b, tol=1e-8,
                                 max_iter=plan["max_iter"][helm])
                rows[name]["repeat_bitwise"] = torch.equal(res.x, again.x)
        return rows

    def refined_8(shard_ctx):
        """The 8^3 bf16_x32 trilinear solve at tol 0.03."""
        prob = nekbone.setup_problem(
            mesh_of("trilinear", plan["n_conv"]), variant="trilinear",
            backend=plan["backend"], precision="bf16_x32",
            shard_ctx=shard_ctx)
        b = nekbone.random_rhs(prob)
        res, wall = timed(prob, b, tol=0.03, max_iter=REFINED_MAX_ITER)
        return {"status": name_of(res.status), "tol": 0.03,
                "iterations": res.iterations.reshape(-1).tolist(),
                "true_residual": float(torch.linalg.norm(b - prob.op(res.x))),
                "ms_per_iteration": wall * 1e3 / max(int(res.iterations), 1),
                "x_sha1": sha1(res.x)}

    def drop_exchange_8(shard_ctx):
        """A lost exchange on shard 1 at iteration 2 under the ladder."""
        prob = nekbone.setup_problem(mesh_of("trilinear", plan["n_conv"]),
                                     variant="trilinear",
                                     backend=plan["backend"],
                                     shard_ctx=shard_ctx)
        b = nekbone.rhs_from_solution(prob, nekbone.random_solution(prob))
        rep = solve_resilient(
            prob, b, tol=1e-6, max_iter=1000, persistent=False,
            fault=FaultSpec(mode="drop_exchange", iteration=2, shard=1))
        return {"converged": rep.converged, "rung": list(rep.rung),
                "attempts": [[a.rung, name_of(torch.as_tensor(a.status)),
                              a.iterations.tolist(),
                              a.true_residual.tolist()]
                             for a in rep.attempts]}

    def config_16(shard_ctx, warm_iter):
        """The config's trilinear solve (CONFIG.max_iter iterations) after
        a warm-up solve of `warm_iter` iterations, against the
        single-device eager one."""
        cfg = plan["config"]
        ref = torch.load(cfg["path"])
        prob = nekbone.setup_problem(mesh_of("trilinear", cfg["n"]),
                                     variant="trilinear",
                                     backend=plan["backend"],
                                     shard_ctx=shard_ctx)
        b, x_ref = ref["b"].to(dev), ref["x"].to(dev)
        timed(prob, b, tol=cfg["tol"], max_iter=warm_iter)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res, wall = timed(prob, b, tol=cfg["tol"], max_iter=cfg["max_iter"])
        part = prob.partition
        row = {
            "status": name_of(res.status)[0],
            "iterations": int(res.iterations),
            "residual": float(res.residual),
            "residual_rel_diff": abs(float(res.residual) - ref["residual"])
            / ref["residual"],
            "x_rel_l2": float(torch.linalg.norm(res.x - x_ref)
                              / torch.linalg.norm(x_ref)),
            "ms_per_iteration": wall * 1e3 / max(int(res.iterations), 1),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            "elements_per_shard": part.e_per_shard,
            "interface_dofs": part.n_shared,
            "interface_dofs_here": int(part.shared_present[rank].sum()),
            "bytes_per_exchange": 4 * part.n_shared}
        return row, prob, b

    out = {"rank": rank, "device": str(dev)}
    # the psum exchange: one all_reduce of the interface dofs
    ops.reset_launch_counts()
    out["solves"] = solves_8(ctx)
    part = mesh_gen.partition_elements(mesh_of("trilinear", plan["n_conv"]),
                                       world, grid=grid)
    out["partition"] = {
        "grid": list(part.grid), "elements_per_shard": part.e_per_shard,
        "interface_dofs": part.n_shared,
        "interface_dofs_here": int(part.shared_present[rank].sum())}
    if plan["extras"]:
        out["refined"] = refined_8(ctx)
        out["drop_exchange"] = drop_exchange_8(ctx)
    out["config"], _, _ = config_16(ctx, plan["config"]["max_iter"])
    out["launches"] = {k: v for k, v in ops.launch_counts.items() if v}

    # the neighbour exchange: point-to-point rounds with the bordering
    # shards, gloo's buffers staged through pinned host memory
    ops.reset_launch_counts()
    nbr = {"solves": solves_8(ctx_n),
           "refined": {str(w): refined_8(make_solver_ctx(
               devices=world, grid=grid, device=plan["device"],
               exchange="neighbour", compress=w))
               for w in (None, "bf16", "int8")}}
    if plan["extras"]:
        nbr["drop_exchange"] = drop_exchange_8(ctx_n)
    nbr["config"], prob, b = config_16(ctx_n, 10)
    nbr["launches"] = {k: v for k, v in ops.launch_counts.items() if v}

    # the wire of one application at 16^3: every point-to-point message
    # and every all_reduce of the operator, and of the exchange alone on
    # each wire at nrhs 1 and 4 (this rank's own random partials)
    part = prob.partition
    rounds = gs.partition_rounds(part, rank, dev)
    sidx = torch.as_tensor(part.shared_idx[rank], device=dev)
    spres = torch.as_tensor(part.shared_present[rank], device=dev)
    rng = np.random.default_rng(rank)
    messages, reduced = [], []
    real_batch, real_reduce = dist.batch_isend_irecv, dist.all_reduce

    def counting_batch(p2p):
        messages.extend([op.op is dist.isend, op.tensor.nbytes]
                        for op in p2p)
        return real_batch(p2p)

    def counting_reduce(tensor, *args, **kwargs):
        reduced.append(tensor.nbytes)
        return real_reduce(tensor, *args, **kwargs)

    def census(fn):
        messages.clear()
        reduced.clear()
        fn()
        sent = [n for is_send, n in messages if is_send]
        return {"messages_sent": len(sent),
                "messages_received": len(messages) - len(sent),
                "bytes_sent": sum(sent), "all_reduce_bytes": list(reduced)}

    wire = {"psum_interface_bytes": 4 * part.n_shared}
    dist.batch_isend_irecv, dist.all_reduce = counting_batch, counting_reduce
    try:
        # the operator: its one all_reduce is globalize's (Ng,) field
        wire["operator"] = census(lambda: prob.op(b))
        for nrhs in (1, 4):
            y = torch.as_tensor(rng.standard_normal(
                (part.n_local,) + ((nrhs,) if nrhs > 1 else ())),
                dtype=torch.float32, device=dev)
            for codec in (None, "bf16", "int8"):
                wire[f"nrhs{nrhs}/{codec}"] = census(
                    lambda: gs.exchange_neighbour(y, rounds, ctx_n.group,
                                                  codec, sidx, spres))
    finally:
        dist.batch_isend_irecv, dist.all_reduce = real_batch, real_reduce
    nbr["wire"] = wire
    y = torch.as_tensor(rng.standard_normal(part.n_local),
                        dtype=torch.float32, device=dev)

    # the host staging of one 16^3 exchange: the sends' D2H copies into
    # pinned memory and their event wait, and the receives' H2D copies
    sends = [gs.shared_contrib(y, idx, mask).contiguous()
             for r in rounds for peer, idx, mask in
             ((r.lo_peer, r.lo_idx, r.lo_mask),
              (r.hi_peer, r.hi_idx, r.hi_mask)) if peer is not None]
    d2h, h2d = [], []
    for _ in range(20 if dev.type == "cuda" else 0):
        sync()
        t0 = time.perf_counter()
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in sends]
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        t1 = time.perf_counter()
        back = [t.to(dev, non_blocking=True) for t in host]
        sync()
        t2 = time.perf_counter()
        d2h.append((t1 - t0) * 1e3)
        h2d.append((t2 - t1) * 1e3)
        del back
    nbr["staging_ms"] = {"d2h_and_wait": statistics.median(d2h),
                         "h2d": statistics.median(h2d),
                         "messages": len(sends)} if d2h else None

    # every sharer of an interface dof holds the same bits after one
    # exchange, on every wire: this rank's (global id, bits) pairs
    present = np.flatnonzero(part.shared_present[rank])
    slots = torch.as_tensor(part.shared_idx[rank][present], device=dev)
    nbr["sharers"] = {"gids": part.local_to_global[rank][
        part.shared_idx[rank][present]]}
    for codec in (None, "bf16", "int8"):
        got = gs.exchange_neighbour(y, rounds, ctx_n.group, codec, sidx,
                                    spres)
        nbr["sharers"][str(codec)] = got[slots].view(torch.int32).cpu() \
            .numpy()
    out["neighbour"] = nbr
    return out


def decode_logit_ratio(m, wide, prompts, forced, dev) -> float:
    """max |decode - forward| / max |forward| over the real vocabulary:
    `m`'s ragged decode steps (a slot a prompt, each prompt prefilled at
    batch 1 and spliced in as the engine does, then the teacher-forced
    tokens of `forced`) against `wide`'s prefill of each whole sequence."""
    import numpy as np
    import torch

    cfg = m.cfg
    cache = {part: {n: torch.zeros(sd.shape, dtype=sd.dtype, device=dev)
                    for n, sd in leaves.items()}
             for part, leaves in m.cache_spec(len(prompts),
                                              LM_CHECK_MAX_LEN).items()}
    for slot, p in enumerate(prompts):           # the engine's splice
        _, c1 = m.prefill({"tokens": torch.as_tensor(p[None], device=dev)})
        for part, leaves in c1.items():
            for n, small in leaves.items():
                cache[part][n][:, slot, :small.shape[2]] = small[:, 0]
    lengths = np.array([len(p) for p in prompts])
    worst_d, worst_ref = 0.0, 0.0
    for t in range(forced.shape[1]):
        lg, cache = m.decode_step(
            torch.as_tensor(forced[:, t:t + 1], device=dev), cache,
            torch.as_tensor(lengths, device=dev))
        for slot, p in enumerate(prompts):
            seq = np.concatenate([p, forced[slot, :t + 1]])
            ref, _ = wide.prefill(
                {"tokens": torch.as_tensor(seq[None], device=dev)})
            ref = ref[0, -1, :cfg.vocab_size]
            got = lg[slot, -1, :cfg.vocab_size]
            worst_d = max(worst_d, float((got - ref).abs().max()))
            worst_ref = max(worst_ref, float(ref.abs().max()))
        lengths += 1
    return worst_d / worst_ref


@contextlib.contextmanager
def recorded_routes(into: list):
    """While the block runs, every MoE layer call's routes are appended to
    `into`: {"tokens", "capacity", "expert" (T, k), "keep" (T, k)}, device
    tensors, in call order."""
    from repro_torch.models import moe

    real = moe._route

    def route(xf, router_w, cfg, capacity):
        disp, probs, ids = real(xf, router_w, cfg, capacity)
        into.append({"tokens": xf.shape[0], "capacity": capacity,
                     "expert": disp.expert, "keep": disp.keep})
        return disp, probs, ids

    moe._route = route
    try:
        yield into
    finally:
        moe._route = real


def _memory_base() -> int:
    """Free what earlier work left and reset the peak; the bytes still
    allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _quartiles(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3}


def _timed_steps(run, n):
    """n steps of a `launch.train` run on the host clock (a synchronize()
    at each end): the state and a row of metrics a step."""
    import torch

    rows, state = [], run.state
    for i in range(n):
        batch = run.data.batch_at(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = run.step(state, batch)
        torch.cuda.synchronize()
        rows.append({"step_ms": (time.perf_counter() - t) * 1e3,
                     **{k: float(m[k]) for k in
                        ("loss", "ce", "aux", "grad_norm", "lr")}})
    return state, rows


def _reduced_restart_bitwise(arch: str, dev, phase: str) -> dict:
    """The reduced config of `arch` under `run_resilient` with failures at
    LM_TRAIN_FAIL_AT, against an uninterrupted run: the history and
    whether the final states are bitwise the same."""
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.fault_tolerance import (FailureInjector,
                                                      run_resilient)

    finals = {}
    for name, inj in (("plain", None),
                      ("faults", FailureInjector(fail_at=LM_TRAIN_FAIL_AT))):
        r = launch_train.build_run(arch, "demo", steps=40, device=dev,
                                   lr=1e-2, warmup=2)
        with tempfile.TemporaryDirectory() as tmp:
            final, hist = run_resilient(r.step, r.state, r.data.batch_at,
                                        num_steps=LM_TRAIN_RESTART_STEPS,
                                        ckpt_dir=tmp, ckpt_every=5,
                                        injector=inj)
        finals[name] = (final, hist)
    hist = finals["faults"][1]
    require(hist["restarts"] == len(LM_TRAIN_FAIL_AT) and
            int(finals["faults"][0]["step"]) == LM_TRAIN_RESTART_STEPS,
            f"{phase}: restarted run {hist}")
    bitwise = all(torch.equal(a, b) for a, b in zip(
        opt_mod.tree_leaves(finals["plain"][0]),
        opt_mod.tree_leaves(finals["faults"][0])))
    require(bitwise, f"{phase}: the reduced config's restarted state is "
            f"not bitwise the uninterrupted run's")
    return {"history": hist, "bitwise": bitwise}


def lm_serve_phase(dev, card: str) -> None:
    """Phase 6h: qwen3-0.6b at full width behind the LM serving engine, and
    its decode logits against a float32 full forward (see the docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import build_served_model, make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = configs.get(LM_ARCH)
    require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype) ==
            (28, 1024, 151_936, "bfloat16"),
            f"lm_serve: {LM_ARCH} is not the full-width bf16 config: {cfg}")
    mem_start = _memory_base()
    t0 = time.perf_counter()
    model = build_served_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    require(weight_bytes == LM_WEIGHT_BYTES,
            f"lm_serve: {weight_bytes} weight bytes, not {LM_WEIGHT_BYTES}")

    # the served stream: timed prefills and decode steps, after a warm-up
    prefill_ms, step_ms, live_kv = [], [], []
    prefill, decode_step = model.prefill, model.decode_step

    def timed(fn, into, engine=None):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            if engine is not None:   # positions the step attends to
                live_kv.append(int(engine.lengths.sum()) + engine.slots)
            return out
        return call

    def stream():
        engine = ServeEngine(model, max_len=LM_MAX_LEN, slots=LM_SLOTS,
                             eos_id=-1)
        reqs = make_requests(cfg.vocab_size, LM_REQUESTS, LM_NEW_TOKENS)
        for r in reqs:
            engine.submit(r)
        return engine, reqs

    engine, _ = stream()
    engine.run_until_drained()                      # warm-up
    engine, reqs = stream()
    model.prefill = timed(prefill, prefill_ms)
    model.decode_step = timed(decode_step, step_ms, engine)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = engine.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    bad = [(r.uid, r.done, len(r.output)) for r in reqs
           if not r.done or len(r.output) != LM_NEW_TOKENS]
    require(not bad, f"lm_serve: requests not done with {LM_NEW_TOKENS} "
            f"tokens (uid, done, tokens): {bad}")
    require(len(step_ms) == steps, f"lm_serve: {len(step_ms)} decode steps "
            f"timed in {steps} engine steps")
    tokens = sum(len(r.output) for r in reqs)
    kv = engine.cache["main"]["k"]
    kv_bytes = 2 * kv.numel() * kv.element_size()
    per_position = kv_bytes // (LM_SLOTS * LM_MAX_LEN)
    logit_bytes = LM_SLOTS * cfg.padded_vocab * 4
    step_bytes = weight_bytes + kv_bytes + logit_bytes
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    live_bound_ms = (weight_bytes + logit_bytes + per_position *
                     statistics.median(live_kv)) / PEAK_BYTES_PER_S * 1e3
    q1, _, q3 = statistics.quantiles(step_ms, n=4)
    med = statistics.median(step_ms)

    # the logits of ragged decode steps against a float32 forward
    wide = build_model(cfg.replace(dtype="float32"), dev)
    with torch.no_grad():
        for mine, theirs in zip(wide.parameters(), model.parameters()):
            mine.copy_(theirs)                       # the bf16-rounded weights
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in LM_CHECK_PROMPTS]
    forced = rng.integers(1, cfg.vocab_size,
                          size=(len(prompts), LM_CHECK_STEPS))

    ratio_f32 = decode_logit_ratio(wide, wide, prompts, forced, dev)
    ratio_bf16 = decode_logit_ratio(model, wide, prompts, forced, dev)
    require(ratio_f32 <= LM_F32_BOUND, f"lm_serve: float32 decode logits "
            f"{ratio_f32:.3e} of max |logit| from the forward > "
            f"{LM_F32_BOUND}")
    require(ratio_bf16 <= LM_BF16_BOUND, f"lm_serve: bf16 decode logits "
            f"{ratio_bf16:.3e} of max |logit| from the float32 forward > "
            f"{LM_BF16_BOUND}")
    peak = torch.cuda.max_memory_allocated()
    del wide, model, engine
    torch.cuda.empty_cache()
    emit({"phase": "lm_serve", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
          "dtype": cfg.dtype, "weight_bytes": weight_bytes,
          "build_s": build_s, "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
          "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS,
          "all_done": True, "tokens": tokens, "decode_steps": steps,
          "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
          "slot_utilisation": (tokens - LM_REQUESTS) / (steps * LM_SLOTS),
          "prefill_ms_median": statistics.median(prefill_ms),
          "prefills": len(prefill_ms),
          "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
          "step_bytes": step_bytes, "kv_cache_bytes": kv_bytes,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "bound_share": bound_ms / med,
          "bound_ms_live_kv": live_bound_ms,
          "peak_bytes": peak, "peak_bytes_above_start": peak - mem_start,
          "logit_ratio_f32": ratio_f32, "logit_bound_f32": LM_F32_BOUND,
          "logit_ratio_bf16": ratio_bf16, "logit_bound_bf16": LM_BF16_BOUND,
          "check_prompts": list(LM_CHECK_PROMPTS),
          "check_steps": LM_CHECK_STEPS,
          "seconds": time.perf_counter() - t_phase})


def lm_train_phase(dev, card: str) -> None:
    """Phase 6i: LM training through `launch/train.py`'s path (see the
    docstring)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import build_served_model
    from repro_torch.models.config import SHAPE_CASES
    from repro_torch.models.registry import build_model
    from repro_torch.training import checkpoint, optimizer as opt_mod
    from repro_torch.training.fault_tolerance import (FailureInjector,
                                                      run_resilient)
    from repro_torch.training.train_loop import (TrainConfig, init_state,
                                                 make_train_step)

    t_phase = time.perf_counter()

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size()
                   for t in opt_mod.tree_leaves(tree))

    # the clip starts a step's update: an event there splits the step
    marks = []
    real_clip, real_save = opt_mod.clip_by_global_norm, checkpoint.save

    def marked_clip(*args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return real_clip(*args, **kwargs)

    def timed(step, rows):
        """`step` on the host clock (a synchronize() at each end) and on
        CUDA events: forward and backward up to the clip, clip and update
        after it."""
        def call(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            marks.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            rows.append({"step_ms": (time.perf_counter() - t) * 1e3,
                         "fwd_bwd_ms": start.elapsed_time(marks[0]),
                         "clip_update_ms": marks[0].elapsed_time(end),
                         **{k: float(m[k]) for k in
                            ("loss", "grad_norm", "lr")}})
            return state, m
        return call

    saves = []

    def timed_save(ckpt_dir, step, state, blocking=True):
        t = time.perf_counter()
        path = real_save(ckpt_dir, step, state, blocking)
        checkpoint.wait_pending()
        saves.append({"step": step, "seconds": time.perf_counter() - t,
                      "bytes": os.path.getsize(Path(path) / "arrays.npz")})
        return path

    opt_mod.clip_by_global_norm, checkpoint.save = marked_clip, timed_save
    try:
        # 1. full width, float32 AdamW, through run_resilient
        base = _memory_base()
        run = launch_train.build_run(LM_ARCH, "full", steps=LM_TRAIN_STEPS,
                                     device=dev)
        cfg, data = run.cfg, run.data
        require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
                 cfg.remat) == (28, 1024, 151_936, "bfloat16", "full"),
                f"lm_train: {LM_ARCH} is not the full-width bf16 config "
                f"with remat full: {cfg}")
        require((data.batch, data.seq, run.tcfg.grad_accum) == (4, 4096, 2),
                f"lm_train: the full preset runs batch {data.batch}, seq "
                f"{data.seq}, grad_accum {run.tcfg.grad_accum}")
        n_params = sum(p.numel() for p in run.model.parameters())
        require(n_params == LM_PARAMS, f"lm_train: {n_params} parameters")
        accum = run.tcfg.grad_accum
        rows = []
        with tempfile.TemporaryDirectory() as tmp:
            state, hist = run_resilient(
                timed(run.step, rows), run.state, data.batch_at,
                num_steps=LM_TRAIN_STEPS, ckpt_dir=tmp,
                ckpt_every=LM_TRAIN_STEPS + 1)
        require(int(state["step"]) == LM_TRAIN_STEPS and
                hist["completed_steps"] == LM_TRAIN_STEPS and
                len(rows) == LM_TRAIN_STEPS and len(saves) == 1,
                f"lm_train: {hist}, {len(rows)} steps timed, "
                f"{len(saves)} checkpoints")
        require(all(math.isfinite(r["loss"]) and math.isfinite(
            r["grad_norm"]) for r in rows), f"lm_train: {rows}")
        opt_bytes = nbytes(state["opt"])
        peak = torch.cuda.max_memory_allocated() - base
        del run, state
        timed_rows = rows[1:]
        step_q = _quartiles([r["step_ms"] for r in timed_rows])

        # 2. the same at 8-bit AdamW
        base = _memory_base()
        run8 = launch_train.build_run(LM_ARCH, "full", steps=LM_TRAIN_STEPS,
                                      device=dev, eight_bit_optimizer=True)
        rows8, state8 = [], run8.state
        step8 = timed(run8.step, rows8)
        for i in range(LM_TRAIN_8BIT_STEPS):
            state8, _ = step8(state8, run8.data.batch_at(i))
        opt_bytes8 = nbytes(state8["opt"])
        peak8 = torch.cuda.max_memory_allocated() - base
        del run8, state8, step8
        require(rows8[0]["loss"] == rows[0]["loss"],
                f"lm_train: 8-bit step-0 loss {rows8[0]['loss']} != "
                f"{rows[0]['loss']}")
        rel8 = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(rows8, rows)]
        require(max(rel8) <= LM_TRAIN_8BIT_BOUND,
                f"lm_train: 8-bit losses {rel8} from the float32 run's")
    finally:
        opt_mod.clip_by_global_norm, checkpoint.save = real_clip, real_save

    # 3. bf16 against float32 on the bf16-rounded weights
    _memory_base()
    check = SyntheticLM(cfg, batch=1, seq=LM_TRAIN_CHECK_SEQ, seed=1,
                        device=dev).batch_at(0)
    tcfg = TrainConfig(total_steps=LM_TRAIN_STEPS)
    model16 = build_served_model(cfg, dev, seed=0)
    wide = build_model(cfg.replace(dtype="float32"), dev)
    with torch.no_grad():
        for mine, theirs in zip(wide.parameters(), model16.parameters()):
            mine.copy_(theirs)
    check_m = {}
    for name, m in (("bf16", model16), ("f32", wide)):
        _, met = make_train_step(m, tcfg)(init_state(m, tcfg), check)
        check_m[name] = {k: float(met[k]) for k in ("loss", "grad_norm")}
    del model16, wide
    loss_rel = abs(check_m["bf16"]["loss"] - check_m["f32"]["loss"]) / abs(
        check_m["f32"]["loss"])
    gnorm_rel = abs(check_m["bf16"]["grad_norm"] -
                    check_m["f32"]["grad_norm"]) / check_m["f32"]["grad_norm"]
    require(loss_rel <= LM_TRAIN_LOSS_BOUND, f"lm_train: bf16 loss "
            f"{loss_rel:.3e} from float32 > {LM_TRAIN_LOSS_BOUND}")
    require(gnorm_rel <= LM_TRAIN_GNORM_BOUND, f"lm_train: bf16 grad_norm "
            f"{gnorm_rel:.3e} from float32 > {LM_TRAIN_GNORM_BOUND}")

    # 4. the reduced config: learning, and a restarted run
    _memory_base()
    small = launch_train.build_run(LM_ARCH, "demo", steps=60, device=dev,
                                   lr=1e-2, warmup=5, grad_accum=2)
    learn, small_state = [], small.state
    t = time.perf_counter()
    for i in range(LM_TRAIN_LEARN_STEPS):
        small_state, m = small.step(small_state, small.data.batch_at(i))
        learn.append(m["loss"])
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t
    learn = [float(v) for v in learn]
    require(learn[-1] < learn[0] - LM_TRAIN_LEARN_DROP,
            f"lm_train: the reduced config did not learn: {learn}")
    finals = {}
    for name, inj in (("plain", None),
                      ("faults", FailureInjector(fail_at=LM_TRAIN_FAIL_AT))):
        r = launch_train.build_run(LM_ARCH, "demo", steps=40, device=dev,
                                   lr=1e-2, warmup=2)
        with tempfile.TemporaryDirectory() as tmp:
            final, hist = run_resilient(r.step, r.state, r.data.batch_at,
                                        num_steps=LM_TRAIN_RESTART_STEPS,
                                        ckpt_dir=tmp, ckpt_every=5,
                                        injector=inj)
        finals[name] = (final, hist)
    hist = finals["faults"][1]
    require(hist["restarts"] == len(LM_TRAIN_FAIL_AT) and
            int(finals["faults"][0]["step"]) == LM_TRAIN_RESTART_STEPS,
            f"lm_train: restarted run {hist}")
    pairs = list(zip(opt_mod.tree_leaves(finals["plain"][0]["params"]),
                     opt_mod.tree_leaves(finals["faults"][0]["params"])))
    restart_bitwise = all(torch.equal(a, b) for a, b in pairs)
    restart_diff = max(float((a.detach().float() - b.detach().float())
                             .abs().max()) for a, b in pairs)
    del finals, small, small_state
    sched = opt_mod.cosine_schedule(1e-2, 2, 40)
    lr_sum = float(sched(torch.arange(LM_TRAIN_RESTART_STEPS)).sum())
    require(restart_bitwise or restart_diff <= 2 * lr_sum,
            f"lm_train: the restarted run's parameters {restart_diff:.3e} "
            f"from the uninterrupted run's (> 2 x the rates, {lr_sum:.3e})")

    # 5. the step's FLOP bound: 6 N a token (the tied head included) and
    # causal attention; and the float32 P.V products as the step runs them
    # (every KV block, forward, recompute and two backward products)
    b, s = data.batch, data.seq
    h, dh, layers = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    attn_per_token = 3 * layers * 2 * 2 * (s / 2) * h * dh
    flops = b * s * (6 * n_params + attn_per_token)
    bound_ms = flops / PEAK_BF16_FLOP_PER_S * 1e3
    pv_flops = layers * 4 * 2 * b * h * s * s * dh
    emit({"phase": "lm_train", "card": card, "arch": cfg.name,
          "layers": layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "padded_vocab": cfg.padded_vocab, "dtype": cfg.dtype,
          "remat": cfg.remat, "params": n_params, "batch": b, "seq": s,
          "global_batch_cut_from": SHAPE_CASES["train_4k"].global_batch,
          "grad_accum": accum,
          "steps": LM_TRAIN_STEPS, "warmup_steps": 1,
          "step_ms": step_q,
          "fwd_bwd_ms": _quartiles([r["fwd_bwd_ms"] for r in timed_rows]),
          "clip_update_ms": _quartiles([r["clip_update_ms"]
                                       for r in timed_rows]),
          "warmup_step_ms": rows[0]["step_ms"],
          "tokens_per_s": b * s / (step_q["median"] / 1e3),
          "losses": [r["loss"] for r in rows],
          "grad_norms": [r["grad_norm"] for r in rows],
          "lrs": [r["lr"] for r in rows],
          "peak_bytes_above_start": peak, "opt_state_bytes": opt_bytes,
          "checkpoint_bytes": saves[0]["bytes"],
          "checkpoint_s": saves[0]["seconds"],
          "eight_bit": {"steps": LM_TRAIN_8BIT_STEPS,
                        "losses": [r["loss"] for r in rows8],
                        "loss_rel_to_fp32": rel8,
                        "bound": LM_TRAIN_8BIT_BOUND,
                        "step_ms": [r["step_ms"] for r in rows8],
                        "clip_update_ms": [r["clip_update_ms"]
                                           for r in rows8],
                        "opt_state_bytes": opt_bytes8,
                        "peak_bytes_above_start": peak8},
          "bf16_vs_f32": {"batch": 1, "seq": LM_TRAIN_CHECK_SEQ, **{
              f"{k}_{n}": v[k] for n, v in check_m.items() for k in v},
              "loss_rel": loss_rel, "loss_bound": LM_TRAIN_LOSS_BOUND,
              "grad_norm_rel": gnorm_rel,
              "grad_norm_bound": LM_TRAIN_GNORM_BOUND},
          "reduced": {"learn_losses": learn, "learn_s": learn_s,
                      "restart_history": hist,
                      "restart_bitwise": restart_bitwise,
                      "restart_max_abs_diff": restart_diff,
                      "restart_lr_sum": lr_sum},
          "model_flops": flops, "bound_ms": bound_ms, "bound_by": "flops",
          "bound_share": bound_ms / step_q["median"],
          "float32_products": "causal_attention's P.V (einsum bhqk,bkhd "
                              "of float32 p and v, models/attention.py:"
                              "86-87) and its two backward products; the "
                              "scores are a bf16 product made float32",
          "pv_f32_flops": pv_flops,
          "pv_f32_ms_at_peak": pv_flops / PEAK_FP32_FLOP_PER_S * 1e3,
          "seconds": time.perf_counter() - t_phase})


def lm_serve_moe_phase(dev, card: str) -> None:
    """Phase 6j: moonshot-v1-16b-a3b at full width and full depth behind
    the LM serving engine, and its logits on a depth-cut copy (see the
    docstring)."""
    import gc

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import build_served_model, make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = configs.get(LM_MOE_ARCH)
    require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
             cfg.num_experts, cfg.experts_per_token, cfg.moe_d_ff,
             cfg.num_shared_experts, cfg.first_dense_layers) ==
            (48, 2048, 163_840, "bfloat16", 64, 6, 1408, 2, 1),
            f"lm_serve_moe: {LM_MOE_ARCH} is not the full bf16 config: "
            f"{cfg}")
    mem_start = _memory_base()
    t0 = time.perf_counter()
    model = build_served_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - mem_start
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    require(n_params == LM_MOE_PARAMS and weight_bytes ==
            LM_MOE_WEIGHT_BYTES, f"lm_serve_moe: {n_params} parameters, "
            f"{weight_bytes} weight bytes")
    n_moe = len(model.layers)
    routed_bytes = sum(p.numel() * p.element_size() for layer in model.layers
                       for p in layer.moe.experts.parameters())
    expert_bytes = routed_bytes // (n_moe * cfg.num_experts)

    prefill_ms, step_ms = [], []
    prefill, decode_step = model.prefill, model.decode_step

    def stream():
        engine = ServeEngine(model, max_len=LM_MAX_LEN, slots=LM_SLOTS,
                             eos_id=-1)
        reqs = make_requests(cfg.vocab_size, LM_REQUESTS, LM_NEW_TOKENS)
        for r in reqs:
            engine.submit(r)
        return engine, reqs

    def tagged(fn, into):
        """fn, its calls' routes going to `into`."""
        def call(*args):
            with recorded_routes(into):
                return fn(*args)
        return call

    def timed(fn, into):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return call

    # the warm-up stream, its routes recorded; the timed stream repeats it
    # (the same weights, requests and routes) without the recording
    routes = {"prefill": [], "decode": []}
    engine, _ = stream()
    model.prefill = tagged(prefill, routes["prefill"])
    model.decode_step = tagged(decode_step, routes["decode"])
    try:
        warm_steps = engine.run_until_drained()
    finally:
        del model.prefill, model.decode_step
    engine, reqs = stream()
    model.prefill = timed(prefill, prefill_ms)
    model.decode_step = timed(decode_step, step_ms)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = engine.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    bad = [(r.uid, r.done, len(r.output)) for r in reqs
           if not r.done or len(r.output) != LM_NEW_TOKENS]
    require(not bad, f"lm_serve_moe: requests not done with "
            f"{LM_NEW_TOKENS} tokens (uid, done, tokens): {bad}")
    require(steps == warm_steps == len(step_ms) and
            len(routes["decode"]) == n_moe * steps and
            len(routes["prefill"]) == n_moe * LM_REQUESTS,
            f"lm_serve_moe: {steps} steps ({warm_steps} warm), "
            f"{len(step_ms)} timed, {len(routes['decode'])} decode and "
            f"{len(routes['prefill'])} prefill routes")
    peak = torch.cuda.max_memory_allocated()
    require(peak < 80e9, f"lm_serve_moe: peak memory {peak} bytes")

    def drops(recs):
        dropped = sum(int((~r["keep"]).sum()) for r in recs)
        return {"dropped": dropped,
                "assignments": sum(r["keep"].numel() for r in recs),
                "share": dropped / sum(r["keep"].numel() for r in recs),
                "capacities": sorted({r["capacity"] for r in recs}),
                "tokens": sorted({r["tokens"] for r in recs})}

    # experts a decode step reads when only the routed ones are read
    used = [sum(int(torch.unique(r["expert"][r["keep"]]).numel())
                for r in routes["decode"][i:i + n_moe])
            for i in range(0, len(routes["decode"]), n_moe)]
    tokens = sum(len(r.output) for r in reqs)
    kv_bytes = sum(2 * c["k"].numel() * c["k"].element_size()
                   for c in engine.cache.values())
    logit_bytes = LM_SLOTS * cfg.padded_vocab * 4
    step_bytes = weight_bytes + kv_bytes + logit_bytes
    routed_step_bytes = (step_bytes - routed_bytes +
                         statistics.median(used) * expert_bytes)
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    routed_bound_ms = routed_step_bytes / PEAK_BYTES_PER_S * 1e3
    q1, _, q3 = statistics.quantiles(step_ms, n=4)
    med = statistics.median(step_ms)
    pq1, _, pq3 = statistics.quantiles(prefill_ms, n=4)
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()

    # the logits on a depth-cut copy, float32 and bf16 from the same
    # bf16-rounded weights, at a capacity with no drop
    cut = cfg.replace(num_layers=LM_MOE_CHECK_LAYERS,
                      capacity_factor=LM_MOE_CHECK_CAPACITY)
    small = build_served_model(cut, dev, seed=0)
    wide = build_model(cut.replace(dtype="float32"), dev)
    with torch.no_grad():
        for mine, theirs in zip(wide.parameters(), small.parameters()):
            mine.copy_(theirs)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in LM_CHECK_PROMPTS]
    forced = rng.integers(1, cfg.vocab_size,
                          size=(len(prompts), LM_CHECK_STEPS))
    check = []
    with recorded_routes(check):
        ratio_f32 = decode_logit_ratio(wide, wide, prompts, forced, dev)
        ratio_bf16 = decode_logit_ratio(small, wide, prompts, forced, dev)
    check_dropped = sum(int((~r["keep"]).sum()) for r in check)
    # the routes of the same whole sequences through both copies
    seqs = [np.concatenate([p, f]) for p, f in zip(prompts, forced)]
    r16, r32 = [], []
    for m, into in ((small, r16), (wide, r32)):
        with recorded_routes(into):
            for seq in seqs:
                m.prefill({"tokens": torch.as_tensor(seq[None], device=dev)})
    flipped = sum(int(a["expert"].numel() - (
        a["expert"][:, :, None] == b["expert"][:, None, :]).any(-1).sum())
        for a, b in zip(r16, r32))
    routed = sum(a["expert"].numel() for a in r16)
    del small, wide
    torch.cuda.empty_cache()
    require(check_dropped == 0, f"lm_serve_moe: the check dropped "
            f"{check_dropped} assignments at capacity factor "
            f"{LM_MOE_CHECK_CAPACITY}")
    require(ratio_f32 <= LM_F32_BOUND, f"lm_serve_moe: float32 decode "
            f"logits {ratio_f32:.3e} of max |logit| from the forward > "
            f"{LM_F32_BOUND}")
    require(ratio_bf16 <= LM_MOE_BF16_BOUND, f"lm_serve_moe: bf16 decode "
            f"logits {ratio_bf16:.3e} of max |logit| from the float32 "
            f"forward > {LM_MOE_BF16_BOUND} (routes flipped: {flipped} of "
            f"{routed})")
    emit({"phase": "lm_serve_moe", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "dense_layers": cfg.first_dense_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
          "dtype": cfg.dtype, "params": n_params,
          "weight_bytes": weight_bytes, "routed_expert_bytes": routed_bytes,
          "build_s": build_s, "build_peak_bytes_above_start": build_peak,
          "mem_at_start": mem_start, "slots": LM_SLOTS,
          "max_len": LM_MAX_LEN, "requests": LM_REQUESTS,
          "new_tokens": LM_NEW_TOKENS, "all_done": True, "tokens": tokens,
          "decode_steps": steps, "wall_s": wall_s,
          "tokens_per_s": tokens / wall_s,
          "prefill_ms": {"median": statistics.median(prefill_ms),
                         "q1": pq1, "q3": pq3},
          "prefills": len(prefill_ms),
          "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
          "dropped_decode": drops(routes["decode"]),
          "dropped_prefill": drops(routes["prefill"]),
          "step_bytes": step_bytes, "kv_cache_bytes": kv_bytes,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "bound_share": bound_ms / med,
          "experts_read_a_step": {"median": statistics.median(used),
                                  "min": min(used), "max": max(used),
                                  "of": n_moe * cfg.num_experts},
          "routed_step_bytes": routed_step_bytes,
          "routed_bound_ms": routed_bound_ms,
          "peak_bytes": peak, "peak_bytes_above_start": peak - mem_start,
          "check": {"layers": LM_MOE_CHECK_LAYERS,
                    "capacity_factor": LM_MOE_CHECK_CAPACITY,
                    "dropped": check_dropped,
                    "prompts": list(LM_CHECK_PROMPTS),
                    "steps": LM_CHECK_STEPS,
                    "logit_ratio_f32": ratio_f32,
                    "logit_bound_f32": LM_F32_BOUND,
                    "logit_ratio_bf16": ratio_bf16,
                    "logit_bound_bf16": LM_MOE_BF16_BOUND,
                    "routes_flipped": flipped, "routes": routed,
                    "flip_share": flipped / routed},
          "seconds": time.perf_counter() - t_phase})


def lm_train_family(dev, phase: str, arch: str, layers, flops_of,
                    check_rows=None, seq=None) -> dict:
    """`launch/train.py --preset full [--layers L]`'s run of `arch`
    (lm_train's batch, sequence and microbatches, remat "full"; the
    sequence cut to `seq` where given, a cut printed, which no launcher
    flag makes):
    LM_TRAIN_STEPS float32 AdamW steps (the first a warm-up) and
    LM_TRAIN_8BIT_STEPS 8-bit ones on the host clock, step 0's loss equal
    in both and the 8-bit losses within LM_TRAIN_8BIT_BOUND; the reduced
    config restarted; the step's FLOP bound.  `flops_of(model, batch, seq)`
    checks the family's shape and returns ({"bf16": n, "f32": n}, the
    family's fields of the line); each type's products count at its peak.
    `check_rows(rows, rows8)`, where given, holds the family's own metrics
    and returns more fields.  Returns the fields of the phase's line."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models.config import SHAPE_CASES
    from repro_torch.training import optimizer as opt_mod

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size()
                   for t in opt_mod.tree_leaves(tree))

    full = configs.get(arch)
    base = _memory_base()
    full_seq = SHAPE_CASES["train_4k"].seq_len
    run = launch_train.build_run(arch, "full", steps=LM_TRAIN_STEPS,
                                 device=dev, layers=layers, seq=seq)
    cfg, data = run.cfg, run.data
    if layers is not None:
        print(f"{phase}: depth cut from {full.num_layers} to "
              f"{cfg.num_layers} layers", flush=True)
    if seq is not None:
        print(f"{phase}: sequence cut from {full_seq} to {data.seq} "
              f"positions", flush=True)
    require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
             cfg.remat) == (layers or full.num_layers, full.d_model,
                            full.vocab_size, "bfloat16", "full"),
            f"{phase}: not the full-width bf16 config with remat full: {cfg}")
    require((data.batch, data.seq, run.tcfg.grad_accum) ==
            (4, seq or full_seq, 2),
            f"{phase}: the full preset runs batch {data.batch}, seq "
            f"{data.seq}, grad_accum {run.tcfg.grad_accum}")
    n_params = sum(p.numel() for p in run.model.parameters())
    flops, fields = flops_of(run.model, data.batch, data.seq)
    accum = run.tcfg.grad_accum
    state, rows = _timed_steps(run, LM_TRAIN_STEPS)
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows), f"{phase}: {rows}")
    opt_bytes = nbytes(state["opt"])
    peak = torch.cuda.max_memory_allocated() - base
    del run, state

    base = _memory_base()
    run8 = launch_train.build_run(arch, "full", steps=LM_TRAIN_STEPS,
                                  device=dev, layers=layers, seq=seq,
                                  eight_bit_optimizer=True)
    state8, rows8 = _timed_steps(run8, LM_TRAIN_8BIT_STEPS)
    opt_bytes8 = nbytes(state8["opt"])
    peak8 = torch.cuda.max_memory_allocated() - base
    del run8, state8
    require(rows8[0]["loss"] == rows[0]["loss"],
            f"{phase}: 8-bit step-0 loss {rows8[0]['loss']} != "
            f"{rows[0]['loss']}")
    rel8 = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(rows8, rows)]
    require(max(rel8) <= LM_TRAIN_8BIT_BOUND,
            f"{phase}: 8-bit losses {rel8} from the float32 run's")
    if check_rows is not None:
        fields = {**fields, **check_rows(rows, rows8)}

    _memory_base()
    restart = _reduced_restart_bitwise(arch, dev, phase)
    step_q = _quartiles([r["step_ms"] for r in rows[1:]])
    bound_ms = (flops["bf16"] / PEAK_BF16_FLOP_PER_S +
                flops["f32"] / PEAK_FP32_FLOP_PER_S) * 1e3
    b, s = data.batch, data.seq
    return {"depth_cut": None if layers is None else {
                "layers": cfg.num_layers, "of": full.num_layers},
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
            "params": n_params, **fields, "batch": b, "seq": s,
            "seq_cut": None if seq is None else {"seq": s, "of": full_seq},
            "global_batch_cut_from": SHAPE_CASES["train_4k"].global_batch,
            "grad_accum": accum, "steps": LM_TRAIN_STEPS, "warmup_steps": 1,
            "step_ms": step_q, "warmup_step_ms": rows[0]["step_ms"],
            "tokens_per_s": b * s / (step_q["median"] / 1e3),
            "losses": [r["loss"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows],
            "lrs": [r["lr"] for r in rows],
            "peak_bytes_above_start": peak, "opt_state_bytes": opt_bytes,
            "eight_bit": {"steps": LM_TRAIN_8BIT_STEPS,
                          "losses": [r["loss"] for r in rows8],
                          "loss_rel_to_fp32": rel8,
                          "bound": LM_TRAIN_8BIT_BOUND,
                          "step_ms": [r["step_ms"] for r in rows8],
                          "opt_state_bytes": opt_bytes8,
                          "peak_bytes_above_start": peak8},
            "reduced_restart": restart,
            "model_flops": flops, "bound_ms": bound_ms, "bound_by": "flops",
            "bound_share": bound_ms / step_q["median"]}


def moe_train_flops(model, batch: int, seq: int):
    """The MoE cut's shape (the dense layer, then MoE layers of 64 experts,
    top-6) and its step's bf16 products over the active parameters (a
    token's k routed experts, the shared ones, attention, the head; no
    embedding product) with causal attention, as lm_train counts them."""
    cfg = model.cfg
    require((len(model.dense_layers), len(model.layers), cfg.num_experts,
             cfg.experts_per_token) ==
            (1, cfg.num_layers - 1, 64, 6),
            f"lm_train_moe: not the MoE layout of {LM_MOE_ARCH}: {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    routed = sum(p.numel() for layer in model.layers
                 for p in layer.moe.experts.parameters())
    expert = routed // (len(model.layers) * cfg.num_experts)
    active = (n_params - routed - model.embed["table"].numel() +
              len(model.layers) * cfg.experts_per_token * expert)
    flops = batch * seq * (6 * active +
                           _attention_flops(cfg.num_layers, cfg, seq))
    return {"bf16": flops, "f32": 0}, {
        "dense_layers": len(model.dense_layers),
        "moe_layers": len(model.layers), "experts": cfg.num_experts,
        "top_k": cfg.experts_per_token,
        "capacity_factor": cfg.capacity_factor, "active_params": active}


def moe_train_rows(rows, rows8) -> dict:
    """The MoE run's aux losses (positive at every step) and its step 0's
    aux and gradient norm, bitwise the same at 8-bit AdamW."""
    require(all(r["aux"] > 0 for r in rows), f"lm_train_moe: {rows}")
    require(all(rows8[0][k] == rows[0][k] for k in ("aux", "grad_norm")),
            f"lm_train_moe: 8-bit step 0 {rows8[0]} is not the float32 "
            f"run's {rows[0]}")
    return {"ce": [r["ce"] for r in rows], "aux": [r["aux"] for r in rows]}


def lm_train_moe_phase(dev, card: str) -> None:
    """Phase 6k: moonshot-v1-16b-a3b trained at full width, its depth cut
    (see the docstring)."""
    t_phase = time.perf_counter()
    line = lm_train_family(dev, "lm_train_moe", LM_MOE_ARCH,
                           LM_MOE_TRAIN_LAYERS, moe_train_flops,
                           moe_train_rows)
    emit({"phase": "lm_train_moe", "card": card, "arch": LM_MOE_ARCH,
          **line, "seconds": time.perf_counter() - t_phase})


def _attention_flops(sites: int, cfg, seq: int) -> float:
    """A token's causal attention products, forward and backward, at
    `sites` applications (as lm_train counts them)."""
    return 3 * sites * 2 * 2 * (seq / 2) * cfg.num_heads * \
        cfg.resolved_head_dim


def hybrid_train_flops(model, batch: int, seq: int):
    """A hybrid step's products, forward and backward (3 x forward): bf16
    -- each Mamba block's in_proj and out_proj, the shared block's
    weights at each of its sites, the head, and attention at the sites;
    float32 -- the SSD's products: the intra-chunk scores and their
    product with the inputs over a query's (chunk + 1) / 2 keys (causal,
    as attention counts s / 2), the chunk states, the inter-chunk term.
    No fields of its own."""
    cfg = model.cfg
    mats = sum(blk["in_proj"]["w"].numel() + blk["out_proj"]["w"].numel()
               for blk in model.mamba)
    shared = sum(p.numel() for p in model.shared.parameters())
    head = model.head["w"].numel()
    per_token = 6 * (mats + model.groups * shared + head) + \
        _attention_flops(model.groups, cfg, seq)
    d_inner = cfg.ssm_expand * cfg.d_model
    heads, n, p = d_inner // cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_head_dim
    chunk = min(cfg.ssm_chunk, seq)
    ssd = 3 * cfg.num_layers * 2 * heads * ((chunk + 1) / 2 * (n + p) +
                                            2 * n * p)
    return {"bf16": batch * seq * per_token, "f32": batch * seq * ssd}, {}


def vlm_train_flops(model, batch: int, seq: int):
    """A VLM step's bf16 products, forward and backward: the layers over
    every position, `vis_proj` over the patches, the head over the text
    positions, and causal attention.  No fields of its own."""
    cfg = model.cfg
    layers = sum(p.numel() for layer in model.layers
                 for p in layer.parameters() if p.ndim == 2)
    text = seq - cfg.vision_patches
    per_step = 6 * (seq * layers + cfg.vision_patches *
                    model.vis_proj["w"].numel() +
                    text * model.head["w"].numel()) + \
        seq * _attention_flops(cfg.num_layers, cfg, seq)
    return {"bf16": batch * per_step, "f32": 0}, {}


def _served_stream(model, cfg, phase: str):
    """lm_serve's stream behind the engine twice, a warm-up and a run
    timed on the host clock, each prefill and decode step of it timed (a
    synchronize() at each end); every request done with LM_NEW_TOKENS
    tokens.  Returns (the engine, its requests, {"steps", "wall_s",
    "prefill_ms", "step_ms"})."""
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.engine import ServeEngine

    prefill_ms, step_ms = [], []
    prefill, decode_step = model.prefill, model.decode_step

    def timed(fn, into):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def stream():
        engine = ServeEngine(model, max_len=LM_MAX_LEN, slots=LM_SLOTS,
                             eos_id=-1)
        reqs = make_requests(cfg.vocab_size, LM_REQUESTS, LM_NEW_TOKENS)
        for r in reqs:
            engine.submit(r)
        return engine, reqs

    engine, _ = stream()
    warm_steps = engine.run_until_drained()         # warm-up
    engine, reqs = stream()
    model.prefill = timed(prefill, prefill_ms)
    model.decode_step = timed(decode_step, step_ms)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = engine.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    bad = [(r.uid, r.done, len(r.output)) for r in reqs
           if not r.done or len(r.output) != LM_NEW_TOKENS]
    require(not bad, f"{phase}: requests not done with "
            f"{LM_NEW_TOKENS} tokens (uid, done, tokens): {bad}")
    require(steps == warm_steps == len(step_ms),
            f"{phase}: {steps} steps ({warm_steps} warm), "
            f"{len(step_ms)} timed")
    return engine, reqs, {"steps": steps, "wall_s": wall_s,
                          "prefill_ms": prefill_ms, "step_ms": step_ms}


def _float32_decode_check(model, cfg, dev, phase: str):
    """lm_serve's logit check: the ragged decode steps of a float32 copy
    of `model` (its bf16-rounded weights) and of `model` against the
    copy's prefill of each whole sequence (`decode_logit_ratio`), within
    LM_F32_BOUND and LM_BF16_BOUND.  Returns (ratio_f32, ratio_bf16, the
    peak bytes of the check); frees the copy."""
    import numpy as np
    import torch

    from repro_torch.models.registry import build_model

    wide = build_model(cfg.replace(dtype="float32"), dev)
    with torch.no_grad():
        for mine, theirs in zip(wide.parameters(), model.parameters()):
            mine.copy_(theirs)                       # the bf16-rounded weights
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in LM_CHECK_PROMPTS]
    forced = rng.integers(1, cfg.vocab_size,
                          size=(len(prompts), LM_CHECK_STEPS))
    ratio_f32 = decode_logit_ratio(wide, wide, prompts, forced, dev)
    ratio_bf16 = decode_logit_ratio(model, wide, prompts, forced, dev)
    peak_check = torch.cuda.max_memory_allocated()
    del wide
    torch.cuda.empty_cache()
    require(ratio_f32 <= LM_F32_BOUND, f"{phase}: float32 decode "
            f"logits {ratio_f32:.3e} of max |logit| from the forward > "
            f"{LM_F32_BOUND}")
    require(ratio_bf16 <= LM_BF16_BOUND, f"{phase}: bf16 decode "
            f"logits {ratio_bf16:.3e} of max |logit| from the float32 "
            f"forward > {LM_BF16_BOUND}")
    return ratio_f32, ratio_bf16, peak_check


def _serve_fields(reqs, run, step_bytes: int) -> dict:
    """A served stream's fields of its phase's line, beside the decode
    step's byte bound over PEAK_BYTES_PER_S."""
    tokens = sum(len(r.output) for r in reqs)
    step_q = _quartiles(run["step_ms"])
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    return {"slots": LM_SLOTS, "max_len": LM_MAX_LEN,
            "requests": LM_REQUESTS, "new_tokens": LM_NEW_TOKENS,
            "all_done": True, "tokens": tokens,
            "decode_steps": run["steps"], "wall_s": run["wall_s"],
            "tokens_per_s": tokens / run["wall_s"],
            "slot_utilisation": (tokens - LM_REQUESTS) /
            (run["steps"] * LM_SLOTS),
            "prefill_ms": _quartiles(run["prefill_ms"]),
            "prefills": len(run["prefill_ms"]),
            "step_ms_median": step_q["median"], "step_ms_q1": step_q["q1"],
            "step_ms_q3": step_q["q3"], "step_bytes": step_bytes,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / step_q["median"]}


def _built(cfg, dev, phase: str, params: int, weight_bytes: int):
    """`build_served_model(cfg)` on the card, timed: (the model, the
    build's seconds, the bytes allocated before it); its parameter count
    and weight bytes checked."""
    import torch

    from repro_torch.launch.serve import build_served_model

    mem_start = _memory_base()
    t0 = time.perf_counter()
    model = build_served_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = (sum(p.numel() for p in model.parameters()),
           sum(p.numel() * p.element_size() for p in model.parameters()))
    require(got == (params, weight_bytes),
            f"{phase}: {got[0]} parameters, {got[1]} weight bytes")
    return model, build_s, mem_start


def lm_serve_hybrid_phase(dev, card: str) -> None:
    """Phase 6l: zamba2-2.7b at full width and full depth behind the LM
    serving engine, and its decode logits against a float32 full forward
    (see the docstring)."""
    import torch

    from repro_torch import configs

    t_phase = time.perf_counter()
    cfg = configs.get(LM_HYBRID_ARCH)
    require((cfg.family, cfg.num_layers, cfg.attn_every, cfg.d_model,
             cfg.ssm_state, cfg.vocab_size, cfg.dtype) ==
            ("hybrid", 54, 6, 2560, 64, 32_000, "bfloat16"),
            f"lm_serve_hybrid: {LM_HYBRID_ARCH} is not the full bf16 "
            f"config: {cfg}")
    model, build_s, mem_start = _built(cfg, dev, "lm_serve_hybrid",
                                       LM_HYBRID_PARAMS,
                                       LM_HYBRID_WEIGHT_BYTES)
    sites = model.groups
    require(sites == 9, f"lm_serve_hybrid: {sites} sites")
    engine, reqs, run = _served_stream(model, cfg, "lm_serve_hybrid")
    peak = torch.cuda.max_memory_allocated()

    # a decode step's bytes: the weights, the shared block again at each
    # further site, every block's ssm and conv states read and written,
    # the whole KV cache read, the logits written
    leaf = {f"{part}.{n}": t.numel() * t.element_size()
            for part, c in engine.cache.items() for n, t in c.items()}
    shared_bytes = sum(p.numel() * p.element_size()
                       for p in model.shared.parameters())
    state_bytes = leaf["mamba.ssm"] + leaf["mamba.conv"]
    kv_bytes = leaf["attn.k"] + leaf["attn.v"]
    logit_bytes = LM_SLOTS * cfg.padded_vocab * 4
    step_bytes = (LM_HYBRID_WEIGHT_BYTES + (sites - 1) * shared_bytes +
                  2 * state_bytes + kv_bytes + logit_bytes)
    del engine

    # the logits of ragged decode steps against a float32 forward
    ratio_f32, ratio_bf16, peak_check = _float32_decode_check(
        model, cfg, dev, "lm_serve_hybrid")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "lm_serve_hybrid", "card": card, "arch": cfg.name,
          "mamba_blocks": cfg.num_layers, "attn_every": cfg.attn_every,
          "shared_sites": sites, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params": LM_HYBRID_PARAMS, "weight_bytes": LM_HYBRID_WEIGHT_BYTES,
          "build_s": build_s, **_serve_fields(reqs, run, step_bytes),
          "step_bytes_by_part": {
              "weights": LM_HYBRID_WEIGHT_BYTES,
              "shared_block_again": (sites - 1) * shared_bytes,
              "states_read_and_written": 2 * state_bytes,
              "kv_cache": kv_bytes, "logits": logit_bytes},
          "peak_bytes": peak, "peak_bytes_above_start": peak - mem_start,
          "check_peak_bytes": peak_check,
          "logit_ratio_f32": ratio_f32, "logit_bound_f32": LM_F32_BOUND,
          "logit_ratio_bf16": ratio_bf16, "logit_bound_bf16": LM_BF16_BOUND,
          "check_prompts": list(LM_CHECK_PROMPTS),
          "check_steps": LM_CHECK_STEPS,
          "seconds": time.perf_counter() - t_phase})


def lm_serve_xlstm_phase(dev, card: str) -> None:
    """Phase 6o: xlstm-350m at full width and full depth behind the LM
    serving engine, and its decode logits against a float32 full forward
    (see the docstring)."""
    import torch

    from repro_torch import configs

    t_phase = time.perf_counter()
    cfg = configs.get(LM_XLSTM_ARCH)
    require((cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
             cfg.vocab_size, cfg.dtype) ==
            ("ssm", 24, 1024, 4, 50_304, "bfloat16"),
            f"lm_serve_xlstm: {LM_XLSTM_ARCH} is not the full bf16 "
            f"config: {cfg}")
    model, build_s, mem_start = _built(cfg, dev, "lm_serve_xlstm",
                                       LM_XLSTM_PARAMS,
                                       LM_XLSTM_WEIGHT_BYTES)
    engine, reqs, run = _served_stream(model, cfg, "lm_serve_xlstm")
    peak = torch.cuda.max_memory_allocated()

    # a decode step's bytes: every weight but the embedding table (a row a
    # slot is gathered), the pairs' mLSTM and sLSTM states read and
    # written, the logits written
    table = model.embed["table"]
    weights = (LM_XLSTM_WEIGHT_BYTES - table.numel() * table.element_size()
               + LM_SLOTS * cfg.d_model * table.element_size())
    state_bytes = {part: sum(t.numel() * t.element_size()
                             for t in c.values())
                   for part, c in engine.cache.items()}
    logit_bytes = LM_SLOTS * cfg.padded_vocab * 4
    step_bytes = weights + 2 * sum(state_bytes.values()) + logit_bytes
    del engine

    ratio_f32, ratio_bf16, peak_check = _float32_decode_check(
        model, cfg, dev, "lm_serve_xlstm")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "lm_serve_xlstm", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "pairs": cfg.num_layers // 2,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params": LM_XLSTM_PARAMS, "weight_bytes": LM_XLSTM_WEIGHT_BYTES,
          "build_s": build_s, **_serve_fields(reqs, run, step_bytes),
          "step_bytes_by_part": {
              "weights_read": weights,
              "mlstm_states_read_and_written": 2 * state_bytes["mlstm"],
              "slstm_states_read_and_written": 2 * state_bytes["slstm"],
              "logits": logit_bytes},
          "peak_bytes": peak, "peak_bytes_above_start": peak - mem_start,
          "check_peak_bytes": peak_check,
          "logit_ratio_f32": ratio_f32, "logit_bound_f32": LM_F32_BOUND,
          "logit_ratio_bf16": ratio_bf16, "logit_bound_bf16": LM_BF16_BOUND,
          "check_prompts": list(LM_CHECK_PROMPTS),
          "check_steps": LM_CHECK_STEPS,
          "seconds": time.perf_counter() - t_phase})


def xlstm_train_flops(model, batch: int, seq: int):
    """An xLSTM step's products, forward and backward (3 x forward): bf16
    -- each mLSTM's qkv, ogate and out, each sLSTM's out, the head;
    float32 -- each sLSTM's input (x @ w_in, in float32) and recurrent
    (r) products and each mLSTM's gates, and the mLSTM's decay attention
    (state (dh, dh + 1)), counted causally as `hybrid_train_flops` counts
    the SSD's.  Its fields: the pairs and the mLSTM's chunk."""
    cfg = model.cfg
    require(model.pairs == cfg.num_layers // 2,
            f"lm_train_xlstm: {model.pairs} pairs of {cfg.num_layers}")
    bf16 = (sum(blk[n]["w"].numel() for blk in model.mlstm
                for n in ("qkv", "ogate", "out")) +
            sum(blk["out"]["w"].numel() for blk in model.slstm) +
            model.head["w"].numel())
    f32 = (sum(blk["w_in"]["w"].numel() + blk["r"].numel()
               for blk in model.slstm) +
           sum(blk["gates"]["w"].numel() for blk in model.mlstm))
    dh = cfg.d_model // cfg.num_heads
    n, p = dh, dh + 1
    chunk = min(cfg.attn_chunk, seq, 256)
    mlstm = 3 * model.pairs * 2 * cfg.num_heads * (
        (chunk + 1) / 2 * (n + p) + 2 * n * p)
    return {"bf16": batch * seq * 6 * bf16,
            "f32": batch * seq * (6 * f32 + mlstm)}, {
        "pairs": model.pairs, "mlstm_chunk": chunk}


def lm_train_xlstm_phase(dev, card: str) -> None:
    """Phase 6p: xlstm-350m trained at full width and full depth, its
    sequence cut (see the docstring)."""
    t_phase = time.perf_counter()
    line = lm_train_family(dev, "lm_train_xlstm", LM_XLSTM_ARCH, None,
                           xlstm_train_flops, seq=LM_XLSTM_TRAIN_SEQ)
    emit({"phase": "lm_train_xlstm", "card": card, "arch": LM_XLSTM_ARCH,
          **line, "seconds": time.perf_counter() - t_phase})


def audio_train_flops(model, batch: int, seq: int):
    """An enc-dec step's bf16 products, forward and backward, at `seq`
    frames and `seq` tokens: `audio_proj` and the encoder's layers over
    every frame, the cross K/V projections over the encoder's output, the
    decoder's layers and the tied head over every token; attention -- the
    decoder's self-attention causal (as lm_train counts it), the
    encoder's bidirectional and the cross-attention over all keys.  No
    fields of its own."""
    cfg = model.cfg
    enc = model.audio_proj["w"].numel() + sum(
        p.numel() for lp in model.enc_layers for p in lp.parameters()
        if p.ndim == 2)
    cross_kv = sum(lp["xattn"][w]["w"].numel() for lp in model.dec_layers
                   for w in ("wk", "wv"))
    dec = model.embed["table"].numel() + sum(
        p.numel() for lp in model.dec_layers for p in lp.parameters()
        if p.ndim == 2) - cross_kv
    width = cfg.num_heads * cfg.resolved_head_dim
    all_keys = 3 * 2 * 2 * seq * width      # a query over seq keys, 3 x fwd
    per_position = (6 * (enc + cross_kv + dec) +
                    _attention_flops(cfg.num_layers, cfg, seq) +
                    (cfg.encoder_layers + cfg.num_layers) * all_keys)
    return {"bf16": batch * seq * per_position, "f32": 0}, {}


def lm_train_hybrid_phase(dev, card: str) -> None:
    """Phase 6m: zamba2-2.7b trained at full width, its depth cut (see the
    docstring)."""
    t_phase = time.perf_counter()
    line = lm_train_family(dev, "lm_train_hybrid", LM_HYBRID_ARCH,
                           LM_HYBRID_TRAIN_LAYERS, hybrid_train_flops)
    emit({"phase": "lm_train_hybrid", "card": card, "arch": LM_HYBRID_ARCH,
          **line, "seconds": time.perf_counter() - t_phase})


def _timed_greedy(model, cfg, start, pos0: int):
    """`start(model)` (a batched prefill and its widened cache) once to
    warm up and once timed, then LM_NEW_TOKENS greedy decode steps from
    position `pos0`, each timed (a synchronize() at each end).  Returns
    (the prefill's ms, the steps' ms, the real-vocabulary float32 logits
    of the prefill and of every step, the tokens fed, the final cache)."""
    import torch

    start(model)                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = start(model)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    logits, fed, step_ms = [lg[:, -1, :cfg.vocab_size].float()], [], []
    for i in range(LM_NEW_TOKENS):
        nxt = torch.argmax(logits[-1], dim=-1)[:, None]
        fed.append(nxt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(nxt, cache, pos0 + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, -1, :cfg.vocab_size].float())
    return prefill_ms, step_ms, logits, fed, cache


def _greedy_against_float32(model, cfg, dev, start, batch_of, logits, fed,
                            pos0: int, phase: str):
    """`_timed_greedy`'s logits against a float32 copy of `model` (its
    bf16-rounded weights): the copy's prefill of each longer sequence
    (`batch_of(tokens fed so far)`) and the copy's own decode steps on the
    same tokens, within LM_BF16_BOUND and LM_F32_BOUND of max |logit|.
    Returns (ratio_f32, ratio_bf16, the peak bytes of the check)."""
    import torch

    from repro_torch.models.registry import build_model

    wide = build_model(cfg.replace(dtype="float32"), dev)
    with torch.no_grad():
        for mine, theirs in zip(wide.parameters(), model.parameters()):
            mine.copy_(theirs)
    _, wcache = start(wide)
    worst = {"bf16": 0.0, "f32": 0.0}
    worst_ref = 0.0
    for i in range(LM_NEW_TOKENS + 1):
        ref, _ = wide.prefill(batch_of(fed[:i]))
        ref = ref[:, -1, :cfg.vocab_size]
        worst_ref = max(worst_ref, float(ref.abs().max()))
        worst["bf16"] = max(worst["bf16"],
                            float((logits[i] - ref).abs().max()))
        if i:
            wl, wcache = wide.decode_step(fed[i - 1], wcache, pos0 + i - 1)
            worst["f32"] = max(worst["f32"], float(
                (wl[:, -1, :cfg.vocab_size] - ref).abs().max()))
    ratio_f32, ratio_bf16 = worst["f32"] / worst_ref, \
        worst["bf16"] / worst_ref
    peak_check = torch.cuda.max_memory_allocated()
    del wide, wcache
    require(ratio_f32 <= LM_F32_BOUND, f"{phase}: float32 decode logits "
            f"{ratio_f32:.3e} of max |logit| from the forward > "
            f"{LM_F32_BOUND}")
    require(ratio_bf16 <= LM_BF16_BOUND, f"{phase}: bf16 prefill and decode "
            f"logits {ratio_bf16:.3e} of max |logit| from the float32 "
            f"forward > {LM_BF16_BOUND}")
    return ratio_f32, ratio_bf16, peak_check


def _greedy_fields(prefill_ms, step_ms, batch: int, step_bytes: int) -> dict:
    """A batched greedy decode's fields of its phase's line, beside the
    decode step's byte bound over PEAK_BYTES_PER_S."""
    step_q = _quartiles(step_ms)
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    return {"decode_steps": LM_NEW_TOKENS, "prefill_ms": prefill_ms,
            "step_ms_median": step_q["median"], "step_ms_q1": step_q["q1"],
            "step_ms_q3": step_q["q3"],
            "tokens_per_s": batch * LM_NEW_TOKENS / (sum(step_ms) / 1e3),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / step_q["median"]}


def lm_audio_phase(dev, card: str) -> None:
    """Phase 6q: seamless-m4t-medium at full width and full depth, a
    batched prefill of frames and a prompt and greedy decode steps held
    against a float32 forward, then trained at full width (see the
    docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs

    t_phase = time.perf_counter()
    cfg = configs.get(LM_AUDIO_ARCH)
    require((cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.d_model,
             cfg.num_heads, cfg.vocab_size, cfg.audio_dim, cfg.dtype) ==
            ("audio", 12, 12, 1024, 16, 256_206, 1024, "bfloat16"),
            f"lm_audio: {LM_AUDIO_ARCH} is not the full bf16 config: {cfg}")
    model, build_s, mem_start = _built(cfg, dev, "lm_audio",
                                       LM_AUDIO_PARAMS,
                                       LM_AUDIO_WEIGHT_BYTES)
    b, f_n, p_n = LM_AUDIO_BATCH, LM_AUDIO_FRAMES, LM_AUDIO_PROMPT
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, p_n)),
                             device=dev)
    frames = torch.from_numpy(rng.standard_normal(
        (b, f_n, cfg.audio_dim))).to(device=dev, dtype=torch.bfloat16)

    def batch_of(fed):
        return {"tokens": torch.cat([tokens] + fed, dim=1), "frames": frames}

    def start(m):
        """m's prefill of the batch; its self K/V widened to
        LM_AUDIO_MAX_LEN, its cross K/V kept at the encoder's length
        (decode's cross-attention is unmasked)."""
        lg, c = m.prefill(batch_of([]))
        wide_self = m.cache_spec(b, LM_AUDIO_MAX_LEN)["self"]
        cache = {"self": {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                          for n, t in wide_self.items()},
                 "cross": c["cross"]}
        for n, t in c["self"].items():
            cache["self"][n][:, :, :p_n] = t
        require(c["cross"]["k"].shape[2] == f_n,
                f"lm_audio: cross K/V of {c['cross']['k'].shape[2]} "
                f"positions")
        return lg, cache

    prefill_ms, step_ms, logits, fed, cache = _timed_greedy(
        model, cfg, start, p_n)
    peak = torch.cuda.max_memory_allocated()
    # a decode step's bytes: the decoder's weights and the tied embedding
    # (the head), the cross K/V, the self K/V up to the last step's
    # length, the logits written
    dec_bytes = sum(p.numel() * p.element_size() for part in
                    (model.dec_layers, model.ln_f, model.embed)
                    for p in part.parameters())
    cross_bytes = sum(t.numel() * t.element_size()
                      for t in cache["cross"].values())
    self_bytes = sum(t[:, :, :p_n + LM_NEW_TOKENS].numel() *
                     t.element_size() for t in cache["self"].values())
    logit_bytes = b * cfg.padded_vocab * 4
    step_bytes = dec_bytes + cross_bytes + self_bytes + logit_bytes
    del cache
    ratio_f32, ratio_bf16, peak_check = _greedy_against_float32(
        model, cfg, dev, start, batch_of, logits, fed, p_n, "lm_audio")
    del model, logits
    serve = {"batch": b, "frames": f_n, "audio_dim": cfg.audio_dim,
             "prompt_tokens": p_n, "max_len": LM_AUDIO_MAX_LEN,
             "build_s": build_s,
             **_greedy_fields(prefill_ms, step_ms, b, step_bytes),
             "step_bytes": step_bytes,
             "step_bytes_by_part": {"decoder_and_head": dec_bytes,
                                    "cross_kv": cross_bytes,
                                    "self_kv": self_bytes,
                                    "logits": logit_bytes},
             "peak_bytes_above_start": peak - mem_start,
             "check_peak_bytes": peak_check,
             "logit_ratio_f32": ratio_f32, "logit_bound_f32": LM_F32_BOUND,
             "logit_ratio_bf16": ratio_bf16,
             "logit_bound_bf16": LM_BF16_BOUND}
    train = lm_train_family(dev, "lm_audio", LM_AUDIO_ARCH, None,
                            audio_train_flops, seq=LM_AUDIO_TRAIN_SEQ)
    emit({"phase": "lm_audio", "card": card, "arch": cfg.name,
          "params": LM_AUDIO_PARAMS, "weight_bytes": LM_AUDIO_WEIGHT_BYTES,
          "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.num_layers,
          "serve": serve, "train": train,
          "seconds": time.perf_counter() - t_phase})


def lm_vlm_phase(dev, card: str) -> None:
    """Phase 6n: phi-3-vision-4.2b at full width and full depth, a batched
    prefill with patches and greedy decode steps held against a float32
    forward, then trained at full width (see the docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs

    t_phase = time.perf_counter()
    cfg = configs.get(LM_VLM_ARCH)
    require((cfg.family, cfg.num_layers, cfg.d_model, cfg.vocab_size,
             cfg.vision_patches, cfg.vision_dim, cfg.dtype) ==
            ("vlm", 32, 3072, 32_064, 144, 1024, "bfloat16"),
            f"lm_vlm: {LM_VLM_ARCH} is not the full bf16 config: {cfg}")
    model, build_s, mem_start = _built(cfg, dev, "lm_vlm", LM_VLM_PARAMS,
                                       LM_VLM_WEIGHT_BYTES)
    b, p_n, text = LM_VLM_BATCH, cfg.vision_patches, LM_VLM_TEXT
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, text)),
                             device=dev)
    patches = torch.from_numpy(rng.standard_normal(
        (b, p_n, cfg.vision_dim))).to(device=dev, dtype=torch.bfloat16)

    def batch_of(fed):
        return {"tokens": torch.cat([tokens] + fed, dim=1),
                "patches": patches}

    def start(m):
        """m's prefill of the batch, its cache widened to LM_VLM_MAX_LEN."""
        lg, c = m.prefill(batch_of([]))
        cache = {part: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                        for n, t in leaves.items()}
                 for part, leaves in m.cache_spec(
                     b, LM_VLM_MAX_LEN).items()}
        for part, leaves in c.items():
            for n, t in leaves.items():
                cache[part][n][:, :, :p_n + text] = t
        return lg, cache

    prefill_ms, step_ms, logits, fed, cache = _timed_greedy(
        model, cfg, start, p_n + text)
    peak = torch.cuda.max_memory_allocated()
    kv_bytes = sum(t.numel() * t.element_size() for t in cache["main"].values())
    logit_bytes = b * cfg.padded_vocab * 4
    step_bytes = LM_VLM_WEIGHT_BYTES + kv_bytes + logit_bytes
    del cache
    ratio_f32, ratio_bf16, peak_check = _greedy_against_float32(
        model, cfg, dev, start, batch_of, logits, fed, p_n + text, "lm_vlm")
    del model, logits
    serve = {"batch": b, "patches": p_n, "vision_dim": cfg.vision_dim,
             "text_tokens": text, "cache_positions": p_n + text,
             "build_s": build_s,
             **_greedy_fields(prefill_ms, step_ms, b, step_bytes),
             "kv_cache_bytes": kv_bytes,
             "peak_bytes_above_start": peak - mem_start,
             "check_peak_bytes": peak_check,
             "logit_ratio_f32": ratio_f32, "logit_bound_f32": LM_F32_BOUND,
             "logit_ratio_bf16": ratio_bf16,
             "logit_bound_bf16": LM_BF16_BOUND}
    train = lm_train_family(dev, "lm_vlm", LM_VLM_ARCH,
                            LM_VLM_TRAIN_LAYERS, vlm_train_flops)
    emit({"phase": "lm_vlm", "card": card, "arch": cfg.name,
          "params": LM_VLM_PARAMS, "weight_bytes": LM_VLM_WEIGHT_BYTES,
          "serve": serve, "train": train,
          "seconds": time.perf_counter() - t_phase})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is missing: run chip_smoke.py from a checkout "
             "of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.analysis import lint
    from repro_torch.configs.nekbone import CONFIG
    from repro_torch.core import axhelm as core_axhelm
    from repro_torch.core import gather_scatter as gs
    from repro_torch.core import graphs, mesh_gen, nekbone
    from repro_torch.core import pcg as pcg_mod
    from repro_torch.core.spectral import basis
    from repro_torch.distributed.launch import spawn
    from repro_torch.kernels.axhelm import build, ops, tune
    from repro_torch.resilience.inject import FaultSpec
    from repro_torch.resilience.retry import RetryPolicy, solve_resilient
    from repro_torch.resilience.status import SolveStatus, is_failure
    from repro_torch.serving.solve_service import SolveService

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    require(smi.returncode == 0 and smi.stdout.strip(),
            f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    report = build.ptxas_report()
    inst = build.ptxas_instantiations(report)
    build_line = {"phase": "build", "library": str(lib_path.relative_to(ROOT)),
                  "seconds": build_s, "instantiations": inst}
    reported = {(c.get("variant"), c.get("body"), c.get("n1"), c.get("dtype"))
                for c in inst if "registers" in c}
    # every entry point's body, the generic body of every entry point, and
    # the one-thread-per-node twins of the column and line kernels that
    # phase 6 times
    expected = {(v, BODY[v], n, dt) for v in VARIANTS for n in ops.KERNEL_N1
                for dt in DTYPES}
    tuned_regs = {f"{c['variant']}/{c['dtype']}/{c['n1']}": [
        c["registers"], c["smem_bytes"]] for c in inst
        if c.get("body") in ("column", "line") and "registers" in c}
    expected |= {(v, body, None, dt) for v in VARIANTS for dt in DTYPES
                 for body in ("any", "slab", "plane")}
    # the staged body's kernels: each variant's t gradient, and the
    # contractions every variant shares
    expected |= {(v, "staged", None, dt) for v in VARIANTS + (None,)
                 for dt in DTYPES}
    staged_passes = sorted((c["variant"] or "", c["pass"], c["dtype"])
                           for c in inst if c.get("body") == "staged")
    want_passes = sorted([("", step, dt)
                          for step in build.STAGED_SHARED_PASSES
                          for dt in DTYPES] +
                         [(v, step, dt) for v in VARIANTS
                          for step in build.STAGED_VARIANT_PASSES
                          for dt in DTYPES])
    expected |= {(v, "node", n, dt) for v in ops.ROWWISE_VARIANTS
                 for n in ops.ROWWISE_N1 for dt in DTYPES}
    # the plane body's kernels: each variant's plane pass, and the line
    # contractions every variant shares
    expected |= {(None, "plane", None, dt) for dt in DTYPES}
    plane_passes = sorted((c["variant"] or "", c["pass"], c["dtype"])
                          for c in inst if c.get("body") == "plane")
    want_plane = sorted([("", step, dt)
                         for step in build.PLANE_SHARED_PASSES
                         for dt in DTYPES] +
                        [(v, step, dt) for v in VARIANTS
                         for step in build.PLANE_VARIANT_PASSES
                         for dt in DTYPES])
    # the slab body's kernels: each variant's pass over its slabs, and the
    # transposed t contraction every variant shares
    expected |= {(None, "slab", None, dt) for dt in DTYPES}
    slab_passes = sorted((c["variant"] or "", c["pass"], c["dtype"])
                         for c in inst if c.get("body") == "slab")
    want_slab = sorted([("", step, dt) for step in build.SLAB_SHARED_PASSES
                        for dt in DTYPES] +
                       [(v, step, dt) for v in VARIANTS
                        for step in build.SLAB_VARIANT_PASSES
                        for dt in DTYPES])
    missing = sorted(expected - reported)
    if missing:     # an unfamiliar ptxas format: show the report as it is
        build_line["ptxas"] = report
    spilled = [c for c in inst
               if c.get("spill_stores", 0) or c.get("spill_loads", 0)]
    emit(build_line)
    require(not missing, f"no ptxas report for instantiations {missing}")
    require(staged_passes == want_passes,
            f"the staged body's kernels {staged_passes}, expected "
            f"{want_passes}")
    require(ops.KERNELS_PER_APPLICATION["staged"] == ops.STAGED_KERNELS
            == len(build.STAGED_SHARED_PASSES)
            + len(build.STAGED_VARIANT_PASSES) == 6,
            f"the staged body launches {ops.STAGED_KERNELS} kernels an "
            f"application, expected 6")
    require(plane_passes == want_plane,
            f"the plane body's kernels {plane_passes}, expected "
            f"{want_plane}")
    require(slab_passes == want_slab,
            f"the slab body's kernels {slab_passes}, expected {want_slab}")
    require(ops.KERNELS_PER_APPLICATION["slab"] == ops.SLAB_KERNELS
            == len(build.SLAB_SHARED_PASSES)
            + len(build.SLAB_VARIANT_PASSES) == 2,
            f"the slab body launches {ops.SLAB_KERNELS} kernels an "
            f"application, expected 2")
    require(not spilled, f"instantiations spill registers: {spilled}")

    # 3. kernels against their plain versions ------------------------------
    rng = np.random.default_rng(2024)
    torch_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}
    rtol = {"f32": RTOL_KERNEL, "bf16": RTOL_BF16}
    entries = [(v, dt) for dt in DTYPES for v in VARIANTS]

    def entry(variant, dt):
        return ops.entry_point(variant, torch_dtype[dt])

    def generic_name(variant, dt):
        """The generic body's C symbol for an entry point."""
        return f"{entry(variant, dt)}_any"

    def slab_name(variant, dt):
        """The slab body's C symbol for an entry point."""
        return f"{entry(variant, dt)}_slab"

    def plane_name(variant, dt):
        """The plane body's C symbol for an entry point."""
        return f"{entry(variant, dt)}_plane"

    def staged_name(variant, dt):
        """The staged body's C symbol for an entry point."""
        return f"{entry(variant, dt)}_staged"

    def body_name(variant, dt, n1):
        """The C symbol an entry point's launch at `n1` reaches."""
        return {"any": generic_name, "slab": slab_name, "plane": plane_name,
                "staged": staged_name}.get(
            ops.body_of(variant, n1), entry)(variant, dt)

    # the timing twins `check` can run in place of the routed body
    twins = {"slab": (ops.slab, slab_name), "any": (ops.generic, generic_name)}

    names = [name(v, dt)
             for name in (entry, generic_name, slab_name, plane_name,
                          staged_name)
             for v, dt in entries]
    worst = dict.fromkeys(names, 0.0)
    cases = {dt: [] for dt in DTYPES}

    def operands(variant, verts, b, helm, lam0=None, lam1=None, dt="f32"):
        """geom and lambda-slot kwargs of one kernel call, assembled from
        vertices and the user's lambdas by the entry points' own
        `make_axhelm_elem_ops` in storage type `dt`: merged takes Lam2/Lam3
        of lam0/lam1, partial gScale."""
        elem_ops, _, _ = core_axhelm.make_axhelm_elem_ops(
            variant, b, verts, lam0=lam0, lam1=lam1, helmholtz=helm,
            dtype=torch_dtype[dt], backend="cuda", device=dev)
        return elem_ops.pop("geom"), elem_ops

    ulps = {name(v, "bf16"): {"kernel": [0, 0, 0], "plain": [0, 0, 0]}
            for v in VARIANTS
            for name in (entry, generic_name, slab_name, plane_name,
                         staged_name)}
    small_ulps = {}     # outputs off and outputs of the small bf16 calls

    def rounding_check(name, y, y_p, x, b, variant, geom, label, kw):
        """A bf16 call's outputs against the correctly rounded ones: counts
        of 0, 1 and more ulps apart, for the kernel and its plain version;
        the kernel held to ULP_RATE_BOUND and ULP_ABS_FLOOR."""
        y_e = ops.unrounded(x, b, variant, geom, compute=torch.float64,
                            **kw).to(torch.bfloat16)
        floor = ULP_ABS_FLOOR * float(y_e.float().abs().max())
        for who, yy in (("kernel", y), ("plain", y_p)):
            d = ulp_distance(yy, y_e)
            counts = [int((d == 0).sum()), int((d == 1).sum()),
                      int((d > 1).sum())]
            ulps[name][who] = [a + c for a, c in zip(ulps[name][who],
                                                      counts)]
            if who == "kernel":
                far = int(((d > 1) & ((yy.float() - y_e.float()).abs()
                                      > floor)).sum())
                share = 1.0 - counts[0] / d.numel()
                # the share is judged on a call of at least 1 /
                # ULP_RATE_BOUND outputs, where one output off is within
                # it; smaller calls are pooled by entry point (after 3b)
                if d.numel() * ULP_RATE_BOUND < 1:
                    pool = small_ulps.setdefault(name, [0, 0])
                    pool[0] += d.numel() - counts[0]
                    pool[1] += d.numel()
                    share = 0.0
                require(share <= ULP_RATE_BOUND and far == 0,
                        f"{label}: {share:.2e} of the outputs off the "
                        f"correctly rounded value (bound {ULP_RATE_BOUND}), "
                        f"{far} by more than one ulp")

    def check(variant, b, x, geom, label, dt="f32", twin=None, **kw):
        """One kernel call against its plain version (and, for bf16, both
        against the correctly rounded result); returns the largest
        absolute difference (in fp32).  At N1 in ops.KERNEL_N1 the call
        runs the entry point's tuned body, above that up to
        ops.N1_SLAB_MAX its slab body, above that its plane body, above
        ops.N1_PLANE_MAX its staged body; with a `twin` of `twins` ("slab",
        "any"), that body through its timing twin, whatever the routing."""
        run, name_of = twins.get(twin, (ops.axhelm, None))
        y = run(x, b, variant, geom, **kw)
        torch.cuda.synchronize()
        y_p = ops.reference(x, b, variant, geom, **kw)
        torch.cuda.synchronize()
        require(y.dtype == x.dtype, f"{label}: y is {y.dtype}")
        name = name_of(variant, dt) if name_of else \
            body_name(variant, dt, b.n1)
        if dt == "bf16":
            rounding_check(name, y, y_p, x, b, variant, geom, label, kw)
        y, y_p = y.float(), y_p.float()
        require(bool(torch.isfinite(y).all()), f"{label}: non-finite y")
        abs_err = float((y - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        worst[name] = max(worst[name], rel)
        cases[dt].append({"case": label, "rel_err": rel})
        require(rel <= rtol[dt], f"{label}: relative error {rel:.3e} > "
                f"{rtol[dt]}")
        return abs_err

    def mesh_for(variant, box):
        """The entry point's mesh: affine for parallelepiped, else
        trilinear-deformed."""
        if variant == "parallelepiped":
            return mesh_gen.deform_affine(box, seed=2)
        return mesh_gen.deform_trilinear(box, seed=3)

    nx, ny, nz = CONFIG.elements
    b_cfg = basis(CONFIG.order)
    cfg_box = mesh_gen.box_mesh(nx, ny, nz, CONFIG.order)
    cfg_meshes = {v: mesh_for(v, cfg_box) for v in ("trilinear",
                                                    "parallelepiped")}

    def cfg_mesh_for(variant):
        return cfg_meshes["parallelepiped" if variant == "parallelepiped"
                          else "trilinear"]

    e_main = len(cfg_box.verts)
    n1 = b_cfg.n1
    main_abs = {}
    gen = torch.Generator(device=dev)

    def main_operands(variant, verts, helm, dt="f32"):
        """Operands of the main path's call, with setup_problem's scalar
        lambdas: none for Poisson, lam0=1 and lam1=0.1 for Helmholtz."""
        lams = (1.0, 0.1) if helm else (None, None)
        return operands(variant, verts, b_cfg, helm, *lams, dt=dt)

    def high_mesh_for(variant, meshes):
        return meshes["parallelepiped" if variant == "parallelepiped"
                      else "trilinear"]

    def meshes_of(box):
        """A box's affine (parallelepiped) and trilinear meshes."""
        return {v: mesh_for(v, box) for v in ("trilinear", "parallelepiped")}

    def check_order(b, e, meshes, seed, name_of, cols=(1, 4), twin=None):
        """Every entry point at basis b on the first e elements of
        `meshes` against its plain version: each variant's equations, fp32
        and bf16, c in `cols`, random per-node lambdas (torch seed
        `seed`); `twin` as `check` takes it."""
        node = (e,) + (b.n1,) * 3
        gen.manual_seed(seed)
        lam0 = 1 + 0.3 * torch.rand(node, generator=gen, device=dev)
        lam1 = 0.5 + 0.2 * torch.rand(node, generator=gen, device=dev)
        xs = {c: torch.randn((e, c, 1) + (b.n1,) * 3, generator=gen,
                             device=dev) for c in cols}
        for variant in VARIANTS:
            verts = torch.as_tensor(high_mesh_for(variant, meshes).verts[:e],
                                    dtype=torch.float32, device=dev)
            for helm, dt in [(h, dt) for h in EQUATIONS[variant]
                             for dt in DTYPES]:
                geom, kw = operands(variant, verts, b, helm, lam0,
                                    lam1 if helm else None, dt=dt)
                for c, x32 in xs.items():
                    x = x32.to(torch_dtype[dt])
                    check(variant, b, x[:, 0, 0] if c == 1 else x, geom,
                          f"{name_of(variant, dt)} N1={b.n1} E={e} "
                          f"{'helmholtz' if helm else 'poisson'} c={c}",
                          dt=dt, twin=twin, helmholtz=helm, **kw)

    def check_main_call(b, meshes, name_of, into=None):
        """Each entry point's call on its main path (every element of
        `meshes`, c = 1, setup's scalar lambdas) against its plain
        version, its largest absolute difference into `into` (by default
        `main_abs`)."""
        e = len(meshes["trilinear"].verts)
        for variant, dt in entries:
            helm = MAIN_HELMHOLTZ[variant]
            verts = torch.as_tensor(high_mesh_for(variant, meshes).verts,
                                    dtype=torch.float32, device=dev)
            lams = (1.0, 0.1) if helm else (None, None)
            geom, kw = operands(variant, verts, b, helm, *lams, dt=dt)
            gen.manual_seed(b.n)
            x = torch.randn((e,) + (b.n1,) * 3, generator=gen,
                            device=dev).to(torch_dtype[dt])
            name = name_of(variant, dt)
            (main_abs if into is None else into)[name] = check(
                variant, b, x, geom, f"{name} main path E={e} N1={b.n1} "
                f"{'helmholtz' if helm else 'poisson'} c=1", dt=dt,
                helmholtz=helm, **kw)
            del geom, kw, x, verts

    # the tuned bodies at every N1 they run: E = 1, 3 and 37 (ragged
    # blocks and groups), c = 1 and 4, both storage types
    tuned_box = mesh_gen.box_mesh(4, 4, 3, 1)
    tuned_meshes = meshes_of(tuned_box)
    for n1_case in ops.KERNEL_N1:
        for e in TUNED_ELEMS:
            check_order(basis(n1_case - 1), e, tuned_meshes, 100 * n1_case + e,
                        entry)
    tuned_cases = {dt: len(cases[dt]) for dt in DTYPES}
    # the slab body at every N1 from 17 to 24, through its twin: E = 1, 3
    # and 216 (the GENERIC_BOX's elements), c = 1 and 4, both storage types
    slab_meshes = meshes_of(mesh_gen.box_mesh(*GENERIC_BOX, 1))
    for n1_case in SLAB_N1:
        for e in SLAB_ELEMS:
            check_order(basis(n1_case - 1), e, slab_meshes, 100 * n1_case + e,
                        slab_name, twin="slab")
    slab_cases = {dt: len(cases[dt]) - tuned_cases[dt] for dt in DTYPES}
    # the generic body, phase 6's yardstick for the slab body, at the N1
    # of GENERIC_ORDERS through its twin: E = GENERIC_CHECK_ELEMS, c = 1
    # and 4, both storage types
    generic_n1 = [order + 1 for order in GENERIC_ORDERS]
    for n1_case in generic_n1:
        check_order(basis(n1_case - 1), GENERIC_CHECK_ELEMS, slab_meshes,
                    200 * n1_case, generic_name, twin="any")
    generic_cases = {dt: len(cases[dt]) - tuned_cases[dt] - slab_cases[dt]
                     for dt in DTYPES}
    e_odd = 37
    # the main path of orders 16 to 23: the GENERIC_BOX at GENERIC_MAIN_ORDER
    b_gen = basis(GENERIC_MAIN_ORDER)
    gen_box = mesh_gen.box_mesh(*GENERIC_BOX, GENERIC_MAIN_ORDER)
    gen_meshes = meshes_of(gen_box)
    for dt in DTYPES:
        for n1_case in ops.ROWWISE_N1:
            b = basis(n1_case - 1)
            box = mesh_gen.box_mesh(4, 4, 3, n1_case - 1)
            node = (e_odd,) + (n1_case,) * 3
            for variant in VARIANTS:
                verts = torch.as_tensor(mesh_for(variant, box).verts[:e_odd],
                                        dtype=torch.float32, device=dev)
                for helm in EQUATIONS[variant]:
                    for nrhs, d in ((1, 1), (1, 3), (2, 3)):
                        shape = (e_odd, nrhs, d) + (n1_case,) * 3
                        x = torch.as_tensor(rng.standard_normal(shape),
                                            dtype=torch_dtype[dt],
                                            device=dev)
                        x = x[:, 0, 0] if d == 1 else (x[:, 0] if nrhs == 1
                                                       else x)
                        lam0 = torch.as_tensor(1 + 0.3 * rng.random(node),
                                               dtype=torch.float32,
                                               device=dev)
                        lam1 = torch.as_tensor(0.5 + 0.2 * rng.random(node),
                                               dtype=torch.float32,
                                               device=dev) if helm else None
                        geom, kw = operands(variant, verts, b, helm, lam0,
                                            lam1, dt=dt)
                        label = (f"{entry(variant, dt)} N1={n1_case} "
                                 f"E={e_odd} "
                                 f"{'helmholtz' if helm else 'poisson'} "
                                 f"nrhs={nrhs} d={d}")
                        check(variant, b, x.contiguous(), geom, label, dt=dt,
                              helmholtz=helm, **kw)
        for variant in VARIANTS:
            helm = MAIN_HELMHOLTZ[variant]
            verts = torch.as_tensor(cfg_mesh_for(variant).verts,
                                    dtype=torch.float32, device=dev)
            geom, kw = main_operands(variant, verts, helm, dt=dt)
            x = torch.as_tensor(rng.standard_normal((e_main,) + (n1,) * 3),
                                dtype=torch_dtype[dt], device=dev)
            name = entry(variant, dt)
            main_abs[name] = check(
                variant, b_cfg, x, geom, f"{name} main path E={e_main} "
                f"N1={n1} {'helmholtz' if helm else 'poisson'} c=1",
                dt=dt, helmholtz=helm, **kw)
            del geom, kw, x, verts
    check_main_call(b_gen, gen_meshes,
                    lambda v, dt: body_name(v, dt, b_gen.n1))
    for name, (off, total) in small_ulps.items():
        require(off <= ULP_RATE_BOUND * total,
                f"{name}: {off} of the {total} outputs of its small bf16 "
                f"calls off the correctly rounded value (bound "
                f"{ULP_RATE_BOUND})")
    for dt in DTYPES:
        here = [name(v, dt) for name in (entry, slab_name, generic_name)
                for v in VARIANTS]
        line = {"phase": "kernels" if dt == "f32" else "kernels_bf16",
                "cases": len(cases[dt]), "tolerance": rtol[dt],
                "tuned_n1": [ops.KERNEL_N1[0], ops.KERNEL_N1[-1]],
                "tuned_cases": tuned_cases[dt],
                "tuned_elements": TUNED_ELEMS,
                "slab_n1": SLAB_N1, "slab_elements": SLAB_ELEMS,
                "slab_cases": slab_cases[dt],
                "generic_n1": generic_n1,
                "generic_elements": GENERIC_CHECK_ELEMS,
                "generic_cases": generic_cases[dt],
                "worst_rel_err": {k: worst[k] for k in here},
                "main_path_abs_err": {k: main_abs[k] for k in here
                                      if k in main_abs}}
        if dt == "bf16":
            line["ulps_from_correctly_rounded"] = {
                "counts": "outputs 0, 1 and more ulps apart",
                **{k: ulps[k] for k in here}}
            line["ulp_rate_bound"] = ULP_RATE_BOUND
            line["small_calls_pooled"] = {
                "note": "calls of fewer than 1 / ulp_rate_bound outputs: "
                        "outputs off, outputs",
                **dict(small_ulps)}
        emit(line)

    # 4. converging solve at 8x8x8 ----------------------------------------
    def counted(prob):
        """The problem with its global operators — `op`, and `op_lo` of a
        bf16_x32 problem — counting their applications (once per replay
        of a captured chunk that holds one, as the launches count)."""
        box = {"op": 0, "op_lo": 0}

        def counting(name, fn):
            def op(x):
                graphs.count(box, name)
                return fn(x)
            return op
        prob = prob._replace(op=counting("op", prob.op))
        if prob.op_lo is not None:
            prob = prob._replace(op_lo=counting("op_lo", prob.op_lo))
        return prob, box

    def timed_solves(prob, box, variant, backend, b, tol, max_iter,
                     repeats, capture=None, warmup=True):
        """`repeats` solves of b (captured unless `capture` is False),
        after one warm-up solve when `warmup` and repeats > 1.  Every count
        is set to 0 just before each solve and read just after it: through
        the kernels, one launch of the fp32 entry point per application of
        `op` and one of the bf16 entry point per application of `op_lo`;
        through the reference backend, none.  Returns the last result, the
        wall times, the launch counts and the peak memory allocated."""
        if warmup and repeats > 1:
            nekbone.solve(prob, b, tol=tol, max_iter=max_iter,
                          capture=capture)                        # warm-up
        walls, peak = [], 0
        for _ in range(repeats):
            torch.cuda.synchronize()
            box["op"] = box["op_lo"] = 0
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = nekbone.solve(prob, b, tol=tol, max_iter=max_iter,
                                capture=capture)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peak = max(peak, torch.cuda.max_memory_allocated())
            launches = dict(ops.launch_counts)
            want = dict.fromkeys(launches, 0)
            if backend == "cuda":
                want[entry(variant, "f32")] = box["op"]
                want[entry(variant, "bf16")] = box["op_lo"]
            require(launches == want and box["op"] > 0 and
                    (prob.op_lo is None or box["op_lo"] > 0),
                    f"{variant}/{backend}: launches {launches} for the "
                    f"operator applications {box}")
        return res, walls, launches, peak

    def in_turns(prob, box, variant, b, tol, max_iter,
                 repeats=TURN_REPEATS):
        """The captured solve and the explicit eager solve of one problem
        through the kernels, in turns — eager, captured, captured, eager,
        `repeats` timed solves a turn (`timed_solves`) — after one
        warm-up solve of each (the captured one captures the loops).
        Returns per mode the last result, every wall, the launches, the
        applications and the peak memory; and the graph counts: loops
        captured by the first captured solve, captured again by the timed
        ones (0 when the cache works), replays, capture times."""
        cache = prob.graphs
        for capture in (False, True):
            nekbone.solve(prob, b, tol=tol, max_iter=max_iter,
                          capture=capture)
        torch.cuda.synchronize()
        first, replays0 = cache.captures, cache.replays
        out = {mode: {"walls": [], "peak": 0}
               for mode in ("eager", "captured")}
        for capture in (False, True, True, False):
            o = out["captured" if capture else "eager"]
            o["res"], walls, o["launches"], peak = timed_solves(
                prob, box, variant, "cuda", b, tol, max_iter, repeats,
                capture=capture, warmup=False)
            o["walls"] += walls
            o["peak"] = max(o["peak"], peak)
            o["applications"] = dict(box)
        return out, {"captured_by_first_solve": first,
                     "captured_by_repeats": cache.captures - first,
                     "replays": cache.replays - replays0,
                     "capture_ms": [1e3 * t for t in cache.capture_seconds],
                     "memory_reserved": torch.cuda.memory_reserved()}

    def graph_row(what, out, ginfo):
        """The captured against the eager solve of `in_turns`: the same
        statuses and iterations, x bitwise equal, nothing captured again;
        ms per (largest column's) iteration, median and quartiles, of
        both, replays per iteration, peak memory of both."""
        cap, eag = out["captured"]["res"], out["eager"]["res"]
        iters = int(cap.iterations.max())
        rel = float((cap.x - eag.x).abs().max() / eag.x.abs().max())
        bitwise = torch.equal(cap.x, eag.x)
        require(torch.equal(cap.status, eag.status) and
                torch.equal(cap.iterations, eag.iterations),
                f"{what}: captured {cap.status.tolist()} / "
                f"{cap.iterations.tolist()} against eager "
                f"{eag.status.tolist()} / {eag.iterations.tolist()}")
        require(bitwise, f"{what}: captured x differs from eager x, "
                f"max rel {rel:.3e}")
        require(ginfo["captured_by_first_solve"] >= 1 and
                ginfo["captured_by_repeats"] == 0,
                f"{what}: graph counts {ginfo}")
        qc = quartiles(out["captured"]["walls"], iters)
        qe = quartiles(out["eager"]["walls"], iters)
        return {"status": [SolveStatus(int(c)).name
                           for c in cap.status.reshape(-1)],
                "iterations": cap.iterations.reshape(-1).tolist(),
                "x_bitwise_equal": bitwise, "x_max_rel_diff": rel,
                "ms_per_iteration": {"captured": qc[1], "eager": qe[1]},
                "ms_per_iteration_q1_q3": {"captured": [qc[0], qc[2]],
                                           "eager": [qe[0], qe[2]]},
                "speedup_median": qe[1] / qc[1],
                "solves_timed": len(out["captured"]["walls"]),
                "replays_per_iteration": ginfo["replays"] / (
                    len(out["captured"]["walls"]) * max(iters, 1)),
                "max_memory_allocated": {"captured": out["captured"]["peak"],
                                         "eager": out["eager"]["peak"]},
                **ginfo}

    def quartiles(walls, iters):
        """q1, median, q3 of the ms per iteration over the timed solves."""
        ms = sorted(w * 1e3 / max(iters, 1) for w in walls)
        return statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3

    def manufactured(mesh, variant, backend, helm=False):
        """One problem (counting its operator's applications), its
        manufactured solution and right-hand side."""
        prob = nekbone.setup_problem(mesh, variant=variant, helmholtz=helm,
                                     backend=backend)
        require(prob.backend == backend, f"backend {prob.backend} != "
                f"{backend}")
        prob, box = counted(prob)
        x_true = nekbone.random_solution(prob, seed=0)
        return prob, box, x_true, nekbone.rhs_from_solution(prob, x_true)

    def solve_record(prob, variant, backend, helm, x_true, res, walls,
                     launches, applications, peak):
        iters = int(res.iterations)
        q = quartiles(walls, iters)
        out = {"variant": variant, "backend": backend,
               "equation": "helmholtz" if helm else "poisson",
               "status": SolveStatus(int(res.status)).name,
               "iterations": iters, "residual": float(res.residual),
               "error": nekbone.manufactured_error(prob, res.x, x_true),
               "applications": applications["op"],
               "launches": launches[entry(variant, "f32")],
               "solves_timed": len(walls), "ms_per_iteration": q[1],
               "ms_per_iteration_q1": q[0], "ms_per_iteration_q3": q[2],
               "max_memory_allocated": peak}
        require(bool(torch.isfinite(res.x).all()), f"{out}: non-finite x")
        return out

    def run_solve(mesh, variant, backend, tol, max_iter, helm=False):
        """The manufactured-solution solve of one problem, captured (see
        `timed_solves`)."""
        prob, box, x_true, b = manufactured(mesh, variant, backend, helm)
        res, walls, launches, peak = timed_solves(prob, box, variant,
                                                  backend, b, tol, max_iter,
                                                  1)
        return solve_record(prob, variant, backend, helm, x_true, res, walls,
                            launches, box, peak)

    conv_box = mesh_gen.box_mesh(8, 8, 8, CONFIG.order)
    conv_box5 = mesh_gen.box_mesh(8, 8, 8, LOW_ORDER)
    conv_meshes = {"trilinear": mesh_for("trilinear", conv_box),
                   "affine": mesh_for("parallelepiped", conv_box),
                   "trilinear5": mesh_for("trilinear", conv_box5),
                   "affine5": mesh_for("parallelepiped", conv_box5)}
    # (name, variant, mesh, helmholtz); the pairs below reach one operator
    # through two variants
    conv_runs = [("precomputed", "precomputed", "trilinear", False),
                 ("trilinear", "trilinear", "trilinear", False),
                 ("partial", "partial", "trilinear", False),
                 ("trilinear/helmholtz", "trilinear", "trilinear", True),
                 ("merged", "merged", "trilinear", True),
                 ("precomputed/affine", "precomputed", "affine", False),
                 ("parallelepiped", "parallelepiped", "affine", False)]
    # each variant at order 5 (N1 = 6), the README's --order 5 path, through
    # the tuned bodies
    conv_runs += [(f"{v}/order{LOW_ORDER}", v,
                   f"{'affine' if v == 'parallelepiped' else 'trilinear'}"
                   f"{LOW_ORDER}", MAIN_HELMHOLTZ[v])
                  for v in VARIANTS]
    same_operator = [("merged", "trilinear/helmholtz"),
                     ("partial", "trilinear"),
                     ("parallelepiped", "precomputed/affine")]
    conv = {}
    for name, variant, mesh_name, helm in conv_runs:
        k, r = (run_solve(conv_meshes[mesh_name], variant, backend, 1e-8,
                          CONVERGE_MAX_ITER[helm], helm=helm)
                for backend in ("cuda", "reference"))
        for s in (k, r):
            s["mesh"] = mesh_name
            require(s["status"] == "CONVERGED", f"8^3 solve: {s}")
            require(s["error"] <= CONVERGE_ERROR[helm],
                    f"8^3 solve error: {s}")
        require(abs(k["iterations"] - r["iterations"]) <= 1,
                f"8^3 iterations differ: {k} vs {r}")
        conv[name] = {"kernel": k, "reference": r}
    for a, b_ in same_operator:
        for backend in ("kernel", "reference"):
            ia, ib = conv[a][backend]["iterations"], \
                conv[b_][backend]["iterations"]
            require(abs(ia - ib) <= 1, f"8^3 {backend} solves of one "
                    f"operator: {a} took {ia} iterations, {b_} {ib}")
    emit({"phase": "converge", "mesh": "8x8x8",
          "order": {"config": CONFIG.order, "low": LOW_ORDER},
          "dofs": {"config": conv_box.n_global,
                   "low": conv_box5.n_global},
          "body": {o: {v: ops.body_of(v, o + 1) for v in VARIANTS}
                   for o in (CONFIG.order, LOW_ORDER)},
          "max_iter": CONVERGE_MAX_ITER,
          "error_bound": CONVERGE_ERROR, "same_operator": same_operator,
          "solves": conv})

    # 4b. the bf16_x32 refined solve at 8x8x8 ------------------------------
    def refined_problem(mesh, variant, backend, nrhs=1, helm=False,
                        dirichlet=True, precision="bf16_x32", plain=None):
        """The Dirichlet (or unmasked) problem of `nekbone.random_rhs`,
        counting its operators' applications; `precision=None` is the
        plain fp32 problem, and `plain` builds the reference backend on
        that stand-in for the plain version (see `rounding_witness`).
        Returns the problem, its counts, b and the fp32 operator."""
        with plain_version(plain):
            prob = nekbone.setup_problem(mesh, variant=variant,
                                         helmholtz=helm, dirichlet=dirichlet,
                                         backend=backend,
                                         precision=precision, nrhs=nrhs)
        require(prob.backend == backend, f"backend {prob.backend} != "
                f"{backend}")
        op = prob.op
        prob, box = counted(prob)
        return prob, box, nekbone.random_rhs(prob, nrhs=nrhs), op

    def refined_record(variant, backend, tol, nrhs, helm, dirichlet,
                       precision, b, op, res, walls, launches, applications,
                       peak):
        require(bool(torch.isfinite(res.x).all()),
                f"{variant}/{backend}: non-finite x")
        iters = res.iterations.reshape(-1).tolist()
        q = quartiles(walls, max(iters))
        return {"variant": variant, "backend": backend,
                "precision": precision or "fp32", "nrhs": nrhs, "tol": tol,
                "equation": "helmholtz" if helm else "poisson",
                "dirichlet": dirichlet,
                "status": [SolveStatus(int(c)).name
                           for c in res.status.reshape(-1)],
                "iterations": iters,
                "true_residual": torch.linalg.norm(
                    b - op(res.x), dim=0).reshape(-1).tolist(),
                "applications": dict(applications),
                "launches": {k: v for k, v in launches.items() if v},
                "solves_timed": len(walls), "ms_per_iteration": q[1],
                "ms_per_iteration_q1": q[0], "ms_per_iteration_q3": q[2],
                "wall_s": statistics.median(walls),
                "max_memory_allocated": peak}

    def run_refined(mesh, variant, backend, tol, nrhs=1, helm=False,
                    dirichlet=True, repeats=1, precision="bf16_x32",
                    plain=None, capture=None):
        """The refined (or fp32) solve of `refined_problem`, `repeats`
        times (see `timed_solves`), with the fp32 true residual of each
        column."""
        prob, box, b, op = refined_problem(mesh, variant, backend, nrhs,
                                           helm, dirichlet, precision, plain)
        res, walls, launches, peak = timed_solves(
            prob, box, variant, backend, b, tol, REFINED_MAX_ITER, repeats,
            capture=capture)
        return refined_record(variant, backend, tol, nrhs, helm, dirichlet,
                              precision, b, op, res, walls, launches, box,
                              peak)

    def ensemble(mesh, variant, tol, **kw):
        """The plain version's roundings of one refined solve: the
        reference backend first, then `witnesses()`.  Run eagerly: the
        re-rounding witnesses draw from their own generators, which a
        captured chunk would not advance."""
        members = []
        for name, fn in [("reference", None)] + witnesses():
            run = run_refined(mesh, variant, "reference", tol, plain=fn,
                              capture=False, **kw)
            members.append({"member": name, **{
                key: run[key] for key in ("status", "iterations",
                                          "true_residual")}})
        return members

    def judge(what, k, members, tol):
        """The kernels' solve against the plain version's ensemble: within
        `ensemble_verdict` (the gather sums in a fixed order, so the solve
        users run is the one that repeats exactly), and every fp32 true
        residual within 1.5 tol wherever a column CONVERGED.  Returns the
        per-column robustness of the ensemble."""
        problems, robust = ensemble_verdict(k, members)
        require(not problems, f"{what}: the kernels' solve against the "
                f"plain version's roundings: {problems}: {k} vs "
                f"{members}")
        for run in [k] + members:
            for st, true in zip(run["status"], run["true_residual"]):
                require(st != "CONVERGED" or true <= 1.5 * tol,
                        f"{what}: true residual {true} > 1.5 tol: {run}")
        return robust

    def op_lo_discrepancy(mesh, variant="trilinear"):
        """||op_lo(x) - op(x)|| / ||op(x)|| of the bf16_x32 problem through
        the kernels, x standard normal (numpy seed 0) rounded to bf16 and
        zero on the mask: how far the bf16 operator lies from the fp32
        one, which bounds what a refinement sweep can gain."""
        prob = nekbone.setup_problem(mesh, variant=variant, backend="cuda",
                                     precision="bf16_x32")
        x = np.random.default_rng(0).standard_normal(mesh.n_global)
        x[mesh.boundary] = 0.0
        xb = torch.as_tensor(x, dtype=torch.bfloat16, device=dev)
        y = prob.op(xb.float())
        return float(torch.linalg.norm(prob.op_lo(xb).float() - y)
                     / torch.linalg.norm(y))

    def op_lo_ulps(mesh, variant, helm, dirichlet):
        """The bf16 global operator through the kernels, through the plain
        version and correctly rounded, on x standard normal (numpy seed 0)
        rounded to bf16 and zero on the boundary: counts of outputs 0, 1
        and more ulps apart, pairwise."""
        x = np.random.default_rng(0).standard_normal(mesh.n_global)
        x[mesh.boundary] = 0.0
        xb = torch.as_tensor(x, dtype=torch.bfloat16, device=dev)
        ys = {}
        for who, backend, fn in (("kernel", "cuda", None),
                                 ("plain", "reference", None),
                                 ("exact", "reference",
                                  rounding_witness(torch.float64))):
            with plain_version(fn):
                prob = nekbone.setup_problem(
                    mesh, variant=variant, helmholtz=helm,
                    dirichlet=dirichlet, backend=backend,
                    precision="bf16_x32")
            ys[who] = prob.op_lo(xb)
        out = {}
        for a, b_ in (("kernel", "exact"), ("plain", "exact"),
                      ("kernel", "plain")):
            d = ulp_distance(ys[a], ys[b_])
            out[f"{a}_vs_{b_}"] = [int((d == 0).sum()), int((d == 1).sum()),
                                   int((d > 1).sum())]
        return out

    refined8 = {}
    ulps_8 = {}
    for name, variant, mesh_name, helm, dirichlet, nrhs, tol in \
            REFINE_CASES_8:
        mesh = conv_meshes[mesh_name]
        kw = {"nrhs": nrhs, "helm": helm, "dirichlet": dirichlet}
        k = run_refined(mesh, variant, "cuda", tol, **kw)  # as users run it
        members = ensemble(mesh, variant, tol, **kw)
        key = f"{variant}/{mesh_name}/" \
              f"{'helmholtz' if helm else 'poisson'}/" \
              f"{'dirichlet' if dirichlet else 'unmasked'}"
        if key not in ulps_8:
            ulps_8[key] = op_lo_ulps(mesh, variant, helm, dirichlet)
        robust = judge(f"8^3 {name}", k, members, tol)
        refined8[name] = {"kernel": k, "ensemble": members,
                          "robust": robust, "mesh": mesh_name}
    for name, columns in MUST_CONVERGE_8.items():
        case = refined8[name]
        for run in (case["kernel"], case["ensemble"][0]):
            require(all(run["status"][c] == "CONVERGED" for c in columns),
                    f"8^3 bf16_x32 {name} at tol 0.03: {run}")
    for name in ("trilinear/tol1e-4", "trilinear/helmholtz_unmasked"):
        case = refined8[name]
        for run in (case["kernel"], case["ensemble"][0]):
            require(run["status"] == ["STAGNATED"],
                    f"8^3 bf16_x32 {name}: {run}")
    # the bf16 kernels of the other variants run on these 8^3 solves
    bf16_launches = {v: refined8[v]["kernel"]["launches"][entry(v, "bf16")]
                     for v in VARIANTS if v != "trilinear"}
    # each variant's bf16_x32 solve at order 5 (the bf16 tuned bodies),
    # held to the plain version's ensemble as above
    refined5 = {}
    for variant in VARIANTS:
        mesh_name = ("affine" if variant == "parallelepiped"
                     else "trilinear") + str(LOW_ORDER)
        mesh = conv_meshes[mesh_name]
        kw = {"helm": MAIN_HELMHOLTZ[variant]}
        k = run_refined(mesh, variant, "cuda", 0.03, **kw)
        members = ensemble(mesh, variant, 0.03, **kw)
        robust = judge(f"8^3 order {LOW_ORDER} {variant}", k,
                       members, 0.03)
        refined5[variant] = {"kernel": k, "ensemble": members,
                             "robust": robust, "mesh": mesh_name}
    emit({"phase": "refine_generic", "mesh": "8x8x8",
          "order": LOW_ORDER, "dofs": conv_box5.n_global,
          "body": {v: ops.body_of(v, LOW_ORDER + 1) for v in VARIANTS},
          "tol": 0.03, "solves": refined5})
    emit({"phase": "refine_8", "mesh": "8x8x8", "order": CONFIG.order,
          "dofs": conv_box.n_global, "max_iter": REFINED_MAX_ITER,
          "rhs": "nekbone.random_rhs: standard normal, numpy seed 0, zero "
                 "on the boundary, norm 30",
          "witness_flip_rate": WITNESS_FLIP_RATE,
          "op_lo_rel_diff": op_lo_discrepancy(conv_meshes["trilinear"]),
          "op_lo_ulps": {"counts": "outputs 0, 1 and more ulps apart",
                         **ulps_8},
          "solves": refined8})

    # 5. the config, through the kernels (the main path) -------------------
    # Every variant's main path: the captured kernel-backend solve in turns
    # with the same solve run eagerly (`in_turns`, median and quartiles of
    # each; the captured one is the main path); the slow reference-backend
    # solve runs once, for its status, iterations and residual.  K2 runs
    # twice: Poisson (the config's own equation) and Helmholtz, K4's
    # yardstick.
    cfg_runs = [(v, MAIN_HELMHOLTZ[v]) for v in VARIANTS] + \
        [("trilinear", True)]
    config, graph_rows = {}, {}
    for variant, helm in cfg_runs:
        mesh = cfg_mesh_for(variant)
        prob, box, x_true, b = manufactured(mesh, variant, "cuda", helm)
        out, ginfo = in_turns(prob, box, variant, b, CONFIG.tol,
                              CONFIG.max_iter)
        cap = out["captured"]
        k = solve_record(prob, variant, "cuda", helm, x_true, cap["res"],
                         cap["walls"], cap["launches"], cap["applications"],
                         cap["peak"])
        key = f"{variant}/{k['equation']}"
        graph_rows[f"16^3 fp32 {key}"] = graph_row(f"16^3 {key}", out,
                                                   ginfo)
        del prob, box, b, out
        r = run_solve(mesh, variant, "reference", CONFIG.tol,
                      CONFIG.max_iter, helm=helm)
        require(k["status"] == r["status"] and
                abs(k["iterations"] - r["iterations"]) <= 1,
                f"16^3 solves differ: {k} vs {r}")
        rdiff = abs(k["residual"] - r["residual"]) / r["residual"]
        if k["status"] == "MAXITER":
            require(rdiff <= 0.01, f"16^3 residual differs by {rdiff:.3%}: "
                    f"{k} vs {r}")
        flops = nekbone.flop_count(mesh, 1, helm, 1)
        k["GFLOPS"] = flops / k["ms_per_iteration"] / 1e6
        k["GDOFS"] = mesh.n_global / k["ms_per_iteration"] / 1e6
        config[key] = {
            "kernel": k, "reference": r, "residual_rel_diff": rdiff,
            "mesh": "affine" if variant == "parallelepiped" else "trilinear"}
    emit({"phase": "config", "mesh": "x".join(map(str, CONFIG.elements)),
          "order": CONFIG.order, "elements": e_main,
          "dofs": cfg_box.n_global, "solves": config})

    # 5b. the bf16 slice's main path: bf16_x32 on the config ---------------
    # The config's trilinear Dirichlet Poisson, b as in 4b, at nrhs 1 and
    # 4: the single-sweep tolerance 3.0 (0.1 |b|), 0.03 and 1e-4.  The
    # bf16_x32 and fp32 kernel solves are timed REFINED_REPEATS times, at
    # tol 3.0 the bf16_x32 one in turns with its eager twin (`in_turns`);
    # the plain version's ensemble runs once.
    cfg_tri = cfg_mesh_for("trilinear")
    config_bf16 = {}
    for nrhs, tol in CONFIG_BF16_RUNS:
        if tol == 3.0:
            prob, box, b, op = refined_problem(cfg_tri, "trilinear", "cuda",
                                               nrhs)
            out, ginfo = in_turns(prob, box, "trilinear", b, tol,
                                  REFINED_MAX_ITER)
            cap = out["captured"]
            k = refined_record("trilinear", "cuda", tol, nrhs, False, True,
                               "bf16_x32", b, op, cap["res"], cap["walls"],
                               cap["launches"], cap["applications"],
                               cap["peak"])
            graph_rows[f"16^3 bf16_x32 nrhs={nrhs} tol=3.0"] = graph_row(
                f"16^3 bf16_x32 nrhs={nrhs}", out, ginfo)
            del prob, box, b, out
        else:
            k = run_refined(cfg_tri, "trilinear", "cuda", tol, nrhs,
                            repeats=REFINED_REPEATS)
        f = run_refined(cfg_tri, "trilinear", "cuda", tol, nrhs,
                        repeats=REFINED_REPEATS, precision=None)
        members = ensemble(cfg_tri, "trilinear", tol, nrhs=nrhs)
        robust = judge(f"16^3 nrhs={nrhs} tol={tol}", k, members, tol)
        if tol == 3.0:
            require(set(k["status"]) == {"CONVERGED"} and
                    max(k["true_residual"]) <= 4.5,
                    f"16^3 bf16_x32 at tol 3.0: {k}")
        config_bf16[f"nrhs={nrhs} tol={tol}"] = {
            "kernel": k, "fp32": f, "ensemble": members, "robust": robust}
    bf16_launches["trilinear"] = \
        config_bf16["nrhs=1 tol=3.0"]["kernel"]["launches"][
            entry("trilinear", "bf16")]
    emit({"phase": "config_bf16",
          "mesh": "x".join(map(str, CONFIG.elements)),
          "order": CONFIG.order, "dofs": cfg_box.n_global,
          "max_iter": REFINED_MAX_ITER,
          "op_lo_rel_diff": op_lo_discrepancy(cfg_tri),
          "ms_per_iteration": "wall of one solve over its largest column "
                              "iteration count (inner iterations for "
                              "bf16_x32)",
          "solves": config_bf16})

    # 5c. graph: the captured solves against their eager twins -----------
    emit({"phase": "graph", "card": card,
          "turns": f"eager, captured, captured, eager; {TURN_REPEATS} timed "
                   f"solves a turn after one warm-up solve of each mode",
          "check_every": "one graph replay a chunk of 8 loop bodies",
          "solves": graph_rows})

    # 5d. reproducible: one outcome in REPRODUCIBLE_RUNS refined solves ----
    # The 8^3 bf16_x32 parallelepiped solve sits at the edge of
    # refinement's envelope, where the order of the gather's sums decided
    # the outcome while they were atomic.  Runs on two problems (each
    # captures its own graphs) and must agree bitwise.
    runs = []
    for trial in range(REPRODUCIBLE_RUNS):
        if trial % (REPRODUCIBLE_RUNS // 2) == 0:
            prob = nekbone.setup_problem(conv_meshes["affine"],
                                         variant="parallelepiped",
                                         backend="cuda", precision="bf16_x32")
            b = nekbone.random_rhs(prob)
        runs.append(nekbone.solve(prob, b, tol=0.03,
                                  max_iter=REFINED_MAX_ITER))
    outcomes = {(SolveStatus(int(r.status)).name, int(r.iterations))
                for r in runs}
    same_x = all(torch.equal(r.x, runs[0].x) for r in runs)
    emit({"phase": "reproducible", "mesh": "8x8x8 affine",
          "solve": "bf16_x32 parallelepiped, tol 0.03, random_rhs",
          "runs": REPRODUCIBLE_RUNS, "outcomes": sorted(outcomes),
          "x_bitwise_equal": same_x, "captures": prob.graphs.captures})
    require(len(outcomes) == 1 and same_x,
            f"8^3 bf16_x32 parallelepiped: {sorted(outcomes)} over "
            f"{REPRODUCIBLE_RUNS} runs, x bitwise equal: {same_x}")
    del runs, prob, b

    # 5e. resilience: faults inside captured chunks, the retry ladder -----
    res_mesh = conv_meshes["trilinear"]
    prob, _, _, b = manufactured(res_mesh, "trilinear", "cuda")
    tol_r, mi_r = 1e-6, 1000
    clean = nekbone.solve(prob, b, tol=tol_r, max_iter=mi_r)
    nan = nekbone.solve(prob, b, tol=tol_r, max_iter=mi_r,
                        fault=FaultSpec(mode="nan", iteration=3))
    flip = nekbone.solve(prob, b, tol=tol_r, max_iter=mi_r,
                         fault=FaultSpec(mode="bitflip", iteration=2),
                         stagnation_window=15)
    reports = {
        "clean": solve_resilient(prob, b, tol=tol_r, max_iter=mi_r),
        "transient": solve_resilient(
            prob, b, tol=tol_r, max_iter=mi_r,
            fault=FaultSpec(mode="nan", iteration=5), persistent=False),
        # the default policy has no backend rung: the kernels' failure
        # stands; asked for, the rung answers with the plain version
        "persistent_default": solve_resilient(
            prob, b, tol=tol_r, max_iter=mi_r,
            fault=FaultSpec(mode="nan", iteration=3), persistent=True),
        "persistent": solve_resilient(
            prob, b, RetryPolicy(backend_fallback=True), tol=tol_r,
            max_iter=mi_r, fault=FaultSpec(mode="nan", iteration=3),
            persistent=True)}
    block = nekbone.setup_problem(res_mesh, variant="trilinear",
                                  backend="cuda", nrhs=4)
    bs = nekbone.rhs_from_solution(block, nekbone.random_solution(
        block, seed=1, nrhs=4))
    hit = nekbone.solve(block, bs, tol=tol_r, max_iter=mi_r,
                        fault=FaultSpec(mode="nan", iteration=2, column=1))
    unhit = nekbone.solve(block, bs, tol=tol_r, max_iter=mi_r)
    resilience = {
        "clean": [SolveStatus(int(clean.status)).name,
                  int(clean.iterations)],
        "nan@3": [SolveStatus(int(nan.status)).name, int(nan.iterations)],
        "bitflip@2": [SolveStatus(int(flip.status)).name,
                      int(flip.iterations)],
        "batched_nan@2_column1": {
            "status": [SolveStatus(int(c)).name for c in hit.status],
            "iterations": hit.iterations.tolist(),
            "clean_iterations": unhit.iterations.tolist()},
        "captures": prob.graphs.captures + block.graphs.captures,
        "replays": prob.graphs.replays + block.graphs.replays}
    for name, rep in reports.items():
        resilience[name] = {
            "converged": rep.converged, "rung": list(rep.rung),
            "attempts": [[a.rung, [SolveStatus(int(c)).name
                                   for c in a.status],
                          a.iterations.tolist(), a.true_residual.tolist()]
                         for a in rep.attempts]}
    emit({"phase": "resilience", "mesh": "8x8x8", "order": CONFIG.order,
          "tol": tol_r, "solves": resilience})
    require(SolveStatus(int(nan.status)) is SolveStatus.DIVERGED and
            int(nan.iterations) == 3 and bool(torch.isfinite(nan.x).all()),
            f"nan@3: {resilience['nan@3']}")
    require(bool(is_failure(flip.status)), f"bitflip: {resilience}")
    require(reports["clean"].converged and
            [a.rung for a in reports["clean"].attempts] == ["initial"],
            f"clean resilient solve: {resilience['clean']}")
    require(reports["transient"].converged and
            reports["transient"].rung == ("restart",),
            f"transient fault: {resilience['transient']}")
    require(not reports["persistent_default"].converged and
            [a.rung for a in reports["persistent_default"].attempts] ==
            ["initial", "restart"],
            f"persistent fault, default policy: "
            f"{resilience['persistent_default']}")
    require(reports["persistent"].converged and
            reports["persistent"].rung == ("backend:reference",) and
            [a.rung for a in reports["persistent"].attempts] ==
            ["initial", "restart", "backend:reference"],
            f"persistent fault: {resilience['persistent']}")
    require(hit.status.tolist() == [0, 2, 0, 0] and
            int(hit.iterations[1]) == 2 and
            hit.iterations[[0, 2, 3]].tolist() ==
            unhit.iterations[[0, 2, 3]].tolist(),
            f"batched fault: {resilience['batched_nan@2_column1']}")
    del prob, b, block, bs
    torch.cuda.empty_cache()

    # 5f, 5g. sharded: the element-sharded solve on gloo ranks on this card
    # Every kernel at the element counts a shard gives it (EP = E / S on
    # these boxes), against its plain version; then for each (S, grid) of
    # SHARDED one spawn of S ranks, all on this card, that repeats phase 4's
    # six fp32 solves at 8^3 (status of the single-device kernel solve,
    # iterations +-1, error < 1e-3), at S = 2 also the bf16_x32 trilinear
    # solve and a lost exchange under the retry ladder, and the config's
    # trilinear solve (CONFIG.max_iter iterations) against the
    # single-device eager one; then the same spawn's ranks through the
    # neighbour exchange (5g).  gloo on one card: these times are no
    # multi-card number.
    shard_e = sorted({len(conv_box.verts) // s for s, _ in SHARDED}
                     | {e_main // s for s, _ in SHARDED})
    for e_shard in shard_e:
        xs = torch.as_tensor(rng.standard_normal((e_shard,) + (n1,) * 3),
                             dtype=torch.float32, device=dev)
        for variant in VARIANTS:
            helm = MAIN_HELMHOLTZ[variant]
            verts = torch.as_tensor(cfg_mesh_for(variant).verts[:e_shard],
                                    dtype=torch.float32, device=dev)
            for dt in DTYPES:
                geom, kw = main_operands(variant, verts, helm, dt=dt)
                check(variant, b_cfg, xs.to(torch_dtype[dt]), geom,
                      f"sharded E={e_shard} {variant} {dt}", dt=dt,
                      helmholtz=helm, **kw)
        del xs
    # The neighbour exchange's two launches a rank: interface slots [0,
    # cut) and interior slots [cut, EP), their operands sliced from the
    # shard's at element cut (the shard operator's own views), every fp32
    # entry point and trilinear bf16 against the plain version; and the
    # interior launch's device time at 16^3, the window the exchange
    # overlaps.
    sub_batches, overlap_window = {}, {}
    for shards, grid in SHARDED:
        key = f"S={shards} " + ("slab" if grid is None
                                else "x".join(map(str, grid)))
        for n_mesh, box in ((8, conv_box), (nx, cfg_box)):
            part = mesh_gen.partition_elements(box, shards, grid=grid)
            split, cut = nekbone._neighbour_launch_plan(part)
            ep = part.e_per_shard
            require(split, f"{key} {n_mesh}^3: the neighbour exchange "
                    f"runs one unsplit launch (e_iface {part.e_iface} of "
                    f"{ep})")
            sub_batches[f"{key} {n_mesh}^3"] = [cut, ep - cut]
            xs = torch.as_tensor(rng.standard_normal((ep,) + (n1,) * 3),
                                 dtype=torch.float32, device=dev)
            for variant in VARIANTS:
                helm = MAIN_HELMHOLTZ[variant]
                verts = torch.as_tensor(cfg_mesh_for(variant).verts[:ep],
                                        dtype=torch.float32, device=dev)
                for dt in DTYPES:
                    if dt == "bf16" and variant != "trilinear":
                        continue
                    geom, kw = main_operands(variant, verts, helm, dt=dt)
                    for lo, hi in ((0, cut), (cut, ep)):
                        sub = {k: v[lo:hi] for k, v in kw.items()
                               if isinstance(v, torch.Tensor)}
                        check(variant, b_cfg,
                              xs[lo:hi].to(torch_dtype[dt]), geom[lo:hi],
                              f"sharded {key} {n_mesh}^3 slots [{lo}, {hi}) "
                              f"{variant} {dt}", dt=dt, helmholtz=helm,
                              **{**kw, **sub})
            if n_mesh == nx:
                # device time of each fp32 entry point's two launches at
                # 16^3 beside its bound; trilinear's interior launch is
                # the window the exchange overlaps on the config's path
                overlap_window[key] = {}
                for variant in VARIANTS:
                    helm = MAIN_HELMHOLTZ[variant]
                    verts = torch.as_tensor(
                        cfg_mesh_for(variant).verts[:ep],
                        dtype=torch.float32, device=dev)
                    geom, kw = main_operands(variant, verts, helm)
                    row = {}
                    for side, lo, hi in (("interface", 0, cut),
                                         ("interior", cut, ep)):
                        x_sub = xs[lo:hi]
                        sub = {**kw, **{k: v[lo:hi] for k, v in kw.items()}}
                        bound_ms, bound_by, _, _ = axhelm_bound(
                            variant, hi - lo, n1, helm)
                        row[side] = {
                            "elements": hi - lo,
                            "ms": graph_ms(lambda: ops.axhelm(
                                x_sub, b_cfg, variant, geom[lo:hi],
                                helmholtz=helm, **sub)),
                            "bound_ms": bound_ms, "bound_by": bound_by}
                    overlap_window[key][variant] = row
            del xs
    sharded_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded.")
    ref_prob = nekbone.setup_problem(cfg_tri, variant="trilinear",
                                     backend="cuda")
    b_cfg_rhs = nekbone.rhs_from_solution(ref_prob, nekbone.random_solution(
        ref_prob, seed=0))
    ref_res = nekbone.solve(ref_prob, b_cfg_rhs, tol=CONFIG.tol,
                            max_iter=CONFIG.max_iter, capture=False)
    ref_path = str(Path(sharded_dir.name) / "config_ref.pt")
    torch.save({"b": b_cfg_rhs.cpu(), "x": ref_res.x.cpu(),
                "residual": float(ref_res.residual)}, ref_path)
    del ref_prob, b_cfg_rhs
    plan = {"device": None, "backend": "cuda", "order": CONFIG.order,
            "n_conv": 8, "max_iter": CONVERGE_MAX_ITER,
            "config": {"path": ref_path, "n": nx, "tol": CONFIG.tol,
                       "max_iter": CONFIG.max_iter}}
    sharded, sharded_launches = {}, dict.fromkeys(ops.launch_counts, 0)
    neighbour, nbr_launches = {}, dict.fromkeys(ops.launch_counts, 0)

    def neighbour_summary(key, per_rank, shards):
        """Hold one spawn's neighbour-exchange runs to the psum run and the
        single-device solves, and summarize them."""
        nbrs = [r["neighbour"] for r in per_rank]
        for name, _, _ in SHARDED_RUNS:
            single = conv[name]["kernel"]
            psum = per_rank[0]["solves"][name]
            rows = [n["solves"][name] for n in nbrs]
            for r in rows:
                require(r["status"] == single["status"] and
                        abs(r["iterations"] - psum["iterations"]) <= 1 and
                        r["error"] < 1e-3,
                        f"sharded {key} neighbour {name}: {r} against the "
                        f"psum run {psum} and one device {single}")
            require(len({(r["status"], r["iterations"], r["x_sha1"])
                         for r in rows}) == 1,
                    f"sharded {key} neighbour {name}: ranks disagree: "
                    f"{rows}")
        require(nbrs[0]["solves"]["trilinear"]["repeat_bitwise"],
                f"sharded {key} neighbour: a repeat solve changed x")
        refined = nbrs[0]["refined"]
        for codec, r in refined.items():
            require(r["status"] == ["CONVERGED"] and
                    r["true_residual"] <= 1.5 * r["tol"],
                    f"sharded {key} neighbour bf16_x32 wire {codec}: {r}")
        require(refined["bf16"]["x_sha1"] == refined["None"]["x_sha1"] and
                refined["bf16"]["iterations"] ==
                refined["None"]["iterations"],
                f"sharded {key} neighbour bf16_x32: the bf16 wire changed "
                f"the solve: {refined}")
        if shards == 2:
            drop = nbrs[0]["drop_exchange"]
            require(drop["converged"] and
                    [a[0] for a in drop["attempts"]] ==
                    ["initial", "restart"],
                    f"sharded {key} neighbour drop_exchange: {drop}")
        for n in nbrs:
            c = n["config"]
            require(c["residual_rel_diff"] <= SHARDED_RESIDUAL_BOUND and
                    c["x_rel_l2"] <= SHARDED_X_BOUND,
                    f"sharded {key} neighbour 16^3: {c} against the single-"
                    f"device eager solve (residual {float(ref_res.residual)})")
            w = n["wire"]
            require(w["operator"]["all_reduce_bytes"] ==
                    [4 * cfg_box.n_global] and
                    all(not v["all_reduce_bytes"] for k, v in w.items()
                        if k.startswith("nrhs")),
                    f"sharded {key} neighbour: an interface all_reduce: "
                    f"{w}")
            for k, v in n["launches"].items():
                nbr_launches[k] += v
                sharded_launches[k] += v
        # every sharer of an interface dof holds the same bits, per wire
        agree, digests = {}, {}
        for codec in ("None", "bf16", "int8"):
            held = {}
            for n in nbrs:
                for gid, bits in zip(n["sharers"]["gids"],
                                     n["sharers"][codec]):
                    held.setdefault(int(gid), set()).add(int(bits))
            agree[codec] = all(len(v) == 1 for v in held.values())
            digests[codec] = hashlib.sha1(json.dumps(sorted(
                (g, v.pop()) for g, v in held.items())).encode()) \
                .hexdigest()[:16]
            require(agree[codec], f"sharded {key} neighbour wire {codec}: "
                    f"sharers of an interface dof hold different bits")
        return {
            "solves_8": {name: {k: nbrs[0]["solves"][name][k] for k in
                                ("status", "iterations", "error")}
                         | {"psum_iterations":
                            per_rank[0]["solves"][name]["iterations"],
                            "ms_per_iteration_by_rank": [
                                n["solves"][name]["ms_per_iteration"]
                                for n in nbrs]}
                         for name, _, _ in SHARDED_RUNS},
            "refined_8": refined,
            "drop_exchange_8": nbrs[0].get("drop_exchange"),
            "config_16": {
                **{k: nbrs[0]["config"][k] for k in (
                    "status", "iterations", "residual", "residual_rel_diff",
                    "x_rel_l2", "elements_per_shard")},
                "ms_per_iteration_by_rank": [n["config"]["ms_per_iteration"]
                                             for n in nbrs],
                "psum_ms_per_iteration_by_rank": [
                    r["config"]["ms_per_iteration"] for r in per_rank],
                "max_memory_allocated_by_rank": [
                    n["config"]["max_memory_allocated"] for n in nbrs]},
            "wire_16_by_rank": [n["wire"] for n in nbrs],
            "staging_16_by_rank": [n["staging_ms"] for n in nbrs],
            "sub_batches_8_16": [sub_batches[f"{key} 8^3"],
                                 sub_batches[f"{key} {nx}^3"]],
            "overlap_window_16": overlap_window[key],
            "sharers_agree": agree, "sharers_digest": digests,
            "launches_all_ranks": {
                k: sum(n["launches"].get(k, 0) for n in nbrs)
                for k in ops.launch_counts
                if any(n["launches"].get(k, 0) for n in nbrs)}}

    for shards, grid in SHARDED:
        key = f"S={shards} " + ("slab" if grid is None
                                else "x".join(map(str, grid)))
        t0 = time.perf_counter()
        per_rank = spawn(sharded_rank, shards, (grid, {
            **plan, "extras": shards == 2}), backend="gloo",
            timeout_s=SHARDED_TIMEOUT_S)
        wall = time.perf_counter() - t0
        first = per_rank[0]
        for name, _, _ in SHARDED_RUNS:
            single = conv[name]["kernel"]
            rows = [r["solves"][name] for r in per_rank]
            for r in rows:
                require(r["status"] == single["status"] and
                        abs(r["iterations"] - single["iterations"]) <= 1 and
                        r["error"] < 1e-3,
                        f"sharded {key} {name}: {r} against the single-"
                        f"device kernel solve {single}")
            require(len({(r["status"], r["iterations"], r["x_sha1"])
                         for r in rows}) == 1,
                    f"sharded {key} {name}: ranks disagree: {rows}")
        require(first["solves"]["trilinear"]["repeat_bitwise"],
                f"sharded {key}: a repeat solve changed x")
        if shards == 2:
            ref8 = first["refined"]
            require(ref8["status"] == ["CONVERGED"] and
                    ref8["true_residual"] <= 1.5 * ref8["tol"],
                    f"sharded {key} bf16_x32: {ref8}")
            drop = first["drop_exchange"]
            require(drop["converged"] and
                    [a[0] for a in drop["attempts"]] ==
                    ["initial", "restart"],
                    f"sharded {key} drop_exchange: {drop}")
        launches = dict.fromkeys(ops.launch_counts, 0)
        for r in per_rank:
            c = r["config"]
            require(c["residual_rel_diff"] <= SHARDED_RESIDUAL_BOUND and
                    c["x_rel_l2"] <= SHARDED_X_BOUND,
                    f"sharded {key} 16^3: {c} against the single-device "
                    f"eager solve (residual {float(ref_res.residual)})")
            for k, v in r["launches"].items():
                launches[k] += v
                sharded_launches[k] += v
        sharded[key] = {
            "wall_s": wall, "partition_8": first["partition"],
            "solves_8": {name: {k: first["solves"][name][k] for k in
                                ("status", "iterations", "error")}
                         | {"single_device": [
                             conv[name]["kernel"]["status"],
                             conv[name]["kernel"]["iterations"]],
                            "ms_per_iteration_by_rank": [
                                r["solves"][name]["ms_per_iteration"]
                                for r in per_rank]}
                         for name, _, _ in SHARDED_RUNS},
            "refined_8": first.get("refined"),
            "drop_exchange_8": first.get("drop_exchange"),
            "config_16": {
                **{k: first["config"][k] for k in (
                    "status", "iterations", "residual", "residual_rel_diff",
                    "x_rel_l2", "elements_per_shard", "interface_dofs",
                    "bytes_per_exchange")},
                "ms_per_iteration_by_rank": [r["config"]["ms_per_iteration"]
                                             for r in per_rank],
                "interface_dofs_by_rank": [
                    r["config"]["interface_dofs_here"] for r in per_rank],
                "max_memory_allocated_by_rank": [
                    r["config"]["max_memory_allocated"] for r in per_rank]},
            "launches_all_ranks": {k: v for k, v in launches.items()
                                   if v}}
        neighbour[key] = neighbour_summary(key, per_rank, shards)
    sharded_dir.cleanup()
    emit({"phase": "sharded", "dist_backend": "gloo", "card": card,
          "ranks_on": "every rank on cuda:0 (one card): gloo all-reduces "
                      "through host memory; no multi-card (NCCL) number",
          "single_device_16": {"residual": float(ref_res.residual),
                               "iterations": int(ref_res.iterations),
                               "mode": "eager"},
          "bounds_16": {"residual_rel_diff": SHARDED_RESIDUAL_BOUND,
                        "x_rel_l2": SHARDED_X_BOUND},
          "runs": sharded})
    emit({"phase": "sharded_neighbour", "dist_backend": "gloo",
          "wire": "gloo, host-staged", "card": card,
          "ranks_on": "gloo on one card: no multi-card number (every rank "
                      "on cuda:0; each round's buffers staged through "
                      "pinned host memory)",
          "timing": "16^3: one timed solve after a 10-iteration warm-up; "
                    "8^3: one solve each; staging: median of 20 "
                    "D2H+event-wait and H2D copies of one exchange's "
                    "sends; overlap window: CUDA graph of 50 interior "
                    "launches",
          "runs": neighbour})
    for v in VARIANTS:
        require(sharded_launches[entry(v, "f32")] > 0,
                f"{entry(v, 'f32')} was not launched on the sharded path")
        require(nbr_launches[entry(v, "f32")] > 0,
                f"{entry(v, 'f32')} was not launched on the neighbour "
                f"exchange's path")
    require(sharded_launches[entry("trilinear", "bf16")] > 0,
            "the bf16 trilinear kernel was not launched on the sharded path")
    require(nbr_launches[entry("trilinear", "bf16")] > 0,
            "the bf16 trilinear kernel was not launched on the neighbour "
            "exchange's path")
    del ref_res
    torch.cuda.empty_cache()

    # 5h, 5i. serving: bucketed block solves behind the solve service -----
    # Every kernel at the bucket widths the service gives it (c = 2, 4, 8;
    # phase 3 checked c in {1, 3, 6}) against its plain version: at 8^3
    # (serve_8) each fp32 entry point and trilinear bf16, at 16^3 (serve)
    # trilinear fp32.  Then the services; the counts are set to 0 just
    # before each stream and read just after it (`launches_serve`).
    serve_launches = dict.fromkeys(ops.launch_counts, 0)

    def served(svc, columns, rate):
        """One stream through `svc` (`drive_stream`), its launches added
        to serve_launches."""
        ops.reset_launch_counts()
        reqs, depths, elapsed = drive_stream(svc, columns, rate)
        for k, v in ops.launch_counts.items():
            serve_launches[k] += v
        return reqs, depths, elapsed, {k: v for k, v in
                                       ops.launch_counts.items() if v}

    def check_columns(variant, mesh, helm, e, dt, cols):
        verts = torch.as_tensor(mesh.verts[:e], dtype=torch.float32,
                                device=dev)
        geom, kw = main_operands(variant, verts, helm, dt=dt)
        for c in cols:
            x = torch.as_tensor(rng.standard_normal((e, c) + (n1,) * 3),
                                dtype=torch_dtype[dt], device=dev)
            check(variant, b_cfg, x, geom, f"serve {entry(variant, dt)} "
                  f"E={e} c={c}", dt=dt, helmholtz=helm, **kw)
        del geom, kw, verts

    e_8 = len(conv_box.verts)
    for variant in VARIANTS:
        mesh = conv_meshes["affine" if variant == "parallelepiped"
                           else "trilinear"]
        check_columns(variant, mesh, MAIN_HELMHOLTZ[variant], e_8, "f32",
                      SERVE_8_CHECK_COLS)
    check_columns("trilinear", conv_meshes["trilinear"], False, e_8, "bf16",
                  (2, 4))
    check_columns("trilinear", cfg_tri, False, e_main, "f32",
                  SERVE_8_CHECK_COLS)

    # serve: the config's trilinear Poisson, fp32, through the kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob = nekbone.setup_problem(cfg_tri, variant="trilinear",
                                 backend="cuda")
    svc = SolveService(prob, max_batch=SERVE_MAX_BATCH, tol=SERVE_TOL,
                       max_iter=SERVE_MAX_ITER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = svc.warmup()
    warm_s = time.perf_counter() - t0
    require(warm == 2 * len(svc.cache.buckets),
            f"serve: warm-up captured {warm}, expected "
            f"{2 * len(svc.cache.buckets)}")
    rhs = nekbone.random_rhs(prob, nrhs=SERVE_REQUESTS)
    columns = [rhs[:, j] for j in range(SERVE_REQUESTS)]
    streams = {}
    for rate in SERVE_RATES:
        reqs, depths, elapsed, launches = served(svc, columns, rate)
        row = stream_row(svc, reqs, depths, elapsed, warm, SERVE_TOL)
        row["launches"] = launches
        stream_gates(f"serve 16^3 rate {rate}", row)
        streams[f"rate{rate:g}"] = row
        del reqs
    # ms per block iteration at each bucket width: block solves through
    # the warmed cache (no audit), SERVE_TIMED each
    per_width = {}
    for width in svc.cache.buckets:
        walls = []
        for _ in range(SERVE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = svc.cache.solve(prob, rhs[:, :width])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        iters = int(res.iterations.max())
        per_width[str(width)] = {
            "iterations": res.iterations.reshape(-1).tolist(),
            "ms_per_block_iteration": 1e3 * statistics.median(walls) / iters,
            "walls_ms": [1e3 * w for w in walls]}
    # the share of the served blocks' wall that their block solves
    # explain: each block (consecutive requests, FIFO) at its bucket's ms
    # per block iteration times its largest iteration count, over the
    # block's wall (solve and audit; its slowest request's solve_s)
    for row in streams.values():
        solve_ms = wall_ms = 0.0
        start = 0
        for depth in row["depth_sequence"]:
            block = row["iterations"][start:start + depth]
            width = str(svc.cache.bucket_for(depth))
            solve_ms += per_width[width]["ms_per_block_iteration"] * \
                max(block)
            wall_ms += max(row["solve_ms"][start:start + depth])
            start += depth
        row["solve_share_of_block_wall"] = solve_ms / wall_ms
    # the width-independent column dot (a pairwise fold of elementwise
    # adds) against one torch reduction over the block, in turns (old,
    # new, new, old), device time of a CUDA graph of 50 calls, in us
    column_dot_us = {}
    for width in svc.cache.buckets:
        u = rhs[:, :width].contiguous()
        v = torch.flip(u, dims=(0,)).contiguous()
        turns = [1e3 * graph_ms(fn) for fn in (
            lambda: (u * v).sum(dim=0), lambda: pcg_mod._column_dot(u, v),
            lambda: pcg_mod._column_dot(u, v),
            lambda: (u * v).sum(dim=0))]
        column_dot_us[str(width)] = {
            "pairwise_fold": (turns[1] + turns[2]) / 2,
            "one_reduction": (turns[0] + turns[3]) / 2, "turns": turns}
        del u, v
    parity = padded_parity("serve 16^3", svc, prob, columns, SERVE_TOL,
                           SERVE_MAX_ITER)
    require(svc.trace_count == warm, f"serve 16^3: captures after warm-up "
            f"{svc.trace_count - warm}")
    emit({"phase": "serve", "card": card,
          "mesh": "x".join(map(str, CONFIG.elements)),
          "order": CONFIG.order, "dofs": cfg_box.n_global,
          "problem": "trilinear Dirichlet Poisson, fp32, Jacobi",
          "buckets": list(svc.cache.buckets), "tol": SERVE_TOL,
          "max_iter": SERVE_MAX_ITER,
          "rhs": "columns of nekbone.random_rhs(nrhs=48): norm 30 each",
          "arrivals": "Poisson(rate) new requests a service step, numpy "
                      "seed 0",
          "warmup_captures": warm, "warmup_s": warm_s,
          "streams": streams, "per_width": per_width,
          "column_dot_us": column_dot_us, "padded_parity": parity,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del svc, prob, rhs, columns
    torch.cuda.empty_cache()

    # serve_8: every kernel's service at 8^3, and the bf16_x32 services
    serve8 = {}
    for name, variant, mesh_name, helm, dirichlet, precision, tol, rung \
            in SERVE_8_STREAMS:
        prob = nekbone.setup_problem(conv_meshes[mesh_name],
                                     variant=variant, helmholtz=helm,
                                     dirichlet=dirichlet, backend="cuda",
                                     precision=precision)
        svc = SolveService(prob, max_batch=SERVE_8_MAX_BATCH, tol=tol,
                           max_iter=SERVE_MAX_ITER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = svc.warmup()
        warm_s = time.perf_counter() - t0
        # the ladder's solvers and verification operators, and for a
        # bf16_x32 problem those of its precision:float32 fallback too
        require(warm == 2 * len(svc.cache.buckets) * (2 if precision
                                                      else 1),
                f"serve_8 {name}: warm-up captured {warm}")
        rhs = nekbone.random_rhs(prob, nrhs=SERVE_8_REQUESTS)
        columns = [rhs[:, j] for j in range(SERVE_8_REQUESTS)]
        reqs, depths, elapsed, launches = served(svc, columns, SERVE_8_RATE)
        row = stream_row(svc, reqs, depths, elapsed, warm, tol)
        row.update(launches=launches, warmup_s=warm_s, mesh=mesh_name,
                   tol=tol, precision=precision or "fp32",
                   equation="helmholtz" if helm else "poisson",
                   dirichlet=dirichlet)
        stream_gates(f"serve_8 {name}", row, rung)
        row["padded_parity"] = padded_parity(
            f"serve_8 {name}", svc, prob, columns, tol, SERVE_MAX_ITER)
        serve8[name] = row
        del svc, prob, rhs, columns, reqs
    emit({"phase": "serve_8", "card": card, "mesh": "8x8x8",
          "order": CONFIG.order, "dofs": conv_box.n_global,
          "max_batch": SERVE_8_MAX_BATCH, "rate": SERVE_8_RATE,
          "kernel_check_columns": SERVE_8_CHECK_COLS,
          "streams": serve8})
    for v in VARIANTS:
        require(serve_launches[entry(v, "f32")] > 0,
                f"{entry(v, 'f32')} was not launched by a served stream")
    require(serve_launches[entry("trilinear", "bf16")] > 0,
            "the bf16 trilinear kernel was not launched by a served stream")
    torch.cuda.empty_cache()

    # 6. kernel times -------------------------------------------------------
    def event_ms(fn, reps, warmup):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def main_key(variant):
        equation = "helmholtz" if MAIN_HELMHOLTZ[variant] else "poisson"
        return f"{variant}/{equation}"

    timing = {entry(v, dt): {} for v, dt in entries}
    big_box = mesh_gen.box_mesh(32, 32, 32, CONFIG.order)
    big_meshes = {v: mesh_for(v, big_box) for v in ("trilinear",
                                                    "parallelepiped")}
    for e_label, meshes in (("e4096", cfg_meshes), ("e32768", big_meshes)):
        e = len(meshes["trilinear"].verts)
        x32 = torch.as_tensor(rng.standard_normal((e,) + (n1,) * 3),
                              dtype=torch.float32, device=dev)
        for variant, dt in entries:
            x = x32.to(torch_dtype[dt])
            helm = MAIN_HELMHOLTZ[variant]
            mesh = meshes["parallelepiped" if variant == "parallelepiped"
                          else "trilinear"]
            verts = torch.as_tensor(mesh.verts, dtype=torch.float32,
                                    device=dev)
            geom, kw = main_operands(variant, verts, helm, dt=dt)

            def kernel():
                return ops.axhelm(x, b_cfg, variant, geom, helmholtz=helm,
                                  **kw)

            def rowwise():
                return ops.rowwise(x, b_cfg, variant, geom, helmholtz=helm,
                                   **kw)
            extra = {}
            if variant in ops.ROWWISE_VARIANTS:
                # the column or line body and the node body it replaced, in
                # turns
                turns = [graph_ms(fn)
                         for fn in (rowwise, kernel, kernel, rowwise)]
                ms = (turns[1] + turns[2]) / 2
                extra = {"ms_rowwise": (turns[0] + turns[3]) / 2,
                         "turns_ms": turns}
            else:
                ms = graph_ms(kernel)
            ms_eager = event_ms(kernel, reps=200, warmup=20)
            plain_ms = event_ms(lambda: ops.reference(x, b_cfg, variant,
                                                      geom, helmholtz=helm,
                                                      **kw),
                                reps=20, warmup=3)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(
                variant, e, n1, helm, word=WORD_BYTES[dt])
            timing[entry(variant, dt)][e_label] = {
                "E": e, "equation": "helmholtz" if helm else "poisson",
                "ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "roofline_share": bound_ms / ms,
                "GBps": nbytes / ms / 1e6, "GFLOPS": flops / ms / 1e6,
                **extra}
            if extra:
                timing[entry(variant, dt)][e_label][
                    "roofline_share_rowwise"] = bound_ms / extra["ms_rowwise"]
            if variant == "precomputed":
                # K1 on the four stacked columns of pcg_block and refine at
                # nrhs 4, whose factor planes it loads again per column: in
                # turns with the node body, against the bound that reads
                # them once
                x4 = torch.as_tensor(
                    rng.standard_normal((e, 4, 1) + (n1,) * 3),
                    dtype=torch.float32, device=dev).to(torch_dtype[dt])
                turns4 = [graph_ms(lambda: fn(x4, b_cfg, variant, geom,
                                              helmholtz=helm, **kw))
                          for fn in (ops.rowwise, ops.axhelm, ops.axhelm,
                                     ops.rowwise)]
                bound4, by4, nbytes4, flops4 = axhelm_bound(
                    variant, e, n1, helm, ncols=4, word=WORD_BYTES[dt])
                ms4 = (turns4[1] + turns4[2]) / 2
                timing[entry(variant, dt)][e_label]["ncols4"] = {
                    "ms": ms4, "ms_rowwise": (turns4[0] + turns4[3]) / 2,
                    "turns_ms": turns4, "bound_ms": bound4, "bound_by": by4,
                    "bytes": nbytes4, "roofline_share": bound4 / ms4}
                del x4
            del geom, kw, verts, x
        del x32
        torch.cuda.empty_cache()
    # the slab body at GENERIC_ORDERS beside the generic body and the plane
    # twin, in turns (slab, generic, plane, plane, generic, slab): E = 216
    # (the GENERIC_BOX of the main path at each order), c = 1, each
    # variant's main equation, fp32 and bf16
    timing_mid = {slab_name(v, dt): {} for v, dt in entries}
    for order in GENERIC_ORDERS:
        b = basis(order)
        box = mesh_gen.box_mesh(*GENERIC_BOX, order)
        meshes = {v: mesh_for(v, box) for v in ("trilinear",
                                                "parallelepiped")}
        e = len(box.verts)
        x32 = torch.as_tensor(rng.standard_normal((e,) + (b.n1,) * 3),
                              dtype=torch.float32, device=dev)
        for variant, dt in entries:
            x = x32.to(torch_dtype[dt])
            helm = MAIN_HELMHOLTZ[variant]
            mesh = meshes["parallelepiped" if variant == "parallelepiped"
                          else "trilinear"]
            verts = torch.as_tensor(mesh.verts, dtype=torch.float32,
                                    device=dev)
            lams = (1.0, 0.1) if helm else (None, None)
            geom, kw = operands(variant, verts, b, helm, *lams, dt=dt)
            bodies = {"slab": ops.slab, "generic": ops.generic,
                      "plane": ops.plane}
            turns = {name: [] for name in bodies}
            for name in list(bodies) + list(bodies)[::-1]:
                turns[name].append(graph_ms(lambda: bodies[name](
                    x, b, variant, geom, helmholtz=helm, **kw)))
            ms, generic_ms, plane_ms = (statistics.fmean(turns[name])
                                        for name in bodies)
            plain_ms = event_ms(lambda: ops.reference(x, b, variant, geom,
                                                      helmholtz=helm, **kw),
                                reps=5, warmup=1)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(
                variant, e, b.n1, helm, word=WORD_BYTES[dt])
            timing_mid[slab_name(variant, dt)][f"order{order}"] = {
                "E": e, "N1": b.n1, "body": ops.body_of(variant, b.n1),
                "equation": "helmholtz" if helm else "poisson",
                "ms": ms, "generic_ms": generic_ms, "plane_ms": plane_ms,
                "turns_ms": turns, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "flops": flops, "roofline_share": bound_ms / ms,
                "generic_roofline_share": bound_ms / generic_ms,
                "plane_roofline_share": bound_ms / plane_ms}
            del geom, kw, verts, x
        del x32
        torch.cuda.empty_cache()
    for variant in VARIANTS:
        k = config[main_key(variant)]["kernel"]
        k["axhelm_share"] = (timing[entry(variant, "f32")]["e4096"]["ms"]
                             * k["applications"]
                             / (k["ms_per_iteration"] * k["iterations"]))
    # the gather and scatter of the global operator at 16^3 (E = 4096,
    # N1 = 8), c = 1 and 4 columns, on the element kernels' (E, c, N1^3)
    # layout, each a CUDA graph of 50 calls; the gather in turns with the
    # index_add_ (atomics) it replaced; bound: each value read once and
    # written once
    ng = cfg_box.n_global
    ids = torch.as_tensor(cfg_box.global_ids, dtype=torch.int64, device=dev)
    plan = gs.gather_plan(cfg_box.global_ids, ng, dev)
    gather_t = {}
    for ncols in (1, 4):
        yl = torch.as_tensor(rng.standard_normal(
            (e_main, ncols) + (n1,) * 3), dtype=torch.float32, device=dev)
        xg = torch.as_tensor(rng.standard_normal((ng, ncols)),
                             dtype=torch.float32, device=dev)

        def fixed():
            if ncols == 1:
                return gs.gather(yl[:, 0], ids, ng, plan)
            return gs.gather_columns(yl, plan)

        def atomics():
            out = torch.zeros((ng, ncols), device=dev)
            out.index_add_(0, ids.reshape(-1),
                           torch.movedim(yl, 1, -1).reshape(-1, ncols))
            return out[:, 0] if ncols == 1 else out

        def scatter():
            if ncols == 1:
                return gs.scatter(xg[:, 0], ids)
            return gs.scatter_columns(xg, ids)
        turns = [graph_ms(fn) for fn in (atomics, fixed, fixed, atomics)]
        nbytes = 4 * ncols * (e_main * n1 ** 3 + ng)
        first = fixed()
        gather_t[f"c{ncols}"] = {
            "ms": (turns[1] + turns[2]) / 2,
            "index_add_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
            "scatter_ms": graph_ms(scatter),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bytes": nbytes,
            "repeats_bitwise": all(torch.equal(fixed(), first)
                                   for _ in range(3)),
            "max_abs_diff_index_add": float((first - atomics()).abs().max())}
        require(gather_t[f"c{ncols}"]["repeats_bitwise"],
                f"the gather is not bitwise reproducible: {gather_t}")
        del yl, xg
    plan_bytes = sum(t.numel() * t.element_size()
                     for t in (plan.perm, plan.inv))
    del ids, plan
    emit({"phase": "timing", "card": card,
          "gather": {"plan_bytes": plan_bytes,
                     "classes": "dofs by multiplicity 1, 2, 4, 8",
                     **gather_t},
          "ms": "CUDA graph of 50 calls, median of 5 replays; K1-K5: "
                "the mean of two such medians, in turns with their "
                "one-thread-per-node body (ms_rowwise, turns_ms: old, new, "
                "new, old); orders 16-23 (`middle`): the slab body "
                "(ops.slab), the generic body (generic_ms, ops.generic) and "
                "the plane twin (plane_ms, ops.plane), each the mean of "
                "two such medians in turns (slab, generic, plane, plane, "
                "generic, slab); ncols4: K1 at c = 4, in turns the same way",
          "middle": timing_mid,
          "ms_eager": "200 eager calls back to back, CUDA events",
          "library": "none: no single PyTorch call computes axhelm",
          "kernels": timing,
          "axhelm_share_of_solve": {
              v: config[main_key(v)]["kernel"]["axhelm_share"]
              for v in VARIANTS},
          "ms_per_iteration": {key: c["kernel"]["ms_per_iteration"]
                               for key, c in config.items()}})

    # The bodies beside the N1 = 8 main path (phases high_order, staged,
    # tuned, generic)
    def kernel_record(here, first):
        """The checks of the entry points `here` since case `first` (per
        storage type)."""
        return {
            "cases": {dt: len(cases[dt]) - first[dt] for dt in DTYPES},
            "tolerance": rtol,
            "worst_rel_err": {k: worst[k] for k in here},
            "main_path_abs_err": {k: main_abs[k] for k in here},
            "ulps_from_correctly_rounded": {
                "counts": "outputs 0, 1 and more ulps apart",
                **{k: ulps[k] for k in here if k in ulps}}}

    def high_order_solves(what, meshes, small_meshes, small_what):
        """(a) The six fp32 main paths on `meshes`, HIGH_ORDER_ITERS
        iterations captured and eager in turns, with the setup's peak
        memory, and their launches read over one more captured solve
        (every count set to 0 just before it): one entry-point launch an
        application; (b) each on
        `small_meshes` against the reference backend (the same status,
        iterations +-1, Helmholtz within HIGH_ORDER_HELMHOLTZ_ITER_SHARE, x
        within HIGH_ORDER_X_BOUND); (c) each variant's bf16_x32 solve at
        tol 0.03 on `meshes`, its status and inner iterations recorded (a
        refined solve's outcome hinges on a few ulps: PERF.md).  Returns
        the records of (a), (b), (c)."""
        solves, small, refined = {}, {}, {}
        for variant, helm in cfg_runs:
            key = f"{variant}/{'helmholtz' if helm else 'poisson'}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            prob, box, x_true, rhs = manufactured(
                high_mesh_for(variant, meshes), variant, "cuda", helm)
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated() - base
            out, ginfo = in_turns(prob, box, variant, rhs, CONFIG.tol,
                                  HIGH_ORDER_ITERS,
                                  repeats=HIGH_ORDER_REPEATS)
            cap = out["captured"]
            k = solve_record(prob, variant, "cuda", helm, x_true,
                             cap["res"], cap["walls"], cap["launches"],
                             cap["applications"], cap["peak"])
            k["body"] = ops.body_of(variant, prob.basis.n1)
            flops = nekbone.flop_count(prob.mesh, 1, helm, 1)
            k["GFLOPS"] = flops / k["ms_per_iteration"] / 1e6
            k["GDOFS"] = prob.mesh.n_global / k["ms_per_iteration"] / 1e6
            k["setup_peak_bytes"] = setup_peak
            name = entry(variant, "f32")
            box["op"] = 0
            ops.reset_launch_counts()
            nekbone.solve(prob, rhs, tol=CONFIG.tol,
                          max_iter=HIGH_ORDER_ITERS)
            torch.cuda.synchronize()
            k["main_path_read"] = {"applications": box["op"],
                                   "launches": ops.launch_counts[name]}
            require(ops.launch_counts[name] == box["op"] > 0 and
                    sum(ops.launch_counts.values()) == box["op"],
                    f"{what} {key}: {k['main_path_read']}")
            solves[key] = {"kernel": k, "graph": graph_row(
                f"{what} {key}", out, ginfo)}
            del prob, box, rhs, out
            runs = {}
            for backend in ("cuda", "reference"):
                prob, box, x_true, rhs = manufactured(
                    high_mesh_for(variant, small_meshes), variant, backend,
                    helm)
                res, walls, launches, peak = timed_solves(
                    prob, box, variant, backend, rhs, HIGH_ORDER_TOL,
                    HIGH_ORDER_MAX_ITER, 1)
                runs[backend] = (solve_record(prob, variant, backend, helm,
                                              x_true, res, walls, launches,
                                              box, peak), res.x)
                del prob, box, rhs
            (kr, xk), (rr, xr) = runs["cuda"], runs["reference"]
            dx = float((xk - xr).abs().max() / xr.abs().max())
            slack = max(1, int(HIGH_ORDER_HELMHOLTZ_ITER_SHARE
                               * rr["iterations"])) if helm else 1
            require(kr["status"] == rr["status"] and
                    abs(kr["iterations"] - rr["iterations"]) <= slack and
                    dx <= HIGH_ORDER_X_BOUND,
                    f"{small_what} {key}: kernels {kr} against the "
                    f"reference backend {rr}, x differs by {dx:.3e}")
            small[key] = {"kernel": kr, "reference": rr,
                          "iteration_slack": slack, "x_max_rel_diff": dx}
            torch.cuda.empty_cache()
        for variant in VARIANTS:
            refined[variant] = run_refined(high_mesh_for(variant, meshes),
                                           variant, "cuda", 0.03,
                                           helm=MAIN_HELMHOLTZ[variant])
        return solves, small, refined

    # 6b. high_order: the plane body, N1 above ops.N1_MAX -----------------
    # (a) every entry point at PLANE_ORDERS against its plain version;
    # (b) the order-31 main paths on the 4x4x4 box, captured and eager in
    # turns; each on the 2x1x1 box against the reference backend; each
    # variant's bf16_x32 solve at tol 0.03 on the 4x4x4 box, its status and
    # inner iterations recorded (a refined solve's outcome hinges on a few
    # ulps: PERF.md); (c) each plane entry point timed at PLANE_ELEMS.
    t_high = time.perf_counter()
    boxes = {order: mesh_gen.box_mesh(*HIGH_ORDER_BOX, order)
             for order in PLANE_ORDERS}
    high_cases = {dt: len(cases[dt]) for dt in DTYPES}
    for order in PLANE_ORDERS:
        b = basis(order)
        require(ops.body_of("trilinear", b.n1) == "plane",
                f"N1={b.n1} does not run the plane body")
        e = PLANE_ELEMS_CAP if b.n1 == ops.N1_PLANE_MAX else PLANE_ELEMS
        check_order(b, e, {v: mesh_for(v, boxes[order])
                           for v in ("trilinear", "parallelepiped")},
                    order, plane_name)
    # the main path's call: E = 64, N1 = 32, c = 1, setup's scalar lambdas
    b_hi = basis(HIGH_ORDER)
    hi_meshes = {v: mesh_for(v, boxes[HIGH_ORDER]) for v in ("trilinear",
                                                             "parallelepiped")}
    small_box = mesh_gen.box_mesh(*HIGH_ORDER_SMALL_BOX, HIGH_ORDER)
    small_meshes = {v: mesh_for(v, small_box) for v in ("trilinear",
                                                        "parallelepiped")}
    e_hi = len(boxes[HIGH_ORDER].verts)
    check_main_call(b_hi, hi_meshes, plane_name)
    high_kernels = kernel_record(
        [plane_name(v, dt) for dt in DTYPES for v in VARIANTS], high_cases)
    # (b) the solves
    high_solves, high_small, high_bf16 = high_order_solves(
        f"4^3 order {HIGH_ORDER}", hi_meshes, small_meshes,
        f"2x1x1 order {HIGH_ORDER}")
    # (c) the plane body's times: E = 64, c = 1, each variant's main
    # equation with setup's scalar lambdas, fp32 and bf16
    timing_plane = {plane_name(v, dt): {} for v, dt in entries}
    for order in PLANE_ORDERS:
        b = basis(order)
        meshes = {v: mesh_for(v, boxes[order]) for v in ("trilinear",
                                                         "parallelepiped")}
        e = len(boxes[order].verts)
        gen.manual_seed(order + 1)
        x32 = torch.randn((e,) + (b.n1,) * 3, generator=gen, device=dev)
        launch = ops.plane_launch(b.n1, e, 1)._asdict()
        for variant, dt in entries:
            x = x32.to(torch_dtype[dt])
            helm = MAIN_HELMHOLTZ[variant]
            verts = torch.as_tensor(high_mesh_for(variant, meshes).verts,
                                    dtype=torch.float32, device=dev)
            lams = (1.0, 0.1) if helm else (None, None)
            geom, kw = operands(variant, verts, b, helm, *lams, dt=dt)
            ms = graph_ms(lambda: ops.axhelm(x, b, variant, geom,
                                             helmholtz=helm, **kw))
            plain_ms = event_ms(lambda: ops.reference(x, b, variant, geom,
                                                      helmholtz=helm, **kw),
                                reps=3, warmup=1)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(
                variant, e, b.n1, helm, word=WORD_BYTES[dt])
            timing_plane[plane_name(variant, dt)][f"order{order}"] = {
                "E": e, "N1": b.n1, "design": launch,
                "equation": "helmholtz" if helm else "poisson",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "roofline_share": bound_ms / ms}
            del geom, kw, verts, x
        del x32, meshes
        torch.cuda.empty_cache()
    emit({"phase": "high_order", "card": card,
          "orders": PLANE_ORDERS, "n1_plane_max": ops.N1_PLANE_MAX,
          "kernels_per_application": ops.PLANE_KERNELS,
          "kernels": high_kernels,
          "mesh": "x".join(map(str, HIGH_ORDER_BOX)), "order": HIGH_ORDER,
          "elements": e_hi, "dofs": boxes[HIGH_ORDER].n_global,
          "iterations": HIGH_ORDER_ITERS,
          "turns": f"eager, captured, captured, eager; {HIGH_ORDER_REPEATS} "
                   f"timed solves a turn after one warm-up solve of each "
                   f"mode",
          "solves": high_solves,
          "against_reference": {
              "mesh": "x".join(map(str, HIGH_ORDER_SMALL_BOX)),
              "dofs": small_box.n_global, "tol": HIGH_ORDER_TOL,
              "solves": high_small},
          "bf16_x32": {"tol": 0.03, "max_iter": REFINED_MAX_ITER,
                       "solves": high_bf16},
          "ms": "CUDA graph of 50 calls, median of 5 replays",
          "timing": timing_plane,
          "registers": [{k: c.get(k) for k in (
              "variant", "pass", "dtype", "registers", "smem_bytes",
              "spill_stores", "spill_loads")}
              for c in inst if c.get("body") == "plane"],
          "seconds": time.perf_counter() - t_high})
    del boxes, hi_meshes, small_meshes

    # 6c. staged: the staged body, N1 above ops.N1_PLANE_MAX -------------
    # (a) every entry point at STAGED_ORDERS against its plain version
    # (the vertices of a 2x2x2 box do not depend on the order); (b) the
    # order-63 main paths on the 2x2x2 box, captured and eager in turns,
    # with the setup's peak memory; each on the 2x1x1 box at
    # STAGED_SMALL_ORDER against the reference backend; each variant's
    # bf16_x32 solve at tol 0.03 on the 2x2x2 box; (c) each staged entry
    # point timed at the main path's E and N1, and the timing-only twin at
    # the plane body's orders; (d) the registers and spills of its
    # kernels (phase 2).
    t_staged = time.perf_counter()
    staged_cases = {dt: len(cases[dt]) for dt in DTYPES}
    st_meshes = {v: mesh_for(v, mesh_gen.box_mesh(*STAGED_BOX, 1))
                 for v in ("trilinear", "parallelepiped")}
    for order in STAGED_ORDERS:
        b = basis(order)
        require(ops.body_of("trilinear", b.n1) == "staged",
                f"N1={b.n1} does not run the staged body")
        for e in STAGED_ELEMS:
            check_order(b, e, st_meshes, 10 * order + e, staged_name)
        torch.cuda.empty_cache()
    # both sides of the switch from 32 to 16 lines an item
    for order in STAGED_SWITCH_ORDERS:
        b = basis(order)
        require(ops.body_of("trilinear", b.n1) == "staged",
                f"N1={b.n1} does not run the staged body")
        check_order(b, 1, st_meshes, 10 * order + 1, staged_name, cols=(1,))
        torch.cuda.empty_cache()
    require(ops.staged_launch(STAGED_SWITCH_ORDERS[0] + 1, 1, 1).lines
            == ops.STAGED_TILE[1]
            and ops.staged_launch(STAGED_SWITCH_ORDERS[1] + 1, 1, 1).lines
            == ops.STAGED_NARROW_LINES,
            f"orders {STAGED_SWITCH_ORDERS} are not the two sides of the "
            f"staged body's switch")
    # the main path's call: E = 8, N1 = 64, c = 1, setup's scalar lambdas
    b_st = basis(STAGED_ORDER)
    st_box = mesh_gen.box_mesh(*STAGED_BOX, STAGED_ORDER)
    st_main = {v: mesh_for(v, st_box) for v in ("trilinear",
                                                "parallelepiped")}
    e_st = len(st_box.verts)
    check_main_call(b_st, st_main, staged_name)
    staged_kernels = kernel_record(
        [staged_name(v, dt) for dt in DTYPES for v in VARIANTS],
        staged_cases)
    # (b) the solves
    small_st = mesh_gen.box_mesh(*HIGH_ORDER_SMALL_BOX, STAGED_SMALL_ORDER)
    small_st_meshes = {v: mesh_for(v, small_st) for v in ("trilinear",
                                                          "parallelepiped")}
    st_solves, st_small, st_bf16 = high_order_solves(
        f"2^3 order {STAGED_ORDER}", st_main, small_st_meshes,
        f"2x1x1 order {STAGED_SMALL_ORDER}")
    st_setup = {key: r["kernel"]["setup_peak_bytes"]
                for key, r in st_solves.items()}
    # (c) times: the staged body at the main path's E = 8, N1 = 64, and
    # the twin at the plane body's orders (E = 64), each entry point's
    # main equation with setup's scalar lambdas, fp32 and bf16
    timing_staged = {staged_name(v, dt): {} for v, dt in entries}
    for order, e, twin in [(STAGED_ORDER, e_st, False)] + \
            [(o, PLANE_ELEMS, True) for o in STAGED_TWIN_ORDERS]:
        b = basis(order)
        meshes = st_main if not twin else {
            v: mesh_for(v, mesh_gen.box_mesh(*HIGH_ORDER_BOX, 1))
            for v in ("trilinear", "parallelepiped")}
        gen.manual_seed(order + 1)
        x32 = torch.randn((e,) + (b.n1,) * 3, generator=gen, device=dev)
        for variant, dt in entries:
            x = x32.to(torch_dtype[dt])
            helm = MAIN_HELMHOLTZ[variant]
            launch = ops.staged_launch(b.n1, e, 1, helm)
            verts = torch.as_tensor(high_mesh_for(variant, meshes).verts,
                                    dtype=torch.float32, device=dev)
            lams = (1.0, 0.1) if helm else (None, None)
            geom, kw = operands(variant, verts, b, helm, *lams, dt=dt)
            run = ops.staged if twin else ops.axhelm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y = run(x, b, variant, geom, helmholtz=helm, **kw)
            torch.cuda.synchronize()
            transient = torch.cuda.max_memory_allocated() \
                - torch.cuda.memory_allocated()
            del y
            ms = graph_ms(lambda: run(x, b, variant, geom, helmholtz=helm,
                                      **kw))
            bound_ms, bound_by, nbytes, flops = axhelm_bound(
                variant, e, b.n1, helm, word=WORD_BYTES[dt])
            tensor_ms, tensor_by = staged_tensor_bound(
                variant, e, b.n1, helm, word=WORD_BYTES[dt])
            row = {"E": e, "N1": b.n1,
                   "design": {"lines": launch.lines, "items": launch.items,
                              "passes": launch.passes,
                              "smem_bytes": launch.smem_bytes,
                              "scratch_bytes": launch.scratch_bytes},
                   "transient_bytes": transient,
                   "equation": "helmholtz" if helm else "poisson",
                   "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "flops": flops,
                   "roofline_share": bound_ms / ms,
                   "tensor_bound_ms": tensor_ms,
                   "tensor_bound_by": tensor_by,
                   "tensor_share": tensor_ms / ms}
            if twin:
                pl = timing_plane[plane_name(variant, dt)][f"order{order}"]
                row["twin"] = "ops.staged"
                row["plane_ms"] = pl["ms"]
                row["staged_over_plane"] = ms / pl["ms"]
            else:
                row["plain_ms"] = event_ms(
                    lambda: ops.reference(x, b, variant, geom,
                                          helmholtz=helm, **kw),
                    reps=3, warmup=1)
            timing_staged[staged_name(variant, dt)][f"order{order}"] = row
            del geom, kw, verts, x
        del x32
        torch.cuda.empty_cache()
    # (d) the registers and spills of its kernels
    st_regs = [{k: c.get(k) for k in ("variant", "pass", "dtype",
                                      "registers", "smem_bytes",
                                      "spill_stores", "spill_loads")}
               for c in inst if c.get("body") == "staged"]
    emit({"phase": "staged", "card": card, "orders": STAGED_ORDERS,
          "elements": STAGED_ELEMS, "switch_orders": STAGED_SWITCH_ORDERS,
          "n1_staged_max": ops.N1_STAGED_MAX,
          "design": {"tile": ops.STAGED_TILE,
                     "narrow_lines": ops.STAGED_NARROW_LINES,
                     "n1_wide_max": ops.N1_STAGED_WIDE_MAX,
                     "stages": ops.STAGED_STAGES,
                     "kernels_per_application": ops.STAGED_KERNELS,
                     "note": "from ops.py (staged_launch's lines, items and "
                             "scratch in each timing row's 'design'), not "
                             "read on the card"},
          "kernels": staged_kernels,
          "mesh": "x".join(map(str, STAGED_BOX)), "order": STAGED_ORDER,
          "main_elements": e_st, "dofs": st_box.n_global,
          "iterations": HIGH_ORDER_ITERS,
          "turns": f"eager, captured, captured, eager; {HIGH_ORDER_REPEATS} "
                   f"timed solves a turn after one warm-up solve of each "
                   f"mode",
          "solves": st_solves,
          "setup_peak_bytes": st_setup,
          "against_reference": {
              "mesh": "x".join(map(str, HIGH_ORDER_SMALL_BOX)),
              "order": STAGED_SMALL_ORDER, "dofs": small_st.n_global,
              "tol": HIGH_ORDER_TOL, "solves": st_small},
          "bf16_x32": {"tol": 0.03, "max_iter": REFINED_MAX_ITER,
                       "solves": st_bf16},
          "ms": "CUDA graph of 50 calls, median of 5 replays",
          "timing": timing_staged, "registers": st_regs,
          "seconds": time.perf_counter() - t_staged})
    del st_box, st_main, small_st, small_st_meshes, st_meshes

    # 6d. tuned: the tuned bodies at every N1 from 2 to ops.N1_TUNED_MAX ---
    # (their checks at every N1 ran in phases 3 and 3b) (a) the 16^3 order-9
    # main path's calls against the plain version; (b) its six fp32 main
    # paths, captured and eager in turns, each on the 2x1x1 box against the
    # reference backend, each variant's bf16_x32 solve at tol 0.03 (the
    # rules of `high_order`); (c) each entry point timed at every N1, E =
    # 4096 (the config's box at each order), c = 1, beside the generic
    # body's timing-only twin and the bound.
    t_tuned = time.perf_counter()
    b_tu = basis(TUNED_ORDER)
    tu_box = mesh_gen.box_mesh(nx, ny, nz, TUNED_ORDER)
    tu_meshes = meshes_of(tu_box)
    tu_abs = {}
    check_main_call(b_tu, tu_meshes, entry, into=tu_abs)
    tu_small = mesh_gen.box_mesh(*HIGH_ORDER_SMALL_BOX, TUNED_ORDER)
    tu_solves, tu_vs_ref, tu_bf16 = high_order_solves(
        f"16^3 order {TUNED_ORDER}", tu_meshes, meshes_of(tu_small),
        f"2x1x1 order {TUNED_ORDER}")
    del tu_meshes
    timing_tuned = {entry(v, dt): {} for v, dt in entries}
    for n1_case in ops.KERNEL_N1:
        b = basis(n1_case - 1)
        box = mesh_gen.box_mesh(nx, ny, nz, b.n)
        meshes = meshes_of(box)
        e = len(box.verts)
        gen.manual_seed(n1_case)
        x32 = torch.randn((e,) + (n1_case,) * 3, generator=gen, device=dev)
        for variant, dt in entries:
            x = x32.to(torch_dtype[dt])
            helm = MAIN_HELMHOLTZ[variant]
            verts = torch.as_tensor(high_mesh_for(variant, meshes).verts,
                                    dtype=torch.float32, device=dev)
            lams = (1.0, 0.1) if helm else (None, None)
            geom, kw = operands(variant, verts, b, helm, *lams, dt=dt)
            ms = graph_ms(lambda: ops.axhelm(x, b, variant, geom,
                                             helmholtz=helm, **kw),
                          reps=TUNED_TIMING_REPS)
            generic_ms = graph_ms(lambda: ops.generic(x, b, variant, geom,
                                                      helmholtz=helm, **kw),
                                  reps=TUNED_TIMING_REPS)
            plain_ms = event_ms(lambda: ops.reference(x, b, variant, geom,
                                                      helmholtz=helm, **kw),
                                reps=3, warmup=1)
            bound_ms, bound_by, nbytes, flops = axhelm_bound(
                variant, e, n1_case, helm, word=WORD_BYTES[dt])
            timing_tuned[entry(variant, dt)][n1_case] = {
                "E": e, "order": b.n, "body": ops.body_of(variant, n1_case),
                "equation": "helmholtz" if helm else "poisson",
                "ms": ms, "generic_ms": generic_ms,
                "generic_over_tuned": generic_ms / ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "flops": flops,
                "roofline_share": bound_ms / ms,
                "generic_roofline_share": bound_ms / generic_ms}
            del geom, kw, verts, x
        del x32, meshes
        torch.cuda.empty_cache()
    emit({"phase": "tuned", "card": card,
          "n1": [ops.KERNEL_N1[0], ops.KERNEL_N1[-1]],
          "main_call_abs_err": tu_abs,
          "mesh": "x".join(map(str, CONFIG.elements)), "order": TUNED_ORDER,
          "elements": len(tu_box.verts), "dofs": tu_box.n_global,
          "iterations": HIGH_ORDER_ITERS,
          "turns": f"eager, captured, captured, eager; {HIGH_ORDER_REPEATS} "
                   f"timed solves a turn after one warm-up solve of each "
                   f"mode",
          "solves": tu_solves,
          "against_reference": {
              "mesh": "x".join(map(str, HIGH_ORDER_SMALL_BOX)),
              "dofs": tu_small.n_global, "tol": HIGH_ORDER_TOL,
              "solves": tu_vs_ref},
          "bf16_x32": {"tol": 0.03, "max_iter": REFINED_MAX_ITER,
                       "solves": tu_bf16},
          "ms": f"CUDA graph of {TUNED_TIMING_REPS} calls, median of 5 "
                f"replays; generic_ms the generic body (`ops.generic`) "
                f"the same way, after the tuned body",
          "timing": timing_tuned,
          "slower_than_generic": [
              [name, n1_case] for name, rows in timing_tuned.items()
              for n1_case, r in rows.items() if r["ms"] > r["generic_ms"]],
          "registers_smem": tuned_regs,
          "line_blocks_per_sm": {
              f"{entry(v, dt)}/{n1_case}": ops._line_blocks(
                  v, torch_dtype[dt], n1_case, dev)
              for v in ops.LINE_VARIANTS for dt in DTYPES
              for n1_case in ops.KERNEL_N1},
          "line_rolled_from": ops.LINE_ROLL_FROM,
          "seconds": time.perf_counter() - t_tuned})
    del tu_box, tu_small

    # 6e. generic: the main path of orders 16 to 23, N1 above
    # ops.N1_TUNED_MAX, through the slab body (its checks at every N1 ran
    # in phases 3 and 3b, its times in phase 6): the six fp32 main paths on the GENERIC_BOX
    # at GENERIC_MAIN_ORDER, captured and eager in turns, each on the 2x1x1
    # box against the reference backend, each variant's bf16_x32 solve at
    # tol 0.03 (the rules of `high_order`).
    t_generic = time.perf_counter()
    gen_small = mesh_gen.box_mesh(*HIGH_ORDER_SMALL_BOX, GENERIC_MAIN_ORDER)
    gen_solves, gen_vs_ref, gen_bf16 = high_order_solves(
        f"{'x'.join(map(str, GENERIC_BOX))} order {GENERIC_MAIN_ORDER}",
        gen_meshes, meshes_of(gen_small),
        f"2x1x1 order {GENERIC_MAIN_ORDER}")
    emit({"phase": "generic", "card": card, "orders": GENERIC_ORDERS,
          "n1": [ops.N1_TUNED_MAX + 1, ops.N1_SLAB_MAX],
          "body": "slab",
          "mesh": "x".join(map(str, GENERIC_BOX)),
          "order": GENERIC_MAIN_ORDER, "elements": len(gen_box.verts),
          "dofs": gen_box.n_global, "iterations": HIGH_ORDER_ITERS,
          "turns": f"eager, captured, captured, eager; {HIGH_ORDER_REPEATS} "
                   f"timed solves a turn after one warm-up solve of each "
                   f"mode",
          "solves": gen_solves,
          "against_reference": {
              "mesh": "x".join(map(str, HIGH_ORDER_SMALL_BOX)),
              "dofs": gen_small.n_global, "tol": HIGH_ORDER_TOL,
              "solves": gen_vs_ref},
          "bf16_x32": {"tol": 0.03, "max_iter": REFINED_MAX_ITER,
                       "solves": gen_bf16},
          "seconds": time.perf_counter() - t_generic})
    del gen_meshes, gen_small

    # 6f. lint: every entry of the contract lint's registry on the card ----
    # (the sharded ones on gloo ranks on this one card, as 5f and 5g run):
    # the dense and refined loop bodies recorded and replayed under sync
    # debug mode "error", the ptxas registers and spills of every launch
    # the axhelm entries resolve
    t_lint = time.perf_counter()
    lint_rows = lint.run_entries(list(lint.REGISTRY), dev)
    emit({"phase": "lint", "card": card,
          "entries": [{k: r[k] for k in ("entry", "status", "checks",
                                          "seconds")} for r in lint_rows],
          "seconds": time.perf_counter() - t_lint})
    for r in lint_rows:
        require(r["status"] == "pass",
                f"lint {r['entry']}: {r['status']} "
                f"{r.get('error', '')} {r['violations'][:4]}")

    # 6g. tune: the launch tuner's sweep into a cache of its own ----------
    t_tune = time.perf_counter()
    tune_rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune.") as tmp:
        os.environ[tune.CACHE_ENV] = str(Path(tmp) / "axhelm_tune.json")
        tune.clear()
        try:
            for variant, dt, n1 in [(v, dt, n1) for v in TUNE_VARIANTS
                                    for dt in DTYPES for n1 in TUNE_N1]:
                e = TUNE_ELEMS if n1 <= ops.N1_SLAB_MAX else \
                    TUNE_ELEMS_HIGH
                winner, timings = tune.autotune(
                    variant, n1 - 1, dtype=torch_dtype[dt], e=e, ncols=1,
                    device=dev)
                tune_rows.append({
                    "entry_point": entry(variant, dt), "n1": n1, "e": e,
                    "static": ops.body_of(variant, n1), "winner": winner,
                    "us": {body: 1e6 * t for body, t in timings.items()}})
            # a fresh in-process cache resolves every winner from the file
            tune.clear()
            for r, (variant, dt) in zip(tune_rows, [
                    (v, dt) for v in TUNE_VARIANTS for dt in DTYPES
                    for _ in TUNE_N1]):
                got = tune.get_body(variant, r["n1"], torch_dtype[dt],
                                    device=dev)
                require(got == r["winner"],
                        f"tune: {r['entry_point']} at N1={r['n1']} resolves "
                        f"{got} from the cache file, tuned {r['winner']}")
                # the tuned route against its plain version, counted as
                # the entry point's launch
                b, x, geom, lam0, lam1 = tune._synthetic_inputs(
                    variant, r["n1"] - 1, torch_dtype[dt], False, 5, 1, dev)
                before = ops.launch_counts[r["entry_point"]]
                y = ops.axhelm(x, b, variant, geom, lam0=lam0, lam1=lam1)
                y_p = ops.reference(x, b, variant, geom, lam0=lam0,
                                    lam1=lam1)
                torch.cuda.synchronize()
                r["max_rel_err"] = float((y.float() - y_p.float()).abs()
                                         .max() / y_p.float().abs().max())
                require(r["max_rel_err"] <= rtol[dt],
                        f"tune: {r['entry_point']} at N1={r['n1']} through "
                        f"{r['winner']}: relative error "
                        f"{r['max_rel_err']:.3e} > {rtol[dt]}")
                require(ops.launch_counts[r["entry_point"]] == before + 1,
                        f"tune: the tuned route of {r['entry_point']} did "
                        f"not count one entry-point launch")
            # with no cache file, every entry point's static route
            os.environ[tune.CACHE_ENV] = str(Path(tmp) / "absent.json")
            tune.clear()
            off = [(v, dt, n1) for v in VARIANTS for dt in DTYPES
                   for n1 in range(2, ops.N1_STAGED_MAX + 1)
                   if tune.get_body(v, n1, torch_dtype[dt],
                                    MAIN_HELMHOLTZ[v], device=dev)
                   != ops.body_of(v, n1)]
            require(not off and not (Path(tmp) / "absent.json").exists(),
                    f"tune: without a cache file {off[:4]} left the "
                    f"static route")
        finally:
            os.environ.pop(tune.CACHE_ENV)
            tune.clear()
    emit({"phase": "tune", "card": card, "sweeps": tune_rows,
          "static_route_checked": f"{len(VARIANTS)} variants x "
                                  f"{len(DTYPES)} storage types x N1 2-"
                                  f"{ops.N1_STAGED_MAX}",
          "seconds": time.perf_counter() - t_tune})

    # 6h. lm_serve: qwen3-0.6b behind the LM serving engine -------------
    lm_serve_phase(dev, card)

    # 6i. lm_train: qwen3-0.6b trained through launch/train.py's path ----
    lm_train_phase(dev, card)

    # 6j. lm_serve_moe: moonshot-v1-16b-a3b, full width and depth, served
    lm_serve_moe_phase(dev, card)

    # 6k. lm_train_moe: moonshot-v1-16b-a3b trained at full width, cut ----
    lm_train_moe_phase(dev, card)

    # 6l. lm_serve_hybrid: zamba2-2.7b, full width and depth, served -----
    lm_serve_hybrid_phase(dev, card)

    # 6m. lm_train_hybrid: zamba2-2.7b trained at full width ------------
    lm_train_hybrid_phase(dev, card)

    # 6n. lm_vlm: phi-3-vision-4.2b prefilled, decoded and trained -------
    lm_vlm_phase(dev, card)

    # 6o. lm_serve_xlstm: xlstm-350m, full width and depth, served -------
    lm_serve_xlstm_phase(dev, card)

    # 6p. lm_train_xlstm: xlstm-350m trained at full width, seq cut ------
    lm_train_xlstm_phase(dev, card)

    # 6q. lm_audio: seamless-m4t-medium prefilled, decoded and trained ---
    lm_audio_phase(dev, card)

    # 7. the kernels line, the card line, the result line -------------------
    def main_path(variant, dt):
        """Where an entry point's `launches` were counted."""
        if dt == "f32":
            return f"16^3 fp32 {main_key(variant)}"
        if variant == "trilinear":
            return "16^3 bf16_x32 trilinear/poisson nrhs=1 tol=3.0"
        return f"8^3 bf16_x32 {main_key(variant)} tol=0.03"

    kernels = []
    for variant, dt in entries:
        name = entry(variant, dt)
        t, t_big = timing[name]["e4096"], timing[name]["e32768"]
        launches = config[main_key(variant)]["kernel"]["launches"] \
            if dt == "f32" else bf16_launches[variant]
        kernels.append({
            "name": name, "variant": variant, "storage": dt,
            "route": "cuda", "source": SOURCE[BODY[variant]],
            "replaces": REPLACES[variant],
            "main_path": main_path(variant, dt), "launches": launches,
            "launches_sharded": sharded_launches[name],
            "launches_serve": serve_launches[name],
            "max_abs_err": main_abs[name], "max_rel_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "ms_eager": t["ms_eager"],
            "ms_e32768": t_big["ms"], "bound_ms_e32768": t_big["bound_ms"],
            "plain_ms_e32768": t_big["plain_ms"],
            "launches_order9": tu_solves[main_key(variant)]["kernel"][
                "main_path_read"]["launches"] if dt == "f32" else
            tu_bf16[variant]["launches"].get(name, 0),
            "by_n1": {n1_case: {k: r[k] for k in (
                "ms", "generic_ms", "plain_ms", "bound_ms", "bound_by")}
                for n1_case, r in timing_tuned[name].items()}})
    for variant, dt in entries:
        # the order-19 main paths run the slab body
        name = body_name(variant, dt, GENERIC_MAIN_ORDER + 1)
        require(name == slab_name(variant, dt),
                f"the order-{GENERIC_MAIN_ORDER} main path runs {name}, not "
                f"the slab body")
        by_order = timing_mid[name]
        t = by_order[f"order{GENERIC_MAIN_ORDER}"]
        launches = gen_solves[main_key(variant)]["kernel"][
            "main_path_read"]["launches"] if dt == "f32" else \
            gen_bf16[variant]["launches"].get(entry(variant, dt), 0)
        kernels.append({
            "name": name, "variant": variant, "storage": dt,
            "route": "cuda", "source": SOURCE["slab"],
            "replaces": REPLACES[variant],
            "main_path": f"{'x'.join(map(str, GENERIC_BOX))} order "
                         f"{GENERIC_MAIN_ORDER} "
                         f"{'fp32' if dt == 'f32' else 'bf16_x32 tol=0.03'} "
                         f"{main_key(variant)}",
            "launches": launches,
            "max_abs_err": main_abs[name], "max_rel_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "order": GENERIC_MAIN_ORDER,
            "by_order": {o: {k: by_order[o][k] for k in
                             ("N1", "body", "ms", "generic_ms", "plane_ms",
                              "plain_ms", "bound_ms", "bound_by")}
                         for o in by_order}})
    for variant, dt in entries:
        name = plane_name(variant, dt)
        by_order = timing_plane[name]
        t = by_order[f"order{HIGH_ORDER}"]
        launches = high_solves[main_key(variant)]["kernel"][
            "main_path_read"]["launches"] if dt == "f32" else \
            high_bf16[variant]["launches"].get(entry(variant, dt), 0)
        kernels.append({
            "name": name, "variant": variant, "storage": dt,
            "route": "cuda", "source": SOURCE["plane"],
            "replaces": REPLACES[variant],
            "main_path": f"4^3 order {HIGH_ORDER} "
                         f"{'fp32' if dt == 'f32' else 'bf16_x32 tol=0.03'} "
                         f"{main_key(variant)}",
            "launches": launches,
            "max_abs_err": main_abs[name], "max_rel_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "order": HIGH_ORDER,
            "by_order": {o: {k: by_order[o][k] for k in
                             ("N1", "ms", "plain_ms", "bound_ms",
                              "bound_by")}
                         for o in by_order}})
    for variant, dt in entries:
        name = staged_name(variant, dt)
        by_order = timing_staged[name]
        t = by_order[f"order{STAGED_ORDER}"]
        launches = st_solves[main_key(variant)]["kernel"]["main_path_read"][
            "launches"] if dt == "f32" else \
            st_bf16[variant]["launches"].get(entry(variant, dt), 0)
        kernels.append({
            "name": name, "variant": variant, "storage": dt,
            "route": "cuda", "source": SOURCE["staged"],
            "replaces": REPLACES[variant],
            "main_path": f"2^3 order {STAGED_ORDER} "
                         f"{'fp32' if dt == 'f32' else 'bf16_x32 tol=0.03'} "
                         f"{main_key(variant)}",
            "launches": launches,
            "max_abs_err": main_abs[name], "max_rel_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "order": STAGED_ORDER,
            "twin_by_order": {o: {k: by_order[o][k] for k in
                                  ("N1", "ms", "plane_ms", "bound_ms")}
                              for o in by_order if "twin" in by_order[o]}})
    for kern in kernels:
        require(kern["launches"] > 0, f"{kern['name']} was not launched on "
                f"the main path")
    emit({"kernels": kernels})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
