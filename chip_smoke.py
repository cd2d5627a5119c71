#!/usr/bin/env python3
"""Drive the PyTorch port of the DR datapath on one CUDA card.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a non-zero exit code):

  1. card     — the card's name and power limit, torch / CUDA versions, and
                the build of every CUDA kernel from `src/repro_torch/kernels/csrc`
  2. kernels  — each kernel against its plain PyTorch version on the card,
                at the reference tests' shapes (ragged odd sizes included),
                in f32 and bf16, plus integer exactness; fused_transform
                and ternary_matmul also at R densities down to s = 1, with
                all-zero rows of R, in each of their bodies (`tiles` /
                `plan`: dense, sparse; fused_transform's sparse body with
                one p tile or p split); easi_apply in each of its bodies
                (`plan`: small, one launch; split, two) under each
                (so, ho), each g, f32 and bf16; integers exact at the wide
                shape for s = 1, 3 and p; two calls give the same bits;
                easi_apply's column templates (`EASI_TILE_SHAPES`: every
                width of each body the shape admits, through the C entry, in
                f32 and bf16) equal to the narrowest width bit for bit and
                within EASI_TOL / BF16_TOL of the plain version, and
                `plan`'s width for each easi_block_m the resource model's
  2b. resources — every template instance of the ten kernel bodies
                (`resource_model.every_instance`): cudaFuncGetAttributes
                through `csrc/attributes.cu` against the resource model —
                static and dynamic shared bytes equal, registers at most the
                launch-bounds ceiling, CTAs an SM at least the model's;
                spilled bytes printed
  3. paper    — the paper's model rp24_easi_n16 (RP 32→24, rotation EASI
                24→16, block 32) on Waveform-V2: init → fit (4000 rows, 40
                epochs) → transform (1000 rows) → train-while-serve over
                ragged requests, through the kernels; the same sequence on
                the plain torch backend is the reference
  3b. table1  — the paper's experiment: the four Table I rows (easi_n16,
                rp24_easi_n16, easi_n8, rp16_easi_n8) through
                `pipeline.fit_two_stage` and `evaluate` at the protocol's full
                epochs on Waveform-V2, kernel backend then torch backend: R
                equal, B after fit within TRAJ_TOL, accuracies one point
                apart at most and above tests/test_waveform_repro.py's
                floors, |Δ(n=16)| < 0.08, every DR kernel launched; the Table
                II rows against the reference's ratios; the ICA benchmark's
                Amari distances, kernel against torch; and a registered
                state's B written in place, which the captured bucket
                program must answer from
  4. wide     — the repo's wide DR row (1024 → 256 → 128, block 256):
                update + transform through the kernels, then each kernel
                timed beside its plain version, a cuBLAS yardstick and its
                bound (fused_transform again with R at s = 3, ternary_matmul
                at s = 3 and 1; both at each sparse tile template;
                easi_apply at each column template at EASI_TILE_SHAPES),
                and its launches per call counted around one call at the
                wide shape and one at the paper block
  5. serve    — the serving engine (`repro_torch.serve.DRService`) with the
                wide model and the kernel backend in the reference's default
                buckets (8 … 1024): `register` races the tile templates and
                captures one CUDA graph per bucket (launches counted per
                captured program, the body each reaches); a ragged stream of
                requests through submit + flush, each answer bit-identical to
                the eager kernel call on the padded bucket under the tiles
                its bucket won and within OUT_TOL of the torch backend;
                promote / rollback with no rebuild; train-while-serve (the
                paper model's 5000 blocks of a 40-epoch fit and 8 wide blocks,
                then promote, against `fit` on the torch backend); a threaded
                DeadlineScheduler with four clients while a fifth thread
                registers a second model; stand-in latency and rate numbers
  5a. autotune — the tile race at register: the wide model (B1) and an
                RP-only model of the wide width (B3) at buckets 8 … 1024 on a
                real clock; per bucket the candidates, their times and the
                winner, each candidate within OUT_TOL of the plain version,
                the captured winner bit-identical to the eager call under its
                tiles, a second host on a real clock with the same winners
                and bits; register seconds with one candidate and with the
                race (candidates timed on the card's clock)
  5b. fleet   — the wide model on three DRService hosts in one process (one
                LocalBus, one VirtualClock; each a durable ReplicatedRegistry
                under build/chip_smoke_fleet/, removed after, a pumped Elector
                and a FleetMerger): register on the leader, each host serves a
                third of the ragged requests (followers bit-identical to the
                leader, every installed state on the card); train-while-serve
                on disjoint shards, one merge round at ratio 1 (steps exact),
                then 8 at the default CompressConfig, the sketch on
                ternary_matmul held to its plain version, every round's B to a
                torch-backend fleet's; failover (the old leader fenced); crash,
                promote while down, restart from the data_dir (hash equal,
                re-captured launches); round times and what they spend on
                fsync, R draws and decodes, wire bytes, the sketch's times
  5c. fleet-tcp — a leader and two followers as three fresh processes on the
                card over TCPTransport: join, sync, one two-phase promote; each
                child checks its states, launches and answers
  6. flash    — the flash-attention kernels (bf16: tensor cores; f32: FMA)
                against their plain version, out and lse (the reference tests' shapes,
                Dh 72 / 120 / 128 and one not a multiple of 8, GQA groups
                1 / 4 / 8, windows that hide whole 64-key tiles, q_offset
                with Sq = 1, Skv not a multiple of 64; f32 and bf16; rows
                that see no key are 0, their lse about -1e30); the bf16
                kernel at Dh 224 with Zamba2's scale (Dh / 2)^-1/2 at
                (1, 4096, 32/32) and a ragged length, out, each (batch,
                head) within FLASH_REL_NORM and lse, timed at 4096 beside
                its plain version, SDPA and its bound; and
                FlashAttentionFn's dq, dk, dv with the kernel's forward
                (and, in bf16, the kernel backward) against the all-plain
                ones; the backward kernel timed at hubert-xlarge's and
                h2o's training shapes beside its plain version, SDPA's
                backward and its bound
  7. lm       — h2o-danube-3-4b at full width and depth (24 layers, seeded
                random weights) served through `serve_step.make_prefill` /
                `make_decode` with the kernel backend: request A (4 prompts
                of 1024 tokens, 16 greedy decode steps) and request B (one
                prompt of 4608 tokens, past the 4096 window, 4 decode
                steps); the same requests on the torch backend, teacher-
                forced with the kernel run's tokens, are the reference; then
                the kernel timed at request A's prefill shape beside its
                plain version, scaled_dot_product_attention and its bound,
                and at request B's (1 x 4608, window 4096); at both, the
                relative norm of kernel − plain over each (batch, head)
  8. lm-queue — request A again, through a `DRService`'s admission queue:
                the threaded `DeadlineScheduler`'s `lm_prefill`, then 4
                `lm_decode` steps; logits equal to the direct run's bit for
                bit, two builds in the service's LRU, SLO kinds prefill and
                decode
     kv-rp    — the same weights with the RP-compressed KV cache (kv_rp=2,
                keys 120 -> 60): request A with 16 teacher-forced decode
                steps; K cache half as wide (0.75 of the bytes), every row's
                logits rank-correlated above 0.8 with the exact run's, kernel
                vs torch backend within the LM bounds
     flash-time — the flash kernel timed at request A's shape and, beside
                its plain version, SDPA and its bound, at the four head
                geometries of the phases below
  9. moe      — phi3.5-moe-42b-a6.6b at full width, 8 of its 32 layers:
                request A (capacity 640 a expert at prefill, 8 at decode),
                16 decode steps, kernel vs torch backend teacher-forced; the
                share of expert choices that agree, by layer, and the
                choices dropped at capacity
 10. frontend — hubert-xlarge and internvl2-1b CONFIG_DR at full width and
                depth: raw frames / patches through the paper's RP→EASI DR
                front-end (init, one update on 4096 normalised rows, the
                transform: ternary_matmul, easi_apply, fused_transform), then
                prefill (hubert non-causal, Dh 80; internvl2 GQA 7, Dh 64) and
                16 decode steps for internvl2; kernel vs torch backend
 11. rwkv6    — rwkv6-1.6b at full width and depth (24 layers, 1.58 B f32
                params drawn on the card), request A with 16 decode steps
                forced with drawn tokens: no kernel on the path (every
                counter 0), kernel and torch backends bit-identical, decode
                after 1024 tokens against a prefill of 1040 within the LM
                bounds; state bytes, host-paced and device-only step times
 12. zamba    — zamba2-7b at full width and depth (81 Mamba-2 layers, the
                shared attention block at 14 of them, 6.9 B f32 params):
                request A, kernel vs torch backend within the LM bounds on
                the logits and each cache leaf, flash exactly 14 times a
                prefill (32/32 heads, Dh 112) and never in decode; in f32 on
                the torch backend, the SSD block form (prefill 1024) against
                the step form (prefill 960 + 64 decode steps) within
                ZAMBA_BLOCK_STEP_REL_NORM; cache bytes, step times, idle
                share, peak memory
     zamba-published — Zamba2-7B-Instruct at its published layout
                (`configs/zamba2_7b.PUBLISHED`: 2 SSD groups, 2 shared
                blocks at 13 layers, Dh 224, adapters; 7.36 B f32 params):
                one 4096-token prompt through `api.prefill`, kernel vs
                torch backend in bf16 within ZAMBA_PUB_REL_NORM on the
                logits and each cache leaf, both beside the torch backend
                in f32; flash exactly 13 times on the kernel path (counted
                from zero) and never on the torch path
 13. train-lm — h2o-danube-3-4b at full width, 8 of its 24 layers, 2 x 4096
                tokens from the synthetic stream: loss and every gradient
                leaf, kernel backend (B4 forward with lse, the backward
                kernel) against the torch backend from one seeded state
                within LM_REL_NORM; three steps of `make_train_step`,
                flash counted twice a layer a step (forward, remat) and its
                backward twice (two passes)
 14. train-dr — hubert-xlarge CONFIG_DR at full width and depth, 2 x 1024
                frames: the same comparison, then two train steps a backend
                with the DR unit co-trained (B within TRAJ_TOL after each);
                all four kernels launched on the training path
 15. train-recurrent — rwkv6-1.6b (4 of 24 layers, 2 x 256) bit-identical
                between backends with no launch; zamba2-7b (12 of 81, 2 x
                512, two shared-block applications) within the LM bounds;
                each with train_grad_accum 2
 16. trainer  — smollm-135m at full width and depth: `trainer.train` for 8
                steps with checkpoints every 4, then stopped at 4 and resumed
                into a fresh state; the loss falls, the restored state and
                the resumed run equal the straight run bit for bit
 17. train-time — per step (h2o, hubert): host-paced and device-busy ms,
                idle share, tokens/s, model TFLOP/s, peak memory; one
                attention layer at h2o's shape: B4 forward + lse, the plain
                backward, SDPA forward + backward, each beside its bound
 18. mesh     — the mesh path on a one-rank NCCL mesh (`make_smoke_mesh`):
                `DRService(mesh=)` over [serve]'s ragged requests and
                `dr_transform` at 13 / 16 rows bit-identical to the unmeshed
                service; the paper model as an ensemble of 4 (each member
                bit-identical to its solo run, within TRAJ_TOL of the torch
                backend) and served with `register(..., ensemble=4)`;
                h2o request A through `lm_prefill` / `lm_decode` with the
                mesh against the unmeshed run; one meshed [train-lm] step
                against an unmeshed one; smollm-135m through
                `make_dp_compressed_step` (its sync re-run with B3 and with
                the plain sketch, every synced leaf within 1e-5; synced +
                new carry = gradient + old carry); meshed / unmeshed
                host-paced times
 19. dryrun   — `launch/dryrun.py`: h2o at train-lm's cut on a one-rank
                mesh built on fake CUDA tensors, its predicted peak within
                10% of max_memory_allocated over the same step run for real,
                its counted FLOPs at least 6·N·tokens; then the production
                (16, 16) mesh's records for h2o train_4k and decode_32k,
                the layers split over `model`, with their collective wire
                bytes by kind and axis

It prints a `{"kernels": [...]}` JSON line, the card's line from nvidia-smi,
and as its last line `{"ok": true, "device": {...}}`.  `--only fleet,fleet-tcp`
(or `kernels`, `resources`, `wide`, `serve`, `autotune`, `flash`, `zamba-published`, `mesh`,
`dryrun`) runs
the card phase and the named phases alone and prints no contract line.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores, bf16 on the
# tensor cores, and HBM rate
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
EASI_TOL = dict(rtol=2e-5, atol=2e-6)          # tests/test_kernels.py:107
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)          # tests/test_kernels.py:162
OUT_TOL = dict(rtol=1e-4, atol=1e-4)           # tests/test_fused_transform.py:174

TMM_SHAPES = [(1, 32, 24), (8, 32, 16), (37, 100, 9), (128, 256, 128), (256, 555, 77),
              (64, 1024, 256), (40, 300, 48)]
FUSED_SHAPES = [(8, 32, 16, 8), (13, 32, 16, 8), (64, 33, 17, 9), (200, 100, 40, 10),
                (5, 7, 3, 2), (1, 32, 16, 8), (40, 300, 48, 12)]
# (rows, m, p, n, s, zero_rows): R of density 1/s (None: s = p) down to s = 1,
# every third row of R zero, rows not a multiple of the kernel's 32-row tile,
# n > 128, ragged m and p, m past 1024 columns.  The bodies: R of fewer than
# 65536 entries takes the dense body, a larger one the sparse body, with p
# split over CTAs (a second launch sums the partials) unless the row tiles
# alone fill the card (8500 rows).  In the sparse body, B slices too large
# to be held whole in shared memory (8500, 1100, 60, 200) and (40, 1100, 60,
# 600), or just past one thread's preload (33, 2048, 32, 520).
FUSED_EDGE = [(256, 1024, 256, 128, 1, False), (256, 1024, 256, 128, 3, False),
              (77, 1000, 130, 200, None, True), (77, 1000, 130, 200, 1, False),
              (300, 2100, 70, 150, 3, False), (1000, 32, 24, 16, 1, True),
              (45, 100, 40, 10, 3, True), (40, 100, 60, 200, 1, False),
              (33, 64, 32, 129, 3, False), (8500, 1100, 60, 200, 3, True),
              (40, 1100, 60, 600, 3, False), (33, 2048, 32, 520, 3, False)]
EASI_SHAPES = [(1, 8, 32), (32, 16, 32), (8, 24, 24), (64, 7, 100), (128, 128, 512),
               (16, 100, 300)]
# (b, n, m) for easi_apply's column templates: the paper row, the reference's
# tiling test (tests/test_kernels.py:117) and the wide row
EASI_TILE_SHAPES = [(32, 16, 24), (64, 32, 1000), (256, 128, 256)]
SO_HO = [(True, True), (True, False), (False, True)]
# (rows, m, p, s, zero_rows) for ternary_matmul's two bodies: the wide row at
# densities 1/p, 1/3 and 1, ragged shapes with every third row of R zero,
# many row tiles, a single row, R exactly at the sparse body's 65536 entries,
# and two shapes on the dense side
TMM_EDGE = [(256, 1024, 256, None, False), (256, 1024, 256, 3, False),
            (256, 1024, 256, 1, False), (77, 1000, 130, None, True), (8500, 1100, 60, 3, False),
            (1, 1024, 256, None, False), (33, 2048, 32, None, False), (300, 2100, 70, 3, False),
            (256, 555, 77, None, False), (4000, 32, 24, None, False)]
# (b, n, m, so, ho, g, zeros in Y, dtype) for easi_apply's two bodies: the wide
# row under each (so, ho), a single sample, ragged shapes with each g, long
# blocks, n at the small body's edge (64) and just past it (65), bf16 on both
EASI_EDGE = ([(256, 128, 256, so, ho, "cubic", False, "f32") for so, ho in SO_HO]
             + [(1, 128, 256, True, True, "cubic", False, "f32"),
                (300, 100, 77, True, True, "tanh", False, "f32"),
                (33, 200, 300, True, True, "sign_cubic", True, "f32"),
                (4000, 16, 24, False, True, "cubic", False, "f32"),
                (32, 16, 24, False, True, "cubic", False, "f32"),
                (32, 64, 100, True, True, "cubic", False, "f32"),
                (32, 65, 100, True, True, "cubic", False, "f32"),
                (32, 16, 48, True, True, "cubic", False, "bf16"),
                (256, 128, 256, False, True, "cubic", False, "bf16")])

WIDE = dict(m=1024, p=256, n=128, block=256)    # benchmarks/throughput.py:41
PAPER = dict(m=32, p=24, n=16, block=32, mu=2e-4, epochs=40)  # configs/waveform_paper.py
# Table I on Waveform-V2 at the protocol's full epochs: the accuracy floors of
# tests/test_waveform_repro.py:49-71, the kernel and torch backends' accuracies
# at most one point apart, and the paper's claim |Δ(n=16)| < 0.08
TABLE1_FLOORS = {"easi_n16": 0.74, "rp24_easi_n16": 0.72, "easi_n8": 0.62,
                 "rp16_easi_n8": 0.65}
TABLE1_ACC_GAP = 0.01
TABLE1_CLAIM = 0.08
# Table II is arithmetic: the ratios of EXPERIMENTS.md §Reference numbers
TABLE2_WANT = {"table2/mac_ratio_paper_row": "ratio=1.94",
               "table2/weight_bytes_ratio": "ratio=2.00",
               "table2/scaling_p24": "mac_ratio=1.34", "table2/scaling_p16": "mac_ratio=1.94",
               "table2/scaling_p8": "mac_ratio=3.53"}
ICA_AMARI_TOL = 1e-3

FLASH_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),  # tests/test_flash_kernel.py:37
             "bf16": dict(rtol=2e-2, atol=2e-2)}
# bf16 at the LM's shapes, beside the elementwise check: the relative norm of
# kernel − plain over each (batch, head).  Late rows of a long causal window
# average thousands of keys, so |out| there is about the size of the
# elementwise tolerance, which could not tell a kernel that drops keys from a
# correct one.  On an H100 the reading was 1.4e-3 at request A's shape and
# 1.6e-3 at B's, where the plain bf16 version is 2.1e-3 from itself in f32 on
# the same inputs (both are printed); the bound is about three times the
# reading.
FLASH_REL_NORM = 5e-3
# (b, sq, skv, hq, hkv, dh, causal, window): tests/test_flash_kernel.py:11-18,
# tests/test_blocks.py:31-38, then the LM's own heads (dh 120, GQA 4)
FLASH_SHAPES = [
    (1, 128, 128, 4, 2, 64, True, None), (2, 96, 96, 4, 4, 32, True, None),
    (1, 256, 256, 8, 2, 128, True, 64), (2, 64, 64, 9, 3, 64, False, None),
    (1, 1, 160, 4, 1, 64, True, None),
    (2, 64, 64, 4, 2, 16, True, None), (1, 100, 100, 6, 2, 8, True, None),
    (3, 48, 48, 4, 4, 16, False, None), (2, 96, 96, 8, 2, 16, True, 24),
    (2, 32, 32, 9, 3, 8, True, None), (1, 80, 80, 4, 1, 32, True, 16),
    (1, 70, 133, 8, 2, 120, True, 48), (2, 333, 333, 32, 8, 120, True, None),
    (1, 1, 4099, 32, 8, 120, True, 4096), (1, 600, 5001, 32, 8, 120, True, 4096),
    # Dh 72 and 128 with windows that hide whole 64-key tiles, GQA 8 and 1;
    # Sq = 1 and Sq = 7 at a q_offset; a Dh that is not a multiple of 8
    (1, 300, 300, 8, 1, 72, True, 100), (2, 517, 517, 8, 8, 128, True, 70),
    (1, 200, 200, 8, 8, 72, False, None), (1, 7, 999, 16, 2, 120, True, 130),
    (1, 1, 777, 8, 1, 128, True, 64), (1, 129, 190, 4, 4, 13, True, None),
    # the head geometries of the later LM phases: phi3.5-moe (Dh 128, GQA 4),
    # hubert-xlarge (Dh 80, non-causal, no GQA), internvl2-1b (Dh 64, GQA 7)
    (2, 300, 300, 32, 8, 128, True, None), (2, 333, 333, 16, 16, 80, False, None),
    (1, 190, 190, 16, 16, 80, True, None), (2, 290, 290, 14, 2, 64, True, None),
    (1, 77, 211, 14, 2, 64, False, None),
]
# B4 at Zamba2-7B-Instruct's shared attention (configs/zamba2_7b.PUBLISHED):
# 32/32 heads of Dh 224, causal, scores scaled by (224 / 2)^-1/2; the
# benchmark cell's prefill (1 x 4096) and a ragged length, bf16 only (the f32
# kernel stops at Dh 128).  Its lse is held as tests/test_torch_flash_d224.py
# holds it.
FLASH_D224 = [(1, 4096, 32, 32, 224), (1, 1000, 32, 32, 224)]
FLASH_D224_SCALE = 1.0 / math.sqrt(112)
FLASH_D224_LSE_ATOL = 2e-2
# h2o-danube-3-4b (src/repro/configs/h2o_danube3_4b.py): request A and B
LM_ARCH = "h2o_danube3_4b"
LM_REQUESTS = {"A": dict(batch=4, prompt=1024, decode=16, cache=1040),
               "B": dict(batch=1, prompt=4608, decode=4, cache=4612)}
# kernel backend against torch backend on the LM's logits, bf16 over 24 layers:
# the two backends differ only in attention's f32 summation order, which flips
# the last bit of some bf16 outputs; each flip is carried through the residual
# stream of the later layers.  The reference's own bf16 bound, 2e-2
# (tests/test_arch_smoke.py:101), is held on the norm of each logits row, and
# every single logit within 0.125 = 16 bf16 ulps at |logit| ~ 1.
LM_REL_NORM = 2e-2
LM_MAX_ABS = 0.125
# request A through DRService's queue: decode steps, and the scheduler's budget
LMQ_DECODE = 4
LMQ_DELAY_MS = 2.0
# the RP-compressed KV cache on h2o-danube-3-4b (Dh 120 -> 60), held to
# tests/test_kv_rp.py:41's rank-correlation bound against the exact cache
KV_RP = 2
KV_RP_RANK_CORR = 0.8
# phi3.5-moe-42b-a6.6b (src/repro/configs/phi35_moe.py) at full width, cut to
# 8 of its 32 layers: its f32 experts take 16 x 3 x 4096 x 6400 x 4 B = 5.03 GB
# a layer, so 8 layers and the embeddings come to about 42 GB of the 80
MOE_ARCH = "phi35_moe"
MOE_LAYERS = 8
# hubert-xlarge and internvl2-1b CONFIG_DR (src/repro/configs/{hubert_xlarge,
# internvl2_1b}.py): 4 samples of 1024 positions (internvl2: 256 patches, then
# 768 tokens), 16 decode steps for the decoder
FRONTEND_BATCH = 4
FRONTEND_SEQ = 1024
FRONTEND_DECODE = 16
# the recurrent families at full width and depth, request A: rwkv6-1.6b
# (src/repro/configs/rwkv6_1b6.py) and zamba2-7b (src/repro/configs/zamba2_7b.py)
RWKV_ARCH = "rwkv6_1b6"
ZAMBA_ARCH = "zamba2_7b"
# zamba2-7b in f32 on the torch backend: a prefill of 960 tokens (SSD block
# form) and 64 teacher-forced decode steps (step form) against a prefill of
# all 1024 (block form), on the last logits' relative row norm.  The bound
# was set before the first measurement (PERF.md §6); tests/test_ssd_block.py
# holds one block at 2e-4 elementwise, and this holds 81 of them and the
# shared block's ring.
ZAMBA_SPLIT = 960
ZAMBA_BLOCK_STEP_REL_NORM = 1e-3
# Zamba2-7B-Instruct at its published layout: one prompt of the benchmark
# cell's 4096 tokens through `api.prefill`, kernel against torch backend in
# bf16 (they differ in attention's summation order, carried through 81
# layers), both beside the torch backend in f32.  The bound is the cell's own
# logits limit (portbench/limits/zamba2-7b.prefill-4k.json, bf16 program
# against the f32 reference), held on the logits and on each cache leaf; it
# was set before the first reading here.
ZAMBA_PUB_PROMPT = 4096
ZAMBA_PUB_REL_NORM = 5e-2
# B4's lse output against the plain version's (f32 in both dtypes; the bf16
# kernel sums its scores on the tensor cores and takes exp on the SFU), and
# FlashAttentionFn's gradients with the kernel's forward against the
# all-plain ones (they differ only through out and lse): f32 elementwise,
# bf16 by the relative norm of each of dq, dk, dv.  Fixed in PERF.md §6
# before the first run.
LSE_TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=1e-4, atol=1e-4)}
FLASH_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_GRAD_REL_NORM = 1e-2
FLASH_GRAD_SHAPES = [(2, 333, 333, 32, 8, 120, True, None), (1, 600, 5001, 32, 8, 120, True, 4096),
                     (2, 333, 333, 16, 16, 80, False, None), (1, 129, 190, 4, 4, 13, True, None)]
# the attention backward timed at the training shapes: hubert-xlarge's train
# cell (8 x 1024, 16 / 16 heads of 80, non-causal) and train-lm's h2o layer
# (2 x 4096, 32 / 8 heads of 120, causal, its window of 4096 hiding nothing):
# (b, s, hq, hkv, dh, causal, window)
FLASH_BWD_TIMING = {"hubert-xlarge": (8, 1024, 16, 16, 80, False, None),
                    "h2o-danube-3-4b": (2, 4096, 32, 8, 120, True, 4096)}
# LM training.  train-lm: h2o-danube-3-4b at full width, 8 of its 24 layers
# (1.484 B f32 params; params + grads + AdamW m and v take 23.7 GB), 2 x 4096
# tokens from the synthetic stream.  train-dr: hubert-xlarge CONFIG_DR at full
# width and depth, 2 x 1024 frames of 512 features.  train-recurrent: rwkv6-1.6b
# at 4 of 24 layers (2 x 256 tokens, four WKV chunks) and zamba2-7b at 12 of 81
# (2 x 512, two applications of the shared block), each with its own
# train_grad_accum.  trainer: smollm-135m at full width and depth.  Between the
# kernel and torch backends the loss and the whole gradient (every leaf at
# once) are held to LM_REL_NORM in relative norm, and each gradient leaf to
# GRAD_LEAF_REL_NORM: a per-head scalar such as Mamba-2's a_log sums thousands
# of cancelling terms, so attention's last-bit differences in bf16 move it
# more (2.1e-2 in a CPU rehearsal of zamba's 12 layers at SMOKE width, where
# the two backends differ only in their chunking), as they move the CPU tests'
# bf16 gradient leaves against the reference (tests/test_torch_train.py).
GRAD_LEAF_REL_NORM = 5e-2
TRAIN_LM = dict(layers=8, batch=2, seq=4096, steps=3)
TRAIN_DR = dict(batch=2, seq=1024, steps=2)
TRAIN_RWKV = dict(layers=4, batch=2, seq=256)
TRAIN_ZAMBA = dict(layers=12, batch=2, seq=512)
TRAINER = dict(arch="smollm_135m", steps=8, ckpt_every=4, batch=8, seq=512, lr=2e-4)
# the head geometries flash first runs at in those phases: (Hq, Hkv, Dh, causal)
FLASH_GEOMETRIES = {"phi3.5-moe": (32, 8, 128, True), "hubert-xlarge": (16, 16, 80, False),
                    "internvl2-1b": (14, 2, 64, True), "zamba2-7b": (32, 32, 112, True)}


class SmokeFailure(Exception):
    pass


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def max_err(got, want) -> float:
    import torch

    return float((got.to(torch.float32) - want.to(torch.float32)).abs().max()) \
        if got.numel() else 0.0


def check_close(what: str, got, want, *, rtol: float, atol: float) -> float:
    """assert_allclose semantics on the card; returns the largest |got − want|."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite values")
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} of {g.numel()} elements outside rtol={rtol} "
             f"atol={atol}; max |err| {max_err(g, w):.3e}")
    return max_err(g, w)


def head_rel_norm(got, want) -> float:
    """Largest relative norm of got − want over the (batch, head) slices of
    (B, S, H, Dh) outputs."""
    import torch

    g, w = got.to(torch.float32), want.to(torch.float32)
    return float(((g - w).norm(dim=(1, 3)) / w.norm(dim=(1, 3))).max())


def check_flash_norm(what: str, got, want, want_f32) -> dict:
    """Fails when a (batch, head) of the bf16 kernel's output is further than
    FLASH_REL_NORM from the plain version; returns that reading beside the
    plain bf16 version's own distance from the plain version in f32."""
    rel = head_rel_norm(got, want)
    floor = head_rel_norm(want, want_f32)
    if not rel <= FLASH_REL_NORM:
        fail(f"{what}: relative norm over a (batch, head) {rel:.3e} (bound {FLASH_REL_NORM}; "
             f"plain bf16 against plain f32 {floor:.3e})")
    return {"rel_norm": rel, "rel_norm_to_f32": head_rel_norm(got, want_f32),
            "plain_bf16_rel_norm_to_f32": floor}


def time_events(fn, iters: int = 200, warmup: int = 20) -> float:
    """ms per call of back-to-back calls, CUDA events around the loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, iters: int = 100, replays: int = 10) -> float:
    """ms per call on the device alone: `iters` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events (no host launch cost)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def time_queued(fn, iters: int = 50, warmup: int = 10):
    """ms per call on the device alone of `iters` back-to-back calls made as a
    caller makes them (host code, copies, replays): a spin kernel holds the
    device while the host queues the calls, so the CUDA events around them see
    every device op of the calls and no host gap.  None when the host was
    still queueing as the spin ended, even at the longest spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = 10 ** 8
    for _ in range(3):
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t_host = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if t_host < spin.elapsed_time(start):
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 1: card, versions, build
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card_line}")
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.library(verbose=True)
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc: {_build.nvcc_path()})")
    return card_line


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(dev, errs):
    import torch
    from repro_torch.core import random_projection as rp
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    gen = torch.Generator().manual_seed(1234)

    def normal(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    def ternary(p, m):
        return rp.sample_ternary(gen, rp.RPConfig(m=m, p=p)).to(dev)

    def note(name, dtype, err):
        key = (name, "f32" if dtype == torch.float32 else "bf16")
        errs[key] = max(errs.get(key, 0.0), err)

    n_checks = 0
    tmm = ternary_matmul.ternary_matmul
    for (b, m, p) in TMM_SHAPES + [(WIDE["block"], WIDE["m"], WIDE["p"]), (4000, 32, 24)]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, r = normal(b, m, dtype=dtype), ternary(p, m)
            got = tmm(x, r, scale=0.37)
            want = ternary_matmul.plain(x, r, scale=0.37)
            note("ternary_matmul", dtype, check_close(
                f"ternary_matmul b={b} m={m} p={p} {dtype}", got, want, **tol))
            n_checks += 1
    xi = torch.randint(-8, 8, (16, 64), generator=gen).to(torch.float32).to(dev)
    ri = ternary(32, 64)
    if not torch.equal(tmm(xi, ri), ternary_matmul.plain(xi, ri)):
        fail("ternary_matmul: integer inputs are not exact")
    n_checks += 1
    bodies = set()
    for (b, m, p, s, zero_rows) in TMM_EDGE:
        tiles = ternary_matmul.plan(b, m, p)
        bodies.add("dense" if tiles == 0 else "sparse")
        cfg = rp.RPConfig(m=m, p=p, sparsity=s)      # scale sqrt(s/m), as the model's
        r = rp.sample_ternary(gen, cfg, ensure_nonzero_rows=not zero_rows)
        if zero_rows:
            r[::3] = 0
        r = r.to(dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = normal(b, m, dtype=dtype)
            got = tmm(x, r, scale=cfg.scale)
            note("ternary_matmul", dtype, check_close(
                f"ternary_matmul b={b} m={m} p={p} s={cfg.s} zero_rows={zero_rows} tiles={tiles} "
                f"{dtype}", got, ternary_matmul.plain(x, r, scale=cfg.scale), **tol))
            if not torch.equal(got, tmm(x, r, scale=cfg.scale)):
                fail(f"ternary_matmul b={b} m={m} p={p} s={cfg.s} {dtype}: two calls differ")
            n_checks += 1
    if bodies != {"dense", "sparse"}:
        fail(f"ternary_matmul: the edge cases reach only {sorted(bodies)}")
    for (b, m, p, s, zero_rows) in TMM_EDGE:     # every tile template of the sparse body
        if ternary_matmul.plan(b, m, p) == 0:
            continue
        cfg = rp.RPConfig(m=m, p=p, sparsity=s)
        r = rp.sample_ternary(gen, cfg, ensure_nonzero_rows=not zero_rows)
        if zero_rows:
            r[::3] = 0
        r = r.to(dev)
        x = normal(b, m)
        want = ternary_matmul.plain(x, r, scale=cfg.scale)
        for bm, bp in tile_points():
            kw = dict(scale=cfg.scale, block_m=bm, block_p=bp)
            got = tmm(x, r, **kw)
            note("ternary_matmul", torch.float32, check_close(
                f"ternary_matmul b={b} m={m} p={p} s={cfg.s} tiles ({bm}, {bp}) "
                f"plan={ternary_matmul.plan(b, m, p, bm, bp)}", got, want, **F32_TOL))
            if not torch.equal(got, tmm(x, r, **kw)):
                fail(f"ternary_matmul b={b} m={m} p={p} tiles ({bm}, {bp}): two calls differ")
            n_checks += 1
    for s in (1, 3, None):                         # integers stay exact at every density
        r = rp.sample_ternary(gen, rp.RPConfig(m=WIDE["m"], p=WIDE["p"], sparsity=s)).to(dev)
        xi = torch.randint(-8, 8, (WIDE["block"], WIDE["m"]), generator=gen).to(torch.float32)
        xi = xi.to(dev)
        if not torch.equal(tmm(xi, r), ternary_matmul.plain(xi, r)):
            fail(f"ternary_matmul: integer inputs are not exact at the wide shape, s={s}")
        n_checks += 1

    ft = fused_transform.fused_transform
    for (rows, m, p, n) in FUSED_SHAPES + [(WIDE["block"], WIDE["m"], WIDE["p"], WIDE["n"]),
                                           (1000, 32, 24, 16)]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, r, bm = normal(rows, m, dtype=dtype), ternary(p, m), normal(n, p, dtype=dtype)
            got = ft(x, r, bm, scale=0.37)
            want = fused_transform.plain(x, r, bm, scale=0.37)
            note("fused_transform", dtype, check_close(
                f"fused_transform rows={rows} m={m} p={p} n={n} {dtype}", got, want, **tol))
            n_checks += 1
    xi = torch.randint(-8, 8, (16, 64), generator=gen).to(torch.float32).to(dev)
    bi = torch.randint(-4, 4, (8, 32), generator=gen).to(torch.float32).to(dev)
    if not torch.equal(ft(xi, ri, bi), fused_transform.plain(xi, ri, bi)):
        fail("fused_transform: integer inputs are not exact")
    n_checks += 1
    bodies = set()
    for (rows, m, p, n, s, zero_rows) in FUSED_EDGE:
        tiles = fused_transform.tiles(rows, m, p)
        bodies.add("dense" if tiles == 0 else "sparse, one p tile" if tiles == 1
                   else "sparse, p split")
        cfg = rp.RPConfig(m=m, p=p, sparsity=s)      # scale sqrt(s/m), as the model's
        r = rp.sample_ternary(gen, cfg, ensure_nonzero_rows=not zero_rows)
        if zero_rows:
            r[::3] = 0
        r = r.to(dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, bm = normal(rows, m, dtype=dtype), normal(n, p, dtype=dtype, scale=p ** -0.5)
            got = ft(x, r, bm, scale=cfg.scale)
            want = fused_transform.plain(x, r, bm, scale=cfg.scale)
            note("fused_transform", dtype, check_close(
                f"fused_transform rows={rows} m={m} p={p} n={n} s={cfg.s} zero_rows={zero_rows} "
                f"tiles={tiles} {dtype}", got, want, **tol))
            n_checks += 1
    for (rows, m, p, n, s, zero_rows) in FUSED_EDGE:   # every tile template of the sparse body
        if fused_transform.tiles(rows, m, p) == 0:
            continue
        cfg = rp.RPConfig(m=m, p=p, sparsity=s)
        r = rp.sample_ternary(gen, cfg, ensure_nonzero_rows=not zero_rows)
        if zero_rows:
            r[::3] = 0
        r = r.to(dev)
        x, bm_ = normal(rows, m), normal(n, p, scale=p ** -0.5)
        want = fused_transform.plain(x, r, bm_, scale=cfg.scale)
        for bm, bp in tile_points():
            kw = dict(scale=cfg.scale, block_m=bm, block_p=bp)
            tiles = fused_transform.tiles(rows, m, p, bm, bp)
            bodies.add("sparse, one p tile" if tiles == 1 else "sparse, p split")
            got = ft(x, r, bm_, **kw)
            note("fused_transform", torch.float32, check_close(
                f"fused_transform rows={rows} m={m} p={p} n={n} s={cfg.s} tiles ({bm}, {bp}) "
                f"p tiles={tiles}", got, want, **F32_TOL))
            if not torch.equal(got, ft(x, r, bm_, **kw)):
                fail(f"fused_transform rows={rows} m={m} p={p} tiles ({bm}, {bp}): two calls "
                     f"differ")
            n_checks += 1
    if len(bodies) != 3:
        fail(f"fused_transform: the edge cases reach only {sorted(bodies)}")
    for s in (1, 3, None):                         # integers stay exact at every density
        r = rp.sample_ternary(gen, rp.RPConfig(m=WIDE["m"], p=WIDE["p"], sparsity=s)).to(dev)
        xi = torch.randint(-8, 8, (WIDE["block"], WIDE["m"]), generator=gen).to(torch.float32)
        bi = torch.randint(-4, 4, (WIDE["n"], WIDE["p"]), generator=gen).to(torch.float32)
        xi, bi = xi.to(dev), bi.to(dev)
        if not torch.equal(ft(xi, r, bi), fused_transform.plain(xi, r, bi)):
            fail(f"fused_transform: integer inputs are not exact at the wide shape, s={s}")
        n_checks += 1

    ea = easi_update.easi_apply
    cases = [(b, n, m, so, ho, "cubic", 1e-3, 0.3) for (b, n, m) in EASI_SHAPES
             for (so, ho) in SO_HO]
    cases += [(32, 16, 48, True, True, g, 5e-4, 0.2) for g in ("cubic", "tanh", "sign_cubic")]
    cases += [(WIDE["block"], WIDE["n"], WIDE["p"], False, True, "cubic", 2e-4, 0.3),
              (PAPER["block"], PAPER["n"], PAPER["p"], False, True, "cubic", 2e-4, 0.3)]
    for (b, n, m, so, ho, g, mu, s) in cases:
        bm, y = normal(n, m, scale=s), normal(b, n)
        kw = dict(mu=mu, second_order=so, higher_order=ho, g_name=g)
        note("easi_apply", torch.float32, check_close(
            f"easi_apply b={b} n={n} m={m} so={so} ho={ho} g={g}",
            ea(bm, y, **kw), easi_update.plain(bm, y, **kw), **EASI_TOL))
        n_checks += 1
    # sign_cubic at y = 0 must contribute 0, as jnp.sign does
    y0 = normal(8, 16)
    y0[:, :4] = 0.0
    bm = normal(16, 40, scale=0.2)
    kw = dict(mu=1e-3, g_name="sign_cubic")
    check_close("easi_apply sign_cubic with zeros", ea(bm, y0, **kw),
                easi_update.plain(bm, y0, **kw), **EASI_TOL)
    bm, y = normal(16, 48, dtype=torch.bfloat16, scale=0.2), normal(32, 16, dtype=torch.bfloat16)
    note("easi_apply", torch.bfloat16, check_close(
        "easi_apply bf16", ea(bm, y, mu=5e-4), easi_update.plain(bm, y, mu=5e-4), **BF16_TOL))
    n_checks += 2
    bodies = set()
    for (b, n, m, so, ho, g, zeros, dt) in EASI_EDGE:
        slices, _, _ = easi_update.plan(b, n, m, so, ho)
        bodies.add("small" if slices == 0 else "split")
        dtype, tol = ((torch.float32, EASI_TOL) if dt == "f32" else (torch.bfloat16, BF16_TOL))
        bm, y = normal(n, m, dtype=dtype, scale=0.3), normal(b, n, dtype=dtype)
        if zeros:
            y[:, ::5] = 0.0
        kw = dict(mu=1e-3, second_order=so, higher_order=ho, g_name=g)
        got = ea(bm, y, **kw)
        note("easi_apply", dtype, check_close(
            f"easi_apply b={b} n={n} m={m} so={so} ho={ho} g={g} zeros={zeros} slices={slices} "
            f"{dtype}", got, easi_update.plain(bm, y, **kw), **tol))
        if not torch.equal(got, ea(bm, y, **kw)):
            fail(f"easi_apply b={b} n={n} m={m} so={so} ho={ho} {dtype}: two calls differ")
        n_checks += 1
    if bodies != {"small", "split"}:
        fail(f"easi_apply: the edge cases reach only {sorted(bodies)}")
    n_checks += easi_tile_checks(dev, normal, note)
    torch.cuda.synchronize()
    print(f"[kernels] {n_checks} checks against the plain versions passed; largest |err|: "
          + ", ".join(f"{k[0]}/{k[1]} {v:.3e}" for k, v in sorted(errs.items())))


# ---------------------------------------------------------------------------
# phase 3: the paper's model, trained and served through the kernels
# ---------------------------------------------------------------------------

def easi_split_slices(b, n):
    """The split body's sample slices for y (b, n) on this card, as
    `repro_easi_apply_plan` gives them where it takes that body."""
    import torch

    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    split = min(8, -(-sms // (-(-n // 32)) ** 2), -(-b // 32))
    return -(-b // -(-b // max(split, 1)))


def easi_entry(y, bmat, *, slices, cols, mu=1e-3, so=True, ho=True):
    """A closure that runs easi_apply's C entry into a new output with the
    body (`slices`, 0 for the small one) and column template `cols` forced,
    as the wrapper would with that plan; it returns the output.  Calls made
    here bump no launch count."""
    import torch
    from repro_torch.kernels import _build

    b, n = y.shape
    m = bmat.shape[1]
    out = torch.empty_like(bmat)
    scratch = torch.empty((2 * n * n,), dtype=torch.float32, device=bmat.device)
    lib = _build.library()
    codes = (_build.dtype_code("easi_apply", y), _build.dtype_code("easi_apply", bmat))

    def call():
        _build.raise_on_error("easi_apply", lib.repro_easi_apply(
            _build.ptr(y), _build.ptr(bmat), _build.ptr(scratch), _build.ptr(out), b, n, m,
            float(mu), 1.0 / b, int(so), int(ho), 0, slices, cols, *codes, _build.stream(bmat)))
        return out
    return call


def easi_tile_bodies(b, n, m):
    """{body: (slices, its column templates)} that a (b, n, m) call admits:
    the small body where n <= 64, the split body always (its slices as the
    plan would give them)."""
    from repro_torch.kernels import resource_model as rm

    out = {"split": (easi_split_slices(b, n), rm.EASI_SPLIT_COLS)}
    if n <= rm.ES_SMALL_N:
        out["small"] = (0, rm.EASI_SMALL_COLS)
    return out


def easi_tile_checks(dev, normal, note):
    """easi_apply's column templates at EASI_TILE_SHAPES, f32 and bf16:
    every width of each body the shape admits, through the C entry, equal to
    the narrowest width (the default policy's) bit for bit and within
    EASI_TOL / BF16_TOL of the plain version; the
    wrapper with `block_m` = each width gives the same bits; `plan`'s width
    for each easi_block_m is `resource_model.effective_easi_tile`'s.
    Returns the number of checks."""
    import torch
    from repro_torch.kernels import easi_update
    from repro_torch.kernels import resource_model as rm

    checks = 0
    for (b, n, m) in EASI_TILE_SHAPES:
        for block_m in (1, 16, 32, 64, 128, 256, 512):
            got = easi_update.plan(b, n, m, True, True, block_m)[2]
            want = rm.effective_easi_tile(b, n, m, block_m)
            if got != want:
                fail(f"easi_apply plan({b}, {n}, {m}, block_m={block_m}): {got} columns a CTA, "
                     f"the resource model {want}")
        for dtype, tol in ((torch.float32, EASI_TOL), (torch.bfloat16, BF16_TOL)):
            bm, y = normal(n, m, dtype=dtype, scale=0.3), normal(b, n, dtype=dtype)
            want = easi_update.plain(bm, y, mu=1e-3)
            slices_plan = easi_update.plan(b, n, m)[0]
            for body, (slices, widths) in easi_tile_bodies(b, n, m).items():
                base = easi_entry(y, bm, slices=slices, cols=widths[0])().clone()
                for cols in widths:
                    got = easi_entry(y, bm, slices=slices, cols=cols)()
                    what = f"easi_apply {body} body, {cols} columns a CTA, ({b}, {n}, {m}) {dtype}"
                    if not torch.equal(got, base):
                        fail(f"{what}: differs from {widths[0]} columns in "
                             f"{int((got != base).sum())} elements")
                    note("easi_apply", dtype, check_close(what, got, want, **tol))
                    if (slices == 0) == (slices_plan == 0):    # the body the wrapper takes
                        if not torch.equal(easi_update.easi_apply(bm, y, mu=1e-3, block_m=cols),
                                           base):
                            fail(f"{what}: the wrapper with block_m={cols} differs")
                    checks += 1
    print(f"[kernels] easi_apply column templates at {EASI_TILE_SHAPES}, f32 and bf16: "
          f"{checks} instances bit-identical to the narrowest width and within tolerance")
    return checks


def easi_tile_timing(dev, card_line):
    """Device-only ms of each column template of each body that
    EASI_TILE_SHAPES admit, through the C entry, f32 (so, ho both on)."""
    import torch

    gen, out = torch.Generator().manual_seed(12), []
    for (b, n, m) in EASI_TILE_SHAPES:
        bm = (torch.randn((n, m), generator=gen) * 0.3).to(dev)
        y = torch.randn((b, n), generator=gen).to(dev)
        for body, (slices, widths) in easi_tile_bodies(b, n, m).items():
            row = {"shape": [b, n, m], "body": body, "slices": slices,
                   "device_ms": {str(c): time_graph(easi_entry(y, bm, slices=slices, cols=c))
                                 for c in widths}}
            out.append(row)
    print(f"[time] easi_apply column templates ({card_line}), device-only ms by columns a "
          "CTA: " + "; ".join(
              f"{tuple(r['shape'])} {r['body']}: "
              + ", ".join(f"{c} {t:.4f}" for c, t in r["device_ms"].items()) for r in out))
    return out


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.kernels import easi_update, flash_attention, fused_transform, ternary_matmul

    for mod in (ternary_matmul, fused_transform, easi_update, flash_attention):
        mod.launches = 0
    flash_attention.bwd_launches = 0


def read_counts():
    """The DR kernels' launch counts (each wrapper's `launches`)."""
    from repro_torch import kernels

    counts = kernels.launch_counts()
    return {k: counts[k] for k in ("ternary_matmul", "fused_transform", "easi_apply")}


def paper_data(dev):
    """Waveform-V2's paper split on `dev`: centred, one global scalar scale
    fitted on the 4000 training rows."""
    import torch
    from repro_torch.data import waveform

    (xtr, _), (xte, _) = waveform.paper_split(seed=0)
    xtr, xte = torch.from_numpy(xtr).to(dev), torch.from_numpy(xte).to(dev)
    mean = xtr.mean(0)
    scale = torch.sqrt(torch.mean(torch.var(xtr - mean, dim=0, correction=0))) + 1e-8
    return (xtr - mean) / scale, (xte - mean) / scale


def phase_paper(dev):
    import numpy as np
    import torch
    from repro_torch.core.easi import whiteness_kl
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage

    xtr, xte = paper_data(dev)

    rng = np.random.RandomState(0)
    sizes = np.clip(np.rint(rng.lognormal(mean=1.6, sigma=0.9, size=8)), 1, 48).astype(int)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    requests = [xte[s:s + k] for s, k in zip(starts, sizes)]

    def run(backend):
        model = DRModel(stages=(RPStage(PAPER["m"], PAPER["p"]),
                                EASIStage.rotation(PAPER["p"], PAPER["n"], mu=PAPER["mu"])),
                        execution=Execution(backend=backend, device=dev),
                        block_size=PAPER["block"])
        marks = [read_counts()]              # counts after each entry point
        t0 = time.perf_counter()
        state = model.init(torch.Generator().manual_seed(0))
        state = model.fit(state, xtr, epochs=PAPER["epochs"])
        marks.append(read_counts())
        y_test = model.transform(state, xte)
        marks.append(read_counts())
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        live, staged, served = state, state, []
        for xr in requests:                  # train-while-serve
            served.append(model.transform(live, xr))
            staged = model.update(staged, xr)
        marks.append(read_counts())
        live = staged                        # promote
        probe = model.transform(live, xte[:64])
        torch.cuda.synchronize()
        marks.append(read_counts())
        steps = {what: {k: after[k] - before[k] for k in after}
                 for what, before, after in zip(
                     ("fit", "transform", "serve", "transform_after_promote"),
                     marks, marks[1:])}
        return dict(model=model, state=state, y_test=y_test, served=torch.cat(served),
                    staged=staged, probe=probe, t_fit=t_fit, launches_by_entry=steps)

    reset_counts()
    k = run("kernel")
    counts = read_counts()
    t = run("torch")
    steps = PAPER["epochs"] * (4000 // PAPER["block"]) + len(requests)
    if int(k["staged"].steps) != steps:
        fail(f"paper: steps {int(k['staged'].steps)}, want {steps}")
    if tuple(k["y_test"].shape) != (1000, PAPER["n"]):
        fail(f"paper: transform shape {tuple(k['y_test'].shape)}")
    check_close("paper R", k["state"].r, t["state"].r, rtol=0, atol=0)
    err_b = check_close("paper B after fit", k["state"].b, t["state"].b, **TRAJ_TOL)
    err_y = check_close("paper transform", k["y_test"], t["y_test"], **OUT_TOL)
    check_close("paper served", k["served"], t["served"], **OUT_TOL)
    check_close("paper B after serving", k["staged"].b, t["staged"].b, **TRAJ_TOL)
    check_close("paper probe after promote", k["probe"], t["probe"], **OUT_TOL)
    kl_k, kl_t = float(whiteness_kl(k["y_test"])), float(whiteness_kl(t["y_test"]))
    if not (math.isfinite(kl_k) and abs(kl_k - kl_t) <= 1e-3 * max(1.0, abs(kl_t))):
        fail(f"paper: whiteness_kl kernel {kl_k} vs torch {kl_t}")
    print(f"[paper] rp24_easi_n16: fit {PAPER['epochs']} epochs + transform of 1000 rows in "
          f"{k['t_fit']:.2f} s (kernel) / {t['t_fit']:.2f} s (torch); "
          f"served {len(requests)} requests of {sizes.tolist()} rows")
    print(f"[paper] max |B_kernel - B_torch| {err_b:.3e}, max |y_kernel - y_torch| {err_y:.3e}, "
          f"whiteness_kl {kl_k:.6f} (torch {kl_t:.6f})")
    print(f"[paper] launches on the main path: {json.dumps(counts)}; by entry point (fit of "
          f"4000 rows x {PAPER['epochs']} epochs, transform of 1000 rows, {len(requests)} x "
          f"(transform + update), transform after promote): "
          f"{json.dumps(k['launches_by_entry'])}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"paper: kernels never launched on the main path: {missing}")
    return counts, paper_timings(k["model"], k["state"], xtr[:PAPER["block"]], xte)


# ---------------------------------------------------------------------------
# phase 3b: the paper's experiment — Table I, Table II, ICA quality
# ---------------------------------------------------------------------------

def phase_table1(dev):
    """The four Table I rows through `pipeline.fit_two_stage` and `evaluate`
    at the protocol's full epochs, kernel backend (the main path: counts set
    to 0 just before, read just after) and torch backend; Table II; the ICA
    benchmark on both backends; and an in-place write to a served state."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import waveform_paper as wp
    from repro_torch.core import pipeline
    from repro_torch.data import waveform
    from repro_torch.dr import Execution
    from repro_torch.experiments import ica_quality, table2_cost

    (xtr, ytr), (xte, yte) = waveform.paper_split(seed=0)
    xtr, ytr, xte, yte = (torch.from_numpy(a).to(dev) for a in (xtr, ytr, xte, yte))

    def run(backend):
        exe = Execution(backend=backend, device=dev)
        out, marks = {}, [read_counts()]
        for name, cfg in wp.TABLE1_ROWS.items():
            c = dataclasses.replace(cfg, seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = pipeline.fit_two_stage(c, xtr, ytr, execution=exe)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            marks.append(read_counts())
            acc = pipeline.evaluate(model, xte, yte, execution=exe)
            t2 = time.perf_counter()
            marks.append(read_counts())
            out[name] = dict(model=model, acc=acc, t_fit=t1 - t0, t_eval=t2 - t1,
                             dr_epochs=c.dr_epochs, head_epochs=c.head_epochs)
        by_entry = {}
        for i, name in enumerate(out):
            before, fitted, evaluated = marks[2 * i], marks[2 * i + 1], marks[2 * i + 2]
            by_entry[name] = {"fit_two_stage": {k: fitted[k] - before[k] for k in before},
                              "evaluate": {k: evaluated[k] - fitted[k] for k in before}}
        return out, by_entry

    reset_counts()
    k, k_by_entry = run("kernel")
    all_counts = kernels.launch_counts()
    counts = read_counts()
    t, _ = run("torch")

    accs = {}
    for name in wp.TABLE1_ROWS:
        ks, ts = k[name]["model"]["dr_state"], t[name]["model"]["dr_state"]
        if (ks.r is None) != (ts.r is None):
            fail(f"table1 {name}: R present on one backend only")
        if ks.r is not None:
            check_close(f"table1 {name} R", ks.r, ts.r, rtol=0, atol=0)
        err_b = check_close(f"table1 {name} B after fit", ks.b, ts.b, **TRAJ_TOL)
        acc_k, acc_t = k[name]["acc"], t[name]["acc"]
        if not abs(acc_k - acc_t) <= TABLE1_ACC_GAP:
            fail(f"table1 {name}: accuracy {acc_k:.4f} (kernel) vs {acc_t:.4f} (torch)")
        for backend, acc in (("kernel", acc_k), ("torch", acc_t)):
            if not acc > TABLE1_FLOORS[name]:
                fail(f"table1 {name}: accuracy {acc:.4f} ({backend}) not above the floor "
                     f"{TABLE1_FLOORS[name]}")
        accs[name] = {"kernel": acc_k, "torch": acc_t, "paper": wp.PAPER_TABLE1[name] / 100,
                      "max_abs_err_b": err_b,
                      "fit_s": {"kernel": k[name]["t_fit"], "torch": t[name]["t_fit"]},
                      "evaluate_s": {"kernel": k[name]["t_eval"], "torch": t[name]["t_eval"]},
                      "dr_epochs": k[name]["dr_epochs"], "head_epochs": k[name]["head_epochs"]}
        print(f"[table1] {name}: accuracy {100 * acc_k:.1f}% (kernel) / {100 * acc_t:.1f}% "
              f"(torch), paper {wp.PAPER_TABLE1[name]}%; max |B_kernel - B_torch| {err_b:.3e}; "
              f"fit_two_stage ({k[name]['dr_epochs']} DR epochs, {k[name]['head_epochs']} head "
              f"epochs) {k[name]['t_fit']:.2f} s (kernel) / {t[name]['t_fit']:.2f} s (torch), "
              f"evaluate {1e3 * k[name]['t_eval']:.2f} ms / {1e3 * t[name]['t_eval']:.2f} ms")
    for backend, res in (("kernel", k), ("torch", t)):
        d16 = res["rp24_easi_n16"]["acc"] - res["easi_n16"]["acc"]
        d8 = res["rp16_easi_n8"]["acc"] - res["easi_n8"]["acc"]
        if not abs(d16) < TABLE1_CLAIM:
            fail(f"table1: |Δ(n=16)| = {abs(d16):.4f} ({backend}), want < {TABLE1_CLAIM}")
        print(f"[table1] claim check ({backend}): Δ(n=16) = {100 * d16:+.1f}, "
              f"Δ(n=8) = {100 * d8:+.1f} points (paper: -0.1 / -0.1)")
    print(f"[table1] launches on the Table I path (kernel backend, 4 rows of fit_two_stage + "
          f"evaluate): {json.dumps(counts)}; by row and entry point: {json.dumps(k_by_entry)}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"table1: kernels never launched on the Table I path: {missing}")

    # ---- Table II: the cost model's rows ---------------------------------
    t2 = {name: detail for name, _, detail in table2_cost.run()}
    for name, want in TABLE2_WANT.items():
        if want not in t2.get(name, "").split(";"):
            fail(f"table2 {name}: {t2.get(name)!r}, want {want}")
    for name, detail in t2.items():
        print(f"[table2] {name} {detail}")

    # ---- ICA quality: the benchmark's fast sizes, kernel against torch ----
    ica = {}
    for backend in ("kernel", "torch"):
        marks = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = ica_quality.run(fast=True, execution=Execution(backend=backend, device=dev))
        ica[backend] = {"amari": {n: float(d.split("=")[1]) for n, _, d in rows},
                        "s": time.perf_counter() - t0,
                        "launches": {c: v - marks[c] for c, v in read_counts().items()}}
    for name, a_k in ica["kernel"]["amari"].items():
        a_t = ica["torch"]["amari"][name]
        if not (math.isfinite(a_k) and abs(a_k - a_t) <= ICA_AMARI_TOL):
            fail(f"ica {name}: Amari distance {a_k:.5f} (kernel) vs {a_t:.5f} (torch)")
        print(f"[ica] {name}: Amari distance {a_k:.4f} (kernel) / {a_t:.4f} (torch)")
    if ica["kernel"]["launches"]["easi_apply"] <= 0:
        fail("ica: easi_apply never launched through the kernel backend")
    print(f"[ica] benchmark {ica['kernel']['s']:.2f} s (kernel) / {ica['torch']['s']:.2f} s "
          f"(torch); launches (kernel): {json.dumps(ica['kernel']['launches'])}")

    check_in_place_write(dev, k["rp24_easi_n16"]["model"], xte)
    split = table1_timings(dev, k, xtr, ytr)
    return all_counts, {"rows": accs, "launches_by_row": k_by_entry, "time_split": split,
                    "ica": {b: {"amari": v["amari"], "s": v["s"]} for b, v in ica.items()},
                    "ica_launches": ica["kernel"]["launches"]}


def table1_timings(dev, fitted, xtr, ytr):
    """Where a Table I row's fit goes: the DR stage alone (init + fit, each
    backend, host clock around a synchronize), and one epoch of the head's
    AdamW steps on the kernel run's features, host-paced and, from a
    torch.profiler trace of a second epoch, the device's busy time and the
    kernels it ran (None where the trace shows no device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import waveform_paper as wp
    from repro_torch.core import pipeline
    from repro_torch.dr import Execution
    from repro_torch.models import mlp
    from repro_torch.train import optimizer as opt

    out = {}
    for name, cfg in wp.TABLE1_ROWS.items():
        row, fit = {}, fitted[name]["model"]
        x_dr, _ = pipeline.center_global_scale(xtr, fit["dr_stats"])
        for backend in ("kernel", "torch"):
            model = cfg.dr.with_execution(Execution(backend=backend, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.fit(model.init(pipeline.generators(0)[0]), x_dr, epochs=cfg.dr_epochs)
            torch.cuda.synchronize()
            row[f"dr_fit_s_{backend}"] = time.perf_counter() - t0
        feats, _ = pipeline.standardize(fit["dr_model"].transform(fit["dr_state"], x_dr),
                                        fit["head_stats"])
        adamw = opt.AdamWConfig(lr=cfg.head_lr, grad_clip=None, weight_decay=cfg.head_wd)
        params = mlp.init(torch.Generator().manual_seed(0), feats.shape[-1], cfg.head_hidden,
                          cfg.head_classes, device=dev)
        state = opt.init(params)
        steps = feats.shape[0] // cfg.head_batch
        perm = torch.randperm(feats.shape[0], generator=torch.Generator().manual_seed(1))
        mlp.train_epoch(params, state, feats, ytr, perm, adamw, batch=cfg.head_batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mlp.train_epoch(params, state, feats, ytr, perm, adamw, batch=cfg.head_batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mlp.train_epoch(params, state, feats, ytr, perm, adamw, batch=cfg.head_batch)
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
        row.update(head_step_ms=step_ms, head_steps=cfg.head_epochs * steps,
                   head_step_device_ms=busy_ms if device else None,
                   head_step_device_ops=len(device) / steps if device else None,
                   head_idle_share=1.0 - busy_ms / step_ms if device else None)
        out[name] = row
        dev_txt = (f"{busy_ms:.4f} ms on the device in {len(device) / steps:.0f} device ops "
                   f"(idle share {1.0 - busy_ms / step_ms:.2f})" if device
                   else "device time not measured (the trace shows no device work)")
        print(f"[table1-time] {name}: DR init + fit alone {row['dr_fit_s_kernel']:.2f} s "
              f"(kernel) / {row['dr_fit_s_torch']:.2f} s (torch); the head's AdamW step "
              f"{step_ms:.3f} ms host-paced, {dev_txt}; {row['head_steps']} steps a fit")
    return out


def check_in_place_write(dev, fitted, xte):
    """A state registered in a DRService and then written in place: the
    captured bucket program's next answer is the eager transform of the
    written state (ROADMAP C4)."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.serve import BucketPolicy, DRService

    model, trained = fitted["dr_model"], fitted["dr_state"]
    live = trained._replace(stages=tuple(s.clone() for s in trained.stages))
    policy = BucketPolicy(min_bucket=8, max_bucket=64)
    x, _ = pipeline.center_global_scale(xte[:20], fitted["dr_stats"])
    svc = DRService(buckets=policy)
    svc.register("in_place", model, live)
    captured(bucket_program(svc, "in_place", policy.bucket_for(x.shape[0])))
    before = svc.transform("in_place", x)
    check_equal("in-place write: answer before", before, eager_served(model, live, [x], policy)[0])
    live.b.mul_(-0.5)                                  # the write, in place
    after = svc.transform("in_place", x)
    check_equal("in-place write: captured answer after the write", after,
                eager_served(model, live, [x], policy)[0])
    if torch.equal(after, before):
        fail("in-place write: the captured program answered from the old state")
    print(f"[c4] B of a registered state written in place: the captured bucket program "
          f"answers the written state bit for bit (max |after - before| "
          f"{max_err(after, before):.3e})")


def paper_timings(model, state, blk, xte):
    """Host-paced (CUDA events around back-to-back calls) and device-only
    (CUDA graph replay) times of the paper model's steps and of each kernel
    at the shapes those steps give it."""
    import torch
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    r, b_mat = state.r, state.b
    scale = model.stages[0].rp_cfg(model.execution).scale
    mu = model.stages[1].mu
    y = ternary_matmul.ternary_matmul(blk, r, scale=scale) @ b_mat.T
    cases = {
        "update": (lambda: model.update(state, blk), [PAPER["block"], PAPER["m"]]),
        "transform": (lambda: model.transform(state, blk), [PAPER["block"], PAPER["m"]]),
        "transform_1000": (lambda: model.transform(state, xte), [1000, PAPER["m"]]),
        "ternary_matmul": (lambda: ternary_matmul.ternary_matmul(blk, r, scale=scale),
                           [PAPER["block"], PAPER["m"], PAPER["p"]]),
        "fused_transform": (lambda: fused_transform.fused_transform(blk, r, b_mat, scale=scale),
                            [PAPER["block"], PAPER["m"], PAPER["p"], PAPER["n"]]),
        "easi_apply": (lambda: easi_update.easi_apply(b_mat, y, mu=mu, second_order=False),
                       [PAPER["block"], PAPER["n"], PAPER["p"]]),
    }
    out = {}
    for name, (fn, shape) in cases.items():
        out[name] = {"shape": shape, "ms": time_events(fn), "device_ms": time_graph(fn)}
        print(f"[paper-time] {name} {shape}: {out[name]['ms']:.4f} ms host-paced, "
              f"{out[name]['device_ms']:.4f} ms on the device alone")
    return out


# ---------------------------------------------------------------------------
# phase 4: the wide configuration, then timings
# ---------------------------------------------------------------------------

def phase_wide(dev, errs, card_line):
    import torch
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage

    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    gen = torch.Generator().manual_seed(7)
    blocks = [torch.randn((blk, m), generator=gen).to(dev) for _ in range(8)]

    def run(backend):
        model = DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)),
                        execution=Execution(backend=backend, device=dev), block_size=blk)
        state = model.init(torch.Generator().manual_seed(0))
        outs = []
        for xb in blocks:
            outs.append(model.transform(state, xb))
            state = model.update(state, xb)
        torch.cuda.synchronize()
        return model, state, torch.cat(outs)

    reset_counts()
    model, st_k, y_k = run("kernel")
    counts = read_counts()
    _, st_t, y_t = run("torch")
    check_close("wide B after updates", st_k.b, st_t.b, **TRAJ_TOL)
    check_close("wide transform", y_k, y_t, **OUT_TOL)
    print(f"[wide] 1024→256→128, block {blk}: {len(blocks)} update + transform steps agree "
          f"with the torch backend; launches {json.dumps(counts)}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"wide: kernels never launched: {missing}")

    # ---- timings at the shapes this path gives each kernel ----------------
    x, r, b_mat = blocks[0], st_k.r, st_k.b
    scale = model.stages[0].rp_cfg(model.execution).scale
    h = ternary_matmul.ternary_matmul(x, r, scale=scale)
    y = h @ b_mat.T
    mu = model.stages[1].mu
    nnz = int((r != 0).sum())
    w = (r.to(torch.float32) * scale).T.contiguous()      # (m, p) for the yardstick
    bt = b_mat.T.contiguous()

    def lib_easi():
        hh = torch.mm((y * y * y).T, y)
        g = (hh - hh.T) / blk
        return torch.addmm(b_mat, g, b_mat, alpha=-mu)

    rows = []
    specs = [
        ("ternary_matmul", ternary_matmul, "src/repro/kernels/ternary_matmul.py:47",
         lambda: ternary_matmul.ternary_matmul(x, r, scale=scale),
         lambda: ternary_matmul.plain(x, r, scale=scale),
         lambda: torch.mm(x, w), "torch.mm(x, (scale*R)^T) on a float R made beforehand",
         2.0 * blk * nnz, 4 * blk * m + p * m + 4 * blk * p, (blk, m, p)),
        ("fused_transform", fused_transform, "src/repro/kernels/fused_transform.py:72",
         lambda: fused_transform.fused_transform(x, r, b_mat, scale=scale),
         lambda: fused_transform.plain(x, r, b_mat, scale=scale),
         lambda: torch.linalg.multi_dot([x, w, bt]),
         "torch.linalg.multi_dot([x, (scale*R)^T, B^T]) on a float R made beforehand",
         2.0 * blk * nnz + 2.0 * blk * p * n, 4 * blk * m + p * m + 4 * n * p + 4 * blk * n,
         (blk, m, p, n)),
        ("easi_apply", easi_update, "src/repro/kernels/easi_update.py:72",
         lambda: easi_update.easi_apply(b_mat, y, mu=mu, second_order=False),
         lambda: easi_update.plain(b_mat, y, mu=mu, second_order=False),
         lib_easi, "torch.mm(g(Y)^T, Y), (H - H^T)/b, torch.addmm(B, G, B, alpha=-mu)",
         2.0 * blk * n * n + 2.0 * n * n * p + 3.0 * blk * n, 4 * blk * n + 2 * 4 * n * p,
         (blk, n, p)),
    ]
    for (name, mod, replaces, kern, plain, lib, lib_what, flops, nbytes, shape) in specs:
        err = check_close(f"{name} at the wide shape", kern(), plain(),
                          **(EASI_TOL if name == "easi_apply" else F32_TOL))
        ms, plain_ms, lib_ms = time_events(kern), time_events(plain), time_events(lib)
        dev_ms, plain_dev_ms, lib_dev_ms = time_graph(kern), time_graph(plain), time_graph(lib)
        ms2 = time_events(kern)                      # kernel, plain, ..., kernel again
        bms, bby = bound_ms(flops, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{Path(mod.__file__).stem}.cu",
            "replaces": replaces,
            "launches": None, "launches_wide": counts[name],
            "max_abs_err": err,
            "max_abs_err_sweep_f32": errs.get((name, "f32")),
            "max_abs_err_sweep_bf16": errs.get((name, "bf16")),
            "ms": ms, "ms_repeat": ms2, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby, "library_ms": lib_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "library_device_ms": lib_dev_ms, "library": lib_what,
            "shape": list(shape), "flops": flops, "bytes": nbytes,
        })
        print(f"[time] {name} {shape}: kernel {ms:.4f} ms ({ms2:.4f} again), device-only "
              f"{dev_ms:.4f} ms; plain {plain_ms:.4f} ms (device {plain_dev_ms:.4f}); "
              f"library {lib_ms:.4f} ms (device {lib_dev_ms:.4f}); bound {bms:.6f} ms "
              f"({bby})")
    # launches per call, counted around one call at the wide shape and one at
    # the paper block (32, 32, 24, 16)
    gen = torch.Generator().manual_seed(8)
    px = torch.randn((PAPER["block"], PAPER["m"]), generator=gen).to(dev)
    pr = (torch.randint(-1, 2, (PAPER["p"], PAPER["m"]), generator=gen)).to(torch.int8).to(dev)
    pb = (torch.randn((PAPER["n"], PAPER["p"]), generator=gen) * 0.2).to(dev)
    py = torch.randn((PAPER["block"], PAPER["n"]), generator=gen).to(dev)
    calls = {
        "ternary_matmul": (ternary_matmul, lambda: ternary_matmul.ternary_matmul(x, r, scale=scale),
                           lambda: ternary_matmul.ternary_matmul(px, pr, scale=0.2)),
        "fused_transform": (fused_transform,
                            lambda: fused_transform.fused_transform(x, r, b_mat, scale=scale),
                            lambda: fused_transform.fused_transform(px, pr, pb, scale=0.2)),
        "easi_apply": (easi_update,
                       lambda: easi_update.easi_apply(b_mat, y, mu=mu, second_order=False),
                       lambda: easi_update.easi_apply(pb, py, mu=mu, second_order=False)),
    }
    for row in rows:
        mod, wide_call, paper_call = calls[row["name"]]
        per_call = {}
        for shape, call in (("wide", wide_call), ("paper", paper_call)):
            mod.launches = 0
            call()
            torch.cuda.synchronize()
            per_call[shape] = mod.launches
        row["kernel_launches_per_call"] = per_call
        print(f"[launches] {row['name']}: {per_call['wide']} a call at the wide shape, "
              f"{per_call['paper']} at the paper block")
    by_name = {row["name"]: row for row in rows}
    # each sparse tile template of B1 and B3 at the wide row, in this one call;
    # the rows above ran the default (Execution's 128 x 128: 32 x 64)
    tile_calls = {
        "ternary_matmul": lambda bm, bp: ternary_matmul.ternary_matmul(
            x, r, scale=scale, block_m=bm, block_p=bp),
        "fused_transform": lambda bm, bp: fused_transform.fused_transform(
            x, r, b_mat, scale=scale, block_m=bm, block_p=bp)}
    for name, call in tile_calls.items():
        per = {f"{bm}x{bp}": time_graph(lambda bm=bm, bp=bp: call(bm, bp))
               for bm, bp in tile_points()}
        by_name[name]["tile_device_ms"] = per
        print(f"[time] {name} {by_name[name]['shape']} ({card_line}) device-only ms by tile "
              f"(rows of x x rows of R a CTA): "
              + ", ".join(f"{k} {v:.4f}" for k, v in per.items()))
    by_name["fused_transform"]["density_s3"] = fused_density_timing(x, b_mat, bt)
    for s in (3, 1):
        by_name["ternary_matmul"][f"density_s{s}"] = tmm_density_timing(x, s)
    by_name["easi_apply"]["bodies"] = easi_body_timing(dev)
    by_name["easi_apply"]["column_tiles"] = easi_tile_timing(dev, card_line)
    return rows


# (b, n, m, so) on either side of easi_apply's choice of body
EASI_BODY_SHAPES = [(32, 16, 24, False), (64, 16, 256, False), (128, 32, 256, False),
                    (32, 64, 100, True), (1024, 16, 24, False), (256, 64, 256, False),
                    (4000, 16, 24, False)]


def easi_body_timing(dev):
    """easi_apply's two bodies, each forced through the C entry, at shapes on
    either side of the plan's choice (n <= 64 here, one tile of G or a few,
    so the split body takes up to 8 slices of at least 32 samples, as the
    plan would give it): the measurement behind the plan's threshold."""
    import torch
    from repro_torch.kernels import easi_update

    gen, out = torch.Generator().manual_seed(11), []
    for (b, n, m, so) in EASI_BODY_SHAPES:
        bm = (torch.randn((n, m), generator=gen) * 0.3).to(dev)
        y = torch.randn((b, n), generator=gen).to(dev)
        row = {"shape": [b, n, m], "so": so, "plan": easi_update.plan(b, n, m, so, True)[0]}
        for body, slices, cols in (("small", 0, 32), ("split", easi_split_slices(b, n), 16)):
            row[f"{body}_device_ms"] = time_graph(
                easi_entry(y, bm, slices=slices, cols=cols, mu=2e-4, so=so))
        out.append(row)
    print("[time] easi_apply bodies, device-only ms (small / split; the plan's choice): " + "; ".join(
        f"{tuple(r['shape'])}{' so' if r['so'] else ''} {r['small_device_ms']:.4f} / "
        f"{r['split_device_ms']:.4f} ({'small' if r['plan'] == 0 else 'split'})" for r in out))
    return out


def tmm_density_timing(x, s):
    """ternary_matmul at the wide shape with R of density 1/s, beside
    torch.mm on a float R: how its time follows R's density.  No target."""
    import torch
    from repro_torch.core import random_projection as rp
    from repro_torch.kernels import ternary_matmul

    blk, m = x.shape
    cfg = rp.RPConfig(m=m, p=WIDE["p"], sparsity=s)
    r = rp.sample_ternary(torch.Generator().manual_seed(10 + s), cfg).to(x.device)
    nnz = int((r != 0).sum())
    w = (r.to(torch.float32) * cfg.scale).T.contiguous()
    kern = lambda: ternary_matmul.ternary_matmul(x, r, scale=cfg.scale)
    plain = lambda: ternary_matmul.plain(x, r, scale=cfg.scale)
    lib = lambda: torch.mm(x, w)
    err = check_close(f"ternary_matmul at the wide shape, s = {s}", kern(), plain(), **F32_TOL)
    dev_ms, plain_dev_ms, lib_dev_ms = time_graph(kern), time_graph(plain), time_graph(lib)
    flops = 2.0 * blk * nnz
    nbytes = 4 * blk * m + WIDE["p"] * m + 4 * blk * WIDE["p"]
    bms, bby = bound_ms(flops, nbytes)
    print(f"[time] ternary_matmul {(blk, m, WIDE['p'])} R at s = {s} ({nnz} nonzeros): "
          f"device-only {dev_ms:.4f} ms; plain (device) {plain_dev_ms:.4f} ms; torch.mm "
          f"(device) {lib_dev_ms:.4f} ms; bound {bms:.6f} ms ({bby}); max |err| {err:.3e}")
    return {"s": s, "nnz": nnz, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bms, "bound_by": bby,
            "max_abs_err": err, "flops": flops, "bytes": nbytes}


def fused_density_timing(x, b_mat, bt):
    """fused_transform at the wide shape with R at s = 3 (a third of R's
    entries nonzero): how its time follows R's density.  No target."""
    import torch
    from repro_torch.core import random_projection as rp
    from repro_torch.kernels import fused_transform

    (blk, m), (n, p) = x.shape, b_mat.shape
    cfg = rp.RPConfig(m=m, p=p, sparsity=3)
    r = rp.sample_ternary(torch.Generator().manual_seed(3), cfg).to(x.device)
    nnz = int((r != 0).sum())
    w = (r.to(torch.float32) * cfg.scale).T.contiguous()
    kern = lambda: fused_transform.fused_transform(x, r, b_mat, scale=cfg.scale)
    plain = lambda: fused_transform.plain(x, r, b_mat, scale=cfg.scale)
    lib = lambda: torch.linalg.multi_dot([x, w, bt])
    err = check_close("fused_transform at the wide shape, s = 3", kern(), plain(), **F32_TOL)
    dev_ms, plain_dev_ms, lib_dev_ms = time_graph(kern), time_graph(plain), time_graph(lib)
    flops = 2.0 * blk * nnz + 2.0 * blk * p * n
    nbytes = 4 * blk * m + p * m + 4 * n * p + 4 * blk * n
    bms, bby = bound_ms(flops, nbytes)
    print(f"[time] fused_transform {(blk, m, p, n)} R at s = 3 ({nnz} nonzeros): device-only "
          f"{dev_ms:.4f} ms; plain (device) {plain_dev_ms:.4f} ms; library (device) "
          f"{lib_dev_ms:.4f} ms; bound {bms:.6f} ms ({bby}); max |err| {err:.3e}")
    return {"s": 3, "nnz": nnz, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bms, "bound_by": bby,
            "max_abs_err": err, "flops": flops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# phase 5: the serving engine on the card, every bucket program a CUDA graph
# ---------------------------------------------------------------------------

SERVE_BUCKETS = dict(min_bucket=8, max_bucket=1024)   # src/repro/serve/batching.py:52-53
SERVE_REQUESTS = 256     # ragged requests, rows drawn as benchmarks/serve_latency.py:112-116
SERVE_WINDOW = 8         # requests coalesced per flush
SERVE_BIG = [1024, 1500, 2600]   # a full bucket, and requests chunked past max_bucket
SCHED_CLIENTS = 4


def ragged_requests(n_req, m, dev, seed):
    """Lognormal row counts (mean 1.6, sigma 0.9, clipped to [1, 48]) and
    standard-normal rows, from a seed."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    sizes = np.clip(np.rint(rng.lognormal(mean=1.6, sigma=0.9, size=n_req)), 1, 48).astype(int)
    return [torch.from_numpy(rng.randn(k, m).astype(np.float32)).to(dev) for k in sizes]


def bucket_program(svc, name, bucket):
    """The program the service serves `name`'s bucket with (a cache hit)."""
    import torch

    prog = svc._transform_fn(svc.registry.get(name), bucket, torch.float32)
    return getattr(prog, "fn", prog)


def program_stats(prog):
    """(launches the wrappers counted while `prog` was captured, its replays);
    fails unless `prog` is a captured CUDA graph."""
    return dict(captured(prog).captured_launches), captured(prog).replays


def captured(prog):
    """`prog` (or the program a TunedProgram holds), which must be a captured
    CUDA graph."""
    from repro_torch.kernels.autotune import TunedProgram
    from repro_torch.serve.engine import CapturedProgram

    if isinstance(prog, TunedProgram):
        prog = prog.fn
    if not isinstance(prog, CapturedProgram):
        fail(f"serve: a cached program is a {type(prog).__name__}, not a captured CUDA graph")
    return prog


def serve_program_launches(svc):
    """Per kernel, over every program in `svc`'s compile cache: the launches
    counted in the eager warm-up call before each capture, those counted during
    the captures, and the kernel runs the programs' replays have made so far
    (replays × captured launches)."""
    from repro_torch import kernels

    out = {what: dict.fromkeys(kernels.launch_counts(), 0)
           for what in ("warmup", "captured", "replayed")}
    for prog in list(svc.cache._d.values()):
        prog = captured(prog)
        for k, v in prog.warmup_launches.items():
            out["warmup"][k] += v
        for k, v in prog.captured_launches.items():
            out["captured"][k] += v
            out["replayed"][k] += v * prog.replays
    return out


def tile_points():
    """B1's and B3's sparse tile templates, (rows of x, rows of R at most) a
    CTA: the resource model's TILE_ROWS x TILE_P, which `[resources]` holds
    against the card."""
    from repro_torch.kernels import resource_model

    return [(bm, bp) for bm in resource_model.TILE_ROWS for bp in resource_model.TILE_P]


def with_tiles(model, tiles):
    """`model` with its Execution's tmm_block_* set to `tiles` (a TileConfig)."""
    import dataclasses

    return model.with_execution(dataclasses.replace(
        model.execution, tmm_block_m=tiles.block_m, tmm_block_p=tiles.block_p,
        tmm_block_k=tiles.block_k))


def served_tiles(svc, name, policy):
    """The tiles each of `name`'s bucket programs won its race with."""
    import torch
    from repro_torch.kernels.autotune import TunedProgram

    out = {}
    for b in policy.buckets():
        prog = svc._transform_fn(svc.registry.get(name), b, torch.float32)
        if not isinstance(prog, TunedProgram):
            fail(f"serve: the bucket {b} program of {name!r} is a {type(prog).__name__}, not a "
                 f"TunedProgram")
        out[b] = prog.tiles
    return out


def eager_served(model, state, xs, policy, tiles=None):
    """What a flush of `xs` must return bit for bit: the requests coalesced,
    cut into max_bucket chunks, each padded to its bucket and run through the
    model's own eager call, under the tiles its bucket's program won with
    (`tiles`, bucket -> TileConfig; the model's own where not given)."""
    import torch

    xcat = torch.cat(xs)
    outs = []
    for i in range(0, xcat.shape[0], policy.max_bucket):
        chunk = xcat[i:i + policy.max_bucket]
        bucket = policy.bucket_for(chunk.shape[0])
        pad = chunk.new_zeros((bucket - chunk.shape[0], chunk.shape[1]))
        mdl = with_tiles(model, tiles[bucket]) if tiles else model
        outs.append(mdl.transform(state, torch.cat([chunk, pad]))[:chunk.shape[0]])
    y, per, off = torch.cat(outs), [], 0
    for x in xs:
        per.append(y[off:off + x.shape[0]])
        off += x.shape[0]
    return per


def check_equal(what, got, want):
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"{what}: not bit-identical to the eager kernel call (max |err| "
             f"{max_err(got, want) if got.shape == want.shape else 'shape'})")


def phase_serve(dev, card_line):
    """DRService at the wide width (and the paper model's train-while-serve),
    each bucket program and each fused update program a CUDA graph captured
    once; then the threaded DeadlineScheduler with a concurrent register."""
    import torch
    from repro_torch import kernels
    import dataclasses

    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage
    from repro_torch.kernels import autotune, easi_update, fused_transform, ternary_matmul
    from repro_torch.serve import BucketPolicy, DRService

    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    policy = BucketPolicy(**SERVE_BUCKETS)

    def wide_model(backend, mu=2e-4):
        return DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=mu)),
                       execution=Execution(backend=backend, device=dev), block_size=blk)

    def paper_model(backend):
        return DRModel(stages=(RPStage(PAPER["m"], PAPER["p"]),
                               EASIStage.rotation(PAPER["p"], PAPER["n"], mu=PAPER["mu"])),
                       execution=Execution(backend=backend, device=dev),
                       block_size=PAPER["block"])

    wk, wt = wide_model("kernel"), wide_model("torch")
    pk, pt = paper_model("kernel"), paper_model("torch")
    st1 = wk.init(torch.Generator().manual_seed(0))
    st2 = wk.init(torch.Generator().manual_seed(1))
    pst = pk.init(torch.Generator().manual_seed(0))
    xtr, _ = paper_data(dev)
    gen = torch.Generator().manual_seed(21)
    wide_blocks = [torch.randn((blk, m), generator=gen).to(dev) for _ in range(8)]
    reqs = ragged_requests(SERVE_REQUESTS, m, dev, seed=0)
    windows = [reqs[i:i + SERVE_WINDOW] for i in range(0, len(reqs), SERVE_WINDOW)]
    windows += [[torch.randn((k, m), generator=gen).to(dev)] for k in SERVE_BIG]
    probe = [torch.randn((k, m), generator=gen).to(dev) for k in (5, 64, 300)]
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after ------
    svc = DRService(buckets=policy)
    reset_counts()
    t0 = time.perf_counter()
    svc.register("wide", wk, st1)                                  # 1. register
    torch.cuda.synchronize()
    t_register = time.perf_counter() - t0
    met = svc.metrics()
    if met["compile_cache"]["misses"] != len(policy.buckets()) or \
            met["autotunes"] != len(policy.buckets()):
        fail(f"serve: register built {met['compile_cache']['misses']} programs and "
             f"{met['autotunes']} sweeps, want {len(policy.buckets())} each")
    at_register = kernels.launch_counts()
    won = served_tiles(svc, "wide", policy)
    at_register_programs = serve_program_launches(svc)
    # at register every candidate of every bucket's race made one warm-up
    # call and one capture; the losers were dropped
    exe = wk.execution
    first = autotune.TileConfig(exe.tmm_block_m, exe.tmm_block_p, exe.tmm_block_k)
    n_cands, want_register = 0, 0
    for b in policy.buckets():
        for c in autotune.candidates(b, p, m, first=first):
            t = fused_transform.tiles(b, m, p, c.block_m, c.block_p)
            want_register += 2 * (2 if t > 1 else 1)
            n_cands += 1
    if at_register != {**dict.fromkeys(at_register, 0), "fused_transform": want_register}:
        fail(f"serve: register launched {at_register}, want fused_transform {want_register} "
             f"(a warm-up call and a capture of each of {n_cands} candidates)")
    per_bucket = {}
    for b in policy.buckets():
        launched, _ = program_stats(bucket_program(svc, "wide", b))
        w = won[b]
        tiles = fused_transform.tiles(b, m, p, w.block_m, w.block_p)
        if launched != {"fused_transform": 2 if tiles > 1 else 1}:
            fail(f"serve: bucket {b} captured {launched}, want fused_transform's "
                 f"{'two launches (p split)' if tiles > 1 else 'one launch'}")
        per_bucket[b] = {"captured_launches": launched, "tiles": tiles,
                         "won": list(dataclasses.astuple(w.effective(b, p, m))),
                         "body": "dense" if tiles == 0 else "sparse, one p tile" if tiles == 1
                         else f"sparse, p split in {tiles} (+ summing launch)"}

    def replays():
        return sum(program_stats(bucket_program(svc, "wide", b))[1] for b in policy.buckets())

    before, r0 = kernels.launch_counts(), replays()                  # 2. ragged stream
    served = []
    t0 = time.perf_counter()
    for win in windows:
        tickets = [svc.submit("wide", x) for x in win]
        svc.flush()
        served.append([t.result() for t in tickets])
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    stream_launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    stream_replays = replays() - r0
    stream_batches = svc.metrics()["batches_run"]
    if any(stream_launches.values()):
        fail(f"serve: the ragged stream launched kernels outside a graph: {stream_launches}")
    misses0 = svc.cache.misses

    v = svc.registry.push("wide", st2)                              # 3. promote, rollback
    svc.promote("wide", v)
    after_promote = [svc.transform("wide", x) for x in probe]
    svc.rollback("wide")
    after_rollback = [svc.transform("wide", x) for x in probe]
    if svc.cache.misses != misses0:
        fail(f"serve: promote / rollback built programs ({misses0} -> {svc.cache.misses})")

    svc.register("paper", pk, pst)                                  # 4. train-while-serve
    paper_blocks = xtr[:(4000 // PAPER["block"]) * PAPER["block"]].reshape(
        -1, PAPER["block"], PAPER["m"])
    paper_answers = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e in range(PAPER["epochs"]):
        for i, xb in enumerate(paper_blocks):
            y = svc.serve_and_update("paper", xb)
            if i == e:                       # one answer a block, kept for the check
                paper_answers.append((i, y))
    torch.cuda.synchronize()
    t_paper_tws = time.perf_counter() - t0
    svc.promote("paper")
    wide_live = svc.registry.get("wide").state
    wide_answers = [svc.serve_and_update("wide", xb) for xb in wide_blocks]
    torch.cuda.synchronize()
    svc.promote("wide")
    counts = kernels.launch_counts()
    by_program = serve_program_launches(svc)
    # ---- end of the main path ----------------------------------------------

    # Every launch the wrappers counted on the main path after register is a
    # program's warm-up call or its capture: nothing ran eagerly besides.
    for k, v in counts.items():
        built = (by_program["warmup"][k] + by_program["captured"][k]
                 - at_register_programs["warmup"][k] - at_register_programs["captured"][k])
        if v - at_register[k] != built:
            fail(f"serve: {k} counted {v - at_register[k]} launches on the serving path after "
                 f"register, but the programs built since account for {built}")

    missing = [k for k in ("ternary_matmul", "fused_transform", "easi_apply") if counts[k] <= 0]
    if missing:
        fail(f"serve: kernels never launched on the serving path: {missing}")
    fused_programs = {}
    models = {(PAPER["block"], PAPER["m"]): pk, (blk, m): wk}
    for key in list(svc.cache._d):
        if key[0] != "fused":
            continue
        launched, reps = program_stats(svc.cache._d[key])
        mdl, rows = models[key[2]], key[2][0]
        mi, pi, ni = mdl.in_dim, mdl.stages[0].out_dim, mdl.out_dim
        bodies = {"ternary_matmul": ternary_matmul.plan(rows, mi, pi),
                  "fused_transform": fused_transform.tiles(rows, mi, pi),
                  "easi_apply": easi_update.plan(rows, ni, pi, False, True)[0]}
        want = {"ternary_matmul": 1, "fused_transform": 2 if bodies["fused_transform"] > 1 else 1,
                "easi_apply": 2 if bodies["easi_apply"] else 1}
        if launched != want:
            fail(f"serve: the fused update program {key[2]} captured {launched}, want {want} "
                 f"(bodies {bodies})")
        fused_programs[str(key[2])] = {"captured_launches": launched, "replays": reps,
                                       "bodies (plan / tiles / easi slices)": bodies}

    # ---- checks ------------------------------------------------------------
    n_req = 0
    for win, outs in zip(windows, served):
        for x, got, want in zip(win, outs, eager_served(wk, st1, win, policy, won)):
            check_equal(f"serve: a request of {x.shape[0]} rows", got, want)
            check_close(f"serve: a request of {x.shape[0]} rows against the torch backend",
                        got, wt.transform(st1, x), **OUT_TOL)
            n_req += 1
    for x, a, r in zip(probe, after_promote, after_rollback):
        check_equal(f"serve: {x.shape[0]} rows after promote", a,
                    eager_served(wk, st2, [x], policy, won)[0])
        check_equal(f"serve: {x.shape[0]} rows after rollback", r,
                    eager_served(wk, st1, [x], policy, won)[0])
    for i, y in paper_answers:
        check_equal(f"serve: paper answer to block {i}", y, pk.transform(pst, paper_blocks[i]))
    fitted = pt.fit(pst, xtr, epochs=PAPER["epochs"])
    promoted = svc.registry.get("paper").state
    if int(promoted.steps) != int(fitted.steps):
        fail(f"serve: paper steps {int(promoted.steps)} after stream + promote, fit "
             f"{int(fitted.steps)}")
    err_paper = check_close("serve: paper B after stream + promote against fit (torch)",
                            promoted.b, fitted.b, **TRAJ_TOL)
    check_close("serve: paper R", promoted.r, fitted.r, rtol=0, atol=0)
    for xb, y in zip(wide_blocks, wide_answers):
        check_equal("serve: wide answer while training", y, wk.transform(wide_live, xb))
    wfit = wt.fit(wide_live, torch.cat(wide_blocks), epochs=1)
    wprom = svc.registry.get("wide").state
    if int(wprom.steps) != int(wfit.steps):
        fail(f"serve: wide steps {int(wprom.steps)}, fit {int(wfit.steps)}")
    err_wide = check_close("serve: wide B after stream + promote against fit (torch)",
                           wprom.b, wfit.b, **TRAJ_TOL)
    print(f"[serve] ({card_line}) register: {len(policy.buckets())} bucket programs captured in "
          f"{t_register:.3f} s ({met['autotunes']} sweeps, {n_cands} candidates raced); per "
          f"bucket: "
          + "; ".join(f"{b}: {v['captured_launches']} ({v['body']})" for b, v in per_bucket.items()))
    print(f"[serve] ({card_line}) ragged stream: {n_req} requests ({sum(x.shape[0] for w in windows for x in w)} "
          f"rows, windows of {SERVE_WINDOW}, plus {SERVE_BIG}) in {stream_batches} device "
          f"batches = {stream_replays} graph replays, no eager launch; bit-identical to the "
          f"eager kernel call on the padded buckets, within OUT_TOL of the torch backend; "
          f"promote / rollback followed, cache misses {misses0} before and after")
    print(f"[serve] ({card_line}) train-while-serve: paper {len(paper_blocks) * PAPER['epochs']} blocks of "
          f"{PAPER['block']} then promote = fit (torch) within TRAJ_TOL (max |dB| "
          f"{err_paper:.3e}, steps {int(promoted.steps)}); wide 8 blocks of {blk} (max |dB| "
          f"{err_wide:.3e}); answers bit-identical to the live state's eager call; fused "
          f"programs {json.dumps(fused_programs)}; launches on the serving path "
          f"{json.dumps(counts)} (at register {json.dumps(at_register)}) = warm-up calls "
          f"{json.dumps(by_program['warmup'])} + captures {json.dumps(by_program['captured'])}; "
          f"kernel runs in graph replays {json.dumps(by_program['replayed'])}")

    sched_reqs = ragged_requests(SERVE_REQUESTS, m, dev, seed=1)
    other = (wide_model("kernel", mu=1e-4), wk.init(torch.Generator().manual_seed(5)))
    sched_stats = {"with_register": run_scheduler(dev, policy, wk, wt, st1, sched_reqs,
                                                  card_line, other),
                   "steady": run_scheduler(dev, policy, wk, wt, st1, sched_reqs, card_line),
                   "steady_switch_0.1ms": run_scheduler(dev, policy, wk, wt, st1, sched_reqs,
                                                        card_line, switch_ms=0.1)}
    timings = serve_timings(dev, svc, wk, pk, st1, pst, xtr, policy, card_line)
    out = {
        "card": card_line, "launches": counts, "launches_at_register": at_register,
        "launches_by_program": by_program,
        "per_bucket": {str(b): v for b, v in per_bucket.items()},
        "fused_programs": fused_programs,
        "stream": {"requests": n_req, "rows": sum(x.shape[0] for w in windows for x in w),
                   "batches": stream_batches, "replays": stream_replays, "s": t_stream,
                   "rows_per_s": sum(x.shape[0] for w in windows for x in w) / t_stream,
                   "slo": svc.metrics()["slo"]["wide"]},
        "train_while_serve": {
            "paper_blocks": len(paper_blocks) * PAPER["epochs"], "paper_s": t_paper_tws,
            "paper_rows_per_s": len(paper_blocks) * PAPER["epochs"] * PAPER["block"] / t_paper_tws,
            "paper_max_abs_dB": err_paper, "wide_max_abs_dB": err_wide},
        "scheduler": sched_stats, "timings": timings, "register_s": t_register,
    }
    print(f"[serve] ({card_line}) served {out['stream']['rows_per_s']:.0f} rows/s over the "
          f"ragged stream (host clock, ends in a synchronize); train-while-serve "
          f"{out['train_while_serve']['paper_rows_per_s']:.0f} rows/s at the paper width")
    return out


# ---------------------------------------------------------------------------
# phase: every kernel body's resources on the card against the resource model
# ---------------------------------------------------------------------------

def phase_resources(card_line):
    """Each template instance of every kernel body (resource_model.every_instance):
    cudaFuncGetAttributes (csrc/attributes.cu) against the model.  Static and
    dynamic shared bytes must be equal, the registers the compiler gave at
    most the __launch_bounds__ ceiling, and the CTAs an SM holds at least the
    model's (which counts every thread at that ceiling); local (spilled) bytes
    are printed."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import resource_model as rm

    lib = _build.library()
    rows, bad = [], []
    for est in rm.every_instance():
        name = f"{est.kernel}<{est.variant}>"
        bad += est.validate()
        out = (ctypes.c_int * 7)()
        _build.raise_on_error(f"attributes of {name}",
                              lib.repro_kernel_attributes(*est.lookup, est.threads, out))
        regs, static, local, max_threads, dyn, ctas, _ = list(out)
        if static != est.static_smem:
            bad.append(f"{name}: static shared {static} B on the card, model {est.static_smem}")
        if dyn != est.dynamic_smem:
            bad.append(f"{name}: dynamic shared {dyn} B requested, model {est.dynamic_smem}")
        if regs > est.reg_ceiling:
            bad.append(f"{name}: {regs} registers > the launch-bounds ceiling {est.reg_ceiling}")
        if ctas < est.ctas_per_sm:
            bad.append(f"{name}: {ctas} CTAs an SM on the card, model {est.ctas_per_sm}")
        if max_threads < est.threads:
            bad.append(f"{name}: launches {est.threads} threads, the card allows {max_threads}")
        rows.append({"kernel": est.kernel, "variant": est.variant, "regs": regs,
                     "reg_ceiling": est.reg_ceiling, "static_smem": static,
                     "dynamic_smem": dyn, "local_bytes": local, "ctas_per_sm": ctas,
                     "ctas_per_sm_model": est.ctas_per_sm, "threads": est.threads,
                     "cluster": est.cluster})
    for r in rows:
        print(f"[resources] {r['kernel']}<{r['variant']}>: regs {r['regs']} (ceiling "
              f"{r['reg_ceiling']}), smem static {r['static_smem']} dynamic {r['dynamic_smem']}, "
              f"local {r['local_bytes']} B, CTAs/SM {r['ctas_per_sm']} (model "
              f"{r['ctas_per_sm_model']})")
    if bad:
        fail("resources: " + "; ".join(bad))
    spills = sorted({f"{r['kernel']}<{r['variant']}>" for r in rows if r["local_bytes"]})
    print(f"[resources] ({card_line}) {len(rows)} template instances of "
          f"{len({r['kernel'] for r in rows})} bodies match the model; spilling: {spills or 'none'}")
    return rows


# ---------------------------------------------------------------------------
# phase: the tile race at register
# ---------------------------------------------------------------------------

def phase_autotune(dev, card_line):
    """The wide model (B1's race) and an RP-only model of the wide width (B3's
    race) registered at buckets 8 … 1024 on a real clock: register seconds
    with one candidate a bucket (the model's own tiles) and with the race;
    per bucket the candidates, their times and the winner; every candidate's
    answer within OUT_TOL of the plain version; the captured winner
    bit-identical to the eager call under its tiles; a second host on a real
    clock choosing the same tiles and serving the same bits."""
    from unittest import mock

    import torch
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage
    from repro_torch.kernels import autotune, fused_transform, ternary_matmul
    from repro_torch.serve import BucketPolicy, DRService, MonotonicClock

    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    policy = BucketPolicy(**SERVE_BUCKETS)
    exe = Execution(backend="kernel", device=dev)
    first = autotune.TileConfig(exe.tmm_block_m, exe.tmm_block_p, exe.tmm_block_k)
    models = {"wide": DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)),
                              execution=exe, block_size=blk),
              "rp": DRModel(stages=(RPStage(m, p),), execution=exe, block_size=blk)}
    gen = torch.Generator().manual_seed(31)
    out = {}
    for name, model in models.items():
        state = model.init(torch.Generator().manual_seed(0))
        one = lambda rows, p_, m_, first=None, **kw: (first,)   # noqa: E731
        with mock.patch.object(autotune, "candidates", one):
            svc1 = DRService(buckets=policy, clock=MonotonicClock())
            t0 = time.perf_counter()
            svc1.register(name, model, state)
            torch.cuda.synchronize()
            t_one = time.perf_counter() - t0
        del svc1
        svc = DRService(buckets=policy, clock=MonotonicClock())
        t0 = time.perf_counter()
        svc.register(name, model, state)
        torch.cuda.synchronize()
        t_race = time.perf_counter() - t0
        # a second host on a real clock races the same model: its winners,
        # and with them its answers' bits, must be the first host's
        twin = DRService(buckets=policy, clock=MonotonicClock())
        twin.register(name, model, state)
        won, twin_won = served_tiles(svc, name, policy), served_tiles(twin, name, policy)
        if won != twin_won:
            fail(f"autotune: {name}: two hosts on a real clock chose different tiles: "
                 + ", ".join(f"bucket {b} {won[b]} / {twin_won[b]}" for b in won
                             if won[b] != twin_won[b]))
        r = state.stages[0]
        scale = model.stages[0].rp_cfg(exe).scale
        per_bucket = {}
        for b in policy.buckets():
            prog = svc._transform_fn(svc.registry.get(name), b, torch.float32)
            cands = autotune.candidates(b, p, m, first=first)
            if not isinstance(prog, autotune.TunedProgram) or \
                    set(prog.timings_ms) != set(cands):
                fail(f"autotune: {name} bucket {b}: the race did not time {cands}")
            x = torch.randn((b, m), generator=gen).to(dev)
            if name == "wide":
                want = fused_transform.plain(x, r, state.stages[1], scale=scale)
            else:
                want = ternary_matmul.plain(x, r, scale=scale)
            worst = 0.0
            for c in cands:
                kw = dict(scale=scale, block_m=c.block_m, block_p=c.block_p)
                got = (fused_transform.fused_transform(x, r, state.stages[1], **kw)
                       if name == "wide" else ternary_matmul.ternary_matmul(x, r, **kw))
                worst = max(worst, check_close(
                    f"autotune: {name} bucket {b} tiles {c.effective(b, p, m)}", got, want,
                    **OUT_TOL))
            served = svc.transform(name, x)
            check_equal(f"autotune: {name} bucket {b}, the captured winner",
                        served, with_tiles(model, prog.tiles).transform(state, x))
            check_equal(f"autotune: {name} bucket {b}, two hosts on a real clock",
                        twin.transform(name, x), served)
            eff = lambda c: "x".join(map(str, dataclasses.astuple(c.effective(b, p, m))))  # noqa
            per_bucket[str(b)] = {"winner": eff(prog.tiles),
                                  "timings_ms": {eff(c): t for c, t in prog.timings_ms.items()},
                                  "candidates": len(cands), "max_abs_err": worst}
            print(f"[autotune] ({card_line}) {name} bucket {b}: winner {eff(prog.tiles)}; "
                  + ", ".join(f"{eff(c)} {t:.4f}" for c, t in prog.timings_ms.items())
                  + f" ms a call (device time: the fastest of 3 samples of 16 replays between "
                  f"CUDA events); largest |err| against the plain version {worst:.3e}")
        out[name] = {"register_s_one_candidate": t_one, "register_s_race": t_race,
                     "per_bucket": per_bucket}
        print(f"[autotune] ({card_line}) {name}: register {t_one:.3f} s with one candidate a "
              f"bucket, {t_race:.3f} s with the race "
              f"({sum(v['candidates'] for v in per_bucket.values())} candidates); a second "
              f"host on a real clock chose the same tiles at every bucket and served the same "
              f"bits")
    return out


def run_scheduler(dev, policy, wk, wt, st1, reqs, card_line, other=None, switch_ms=None):
    """SCHED_CLIENTS client threads submit `reqs` (each a window of
    SERVE_WINDOW at a time) to a threaded DeadlineScheduler (real clock, 2 ms
    budget, 1 ms wake lead) over a fresh service holding the wide model.
    With `other` = (model, state), one more thread registers it meanwhile:
    its programs are captured while the loop replays the wide model's.  With
    `switch_ms`, the interpreter's thread switch interval is set to it for the
    run (Python's default is 5 ms)."""
    import threading

    import torch
    from repro_torch.serve import DeadlineScheduler, DRService, MonotonicClock

    svc = DRService(buckets=policy, clock=MonotonicClock())
    svc.register("wide", wk, st1)
    torch.cuda.synchronize()
    results, errors = {}, []

    def client(c):
        try:
            mine = list(range(c, len(reqs), SCHED_CLIENTS))
            for i in range(0, len(mine), SERVE_WINDOW):
                win = mine[i:i + SERVE_WINDOW]
                tickets = [(j, sched.submit("wide", reqs[j])) for j in win]
                for j, t in tickets:
                    if not t.wait(60.0):
                        errors.append(f"client {c}: request {j} unresolved after 60 s")
                        return
                    results[j] = t.result()
        except Exception as e:                    # noqa: BLE001 — reported below
            errors.append(f"client {c}: {e!r}")

    def registrar():
        try:
            svc.register("other", *other)
        except Exception as e:                    # noqa: BLE001 — reported below
            errors.append(f"register: {e!r}")

    sched = DeadlineScheduler(svc, default_max_delay_ms=2.0, wake_lead_ms=1.0)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(SCHED_CLIENTS)]
    if other is not None:
        threads.append(threading.Thread(target=registrar))
    default_switch = sys.getswitchinterval()
    if switch_ms is not None:
        sys.setswitchinterval(switch_ms / 1e3)
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(120.0)
        sched.shutdown()
        torch.cuda.synchronize()
    finally:
        sys.setswitchinterval(default_switch)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        fail(f"serve scheduler: {errors or 'a thread did not finish'}")
    if len(results) != len(reqs):
        fail(f"serve scheduler: {len(results)} of {len(reqs)} tickets resolved")
    for j, x in enumerate(reqs):
        check_close(f"serve scheduler: request {j} ({x.shape[0]} rows)", results[j],
                    wt.transform(st1, x), **OUT_TOL)
    met = svc.metrics()
    nb = len(policy.buckets()) * (1 if other is None else 2)
    if met["compile_cache"]["misses"] != nb or met["autotunes"] != nb:
        fail(f"serve scheduler: {met['compile_cache']['misses']} programs built, want {nb}")
    if other is not None:
        for b in policy.buckets():
            program_stats(bucket_program(svc, "other", b))
        model, state = other
        check_close("serve scheduler: the model registered under load",
                    svc.transform("other", reqs[0]),
                    model.with_execution(wt.execution).transform(state, reqs[0]), **OUT_TOL)
    n_dl = met["deadline_met"] + met["deadline_missed"]
    cells = {str(b): {"count": c["e2e"]["count"], "p50_ms": c["e2e"]["p50_ms"],
                      "p99_ms": c["e2e"]["p99_ms"], "queue_p99_ms": c["queue_delay"]["p99_ms"],
                      "deadline_miss_rate": c["deadline_miss_rate"]}
             for b, c in sorted(met["slo"]["wide"].items())}
    rows = sum(x.shape[0] for x in reqs)
    print(f"[serve] ({card_line}) scheduler, {SCHED_CLIENTS} clients"
          f"{', a second model registered meanwhile' if other is not None else ''}"
          f"{f', thread switch interval {switch_ms} ms' if switch_ms is not None else ''}: "
          f"{len(reqs)} requests in {wall:.3f} s ({rows / wall:.0f} rows/s), "
          f"{met['batches_run']} device batches, deadline misses {met['deadline_missed']} of "
          f"{n_dl}; e2e per bucket (host clock, ms, p50 / p99): "
          + "; ".join(f"{b}: {c['p50_ms']:.3f} / {c['p99_ms']:.3f} (n {c['count']})"
                      for b, c in cells.items()))
    return {"requests": len(reqs), "rows": rows, "s": wall, "rows_per_s": rows / wall,
            "batches": met["batches_run"], "deadline_met": met["deadline_met"],
            "deadline_missed": met["deadline_missed"],
            "deadline_miss_share": met["deadline_missed"] / n_dl if n_dl else None,
            "e2e_by_bucket": cells}


def serve_timings(dev, svc, wk, pk, st1, pst, xtr, policy, card_line):
    """Device-only ms per wide bucket program: its bare graph replay and one
    call of the service's CapturedProgram (copy-in, replay, copy-out), each
    queued behind a spin.  At the paper and wide widths: host-paced ms (CUDA
    events around back-to-back calls) of a `transform` and a
    `serve_and_update`, through the service's captured programs and as the
    model's eager calls; the device-only ms of the served call (all its device
    work, queued) and of its kernels alone (the eager body in one graph); and
    the idle share, 1 - served device ms / host-paced ms."""
    import torch

    gen = torch.Generator().manual_seed(23)
    per_bucket = {}
    for b in policy.buckets():
        xb = torch.randn((b, wk.in_dim), generator=gen).to(dev)
        prog = captured(bucket_program(svc, "wide", b))
        per_bucket[str(b)] = {"replay_ms": time_queued(prog.graph.replay),
                              "call_ms": time_queued(lambda: prog(st1, xb))}
    print(f"[serve-time] ({card_line}) device-only ms per wide bucket program, bare replay / "
          f"the program's call with its copies: "
          + "; ".join(f"{b}: {fmt_ms(t['replay_ms'])} / {fmt_ms(t['call_ms'])}"
                      for b, t in per_bucket.items()))
    out = {"bucket_device_ms": per_bucket}
    pblk = xtr[:PAPER["block"]]
    wblk = torch.randn((WIDE["block"], WIDE["m"]), generator=gen).to(dev)
    for width, name, model, state, x in (("paper", "paper", pk, pst, pblk),
                                         ("wide", "wide", wk, st1, wblk)):
        live = svc.registry.get(name).state
        chain = [live]

        def eager_tws():
            y = model.transform(live, x)
            chain[0] = model.update(chain[0], x)
            return y

        snap = svc.registry.get(name)
        prog = captured(bucket_program(svc, name, policy.bucket_for(x.shape[0])))
        fused = captured(svc._fused_update_fn(snap, x))
        xr = x[:x.shape[0] * 3 // 4]
        row = {
            # the captured path's host time, split: the service around the
            # program, the program's own call (copies, replay, clones), and
            # the bare replay
            "transform_program_call_ms": time_events(lambda: prog(live, x)),
            "transform_replay_ms": time_events(prog.graph.replay),
            "serve_and_update_program_call_ms": time_events(lambda: fused(live, live, x)),
            "serve_and_update_replay_ms": time_events(fused.graph.replay),
            "transform_captured_ms": time_events(lambda: svc.transform(name, x)),
            "transform_eager_ms": time_events(lambda: model.transform(live, x)),
            "transform_served_device_ms": time_queued(lambda: svc.transform(name, x)),
            "transform_kernels_device_ms": time_graph(lambda: model.transform(live, x)),
            # 3/4 of the rows: the program pads them in its own buffer
            "transform_ragged_captured_ms": time_events(lambda: svc.transform(name, xr)),
            "transform_ragged_served_device_ms": time_queued(lambda: svc.transform(name, xr)),
            "serve_and_update_captured_ms": time_events(lambda: svc.serve_and_update(name, x)),
            "serve_and_update_eager_ms": time_events(eager_tws),
            "serve_and_update_served_device_ms": time_queued(
                lambda: svc.serve_and_update(name, x)),
            "serve_and_update_kernels_device_ms": time_graph(
                lambda: (model.transform(live, x), model.update(live, x))),
            "rows": int(x.shape[0]), "ragged_rows": int(xr.shape[0]),
        }
        for what in ("transform", "serve_and_update"):
            dev_ms = row[f"{what}_served_device_ms"]
            row[f"{what}_idle_share"] = (None if dev_ms is None
                                         else 1 - dev_ms / row[f"{what}_captured_ms"])
        out[width] = row
        print(f"[serve-time] ({card_line}) {width} ({x.shape[0]} rows): transform "
              f"{row['transform_captured_ms']:.4f} ms captured / {row['transform_eager_ms']:.4f} "
              f"eager, host-paced; on the device {fmt_ms(row['transform_served_device_ms'])} for "
              f"the served call, {row['transform_kernels_device_ms']:.4f} for its kernels (idle "
              f"share captured {fmt_share(row['transform_idle_share'])}); {xr.shape[0]} rows "
              f"padded in the program: {row['transform_ragged_captured_ms']:.4f} host-paced, "
              f"{fmt_ms(row['transform_ragged_served_device_ms'])} on the device; serve_and_update "
              f"{row['serve_and_update_captured_ms']:.4f} captured / "
              f"{row['serve_and_update_eager_ms']:.4f} eager; on the device "
              f"{fmt_ms(row['serve_and_update_served_device_ms'])} served, "
              f"{row['serve_and_update_kernels_device_ms']:.4f} kernels (idle share captured "
              f"{fmt_share(row['serve_and_update_idle_share'])}); of the captured calls, the "
              f"program's own call {row['transform_program_call_ms']:.4f} / "
              f"{row['serve_and_update_program_call_ms']:.4f}, a bare replay "
              f"{row['transform_replay_ms']:.4f} / {row['serve_and_update_replay_ms']:.4f}")
    return out


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f}"


def fmt_share(x):
    return "not measured" if x is None else f"{x:.2f}"


# ---------------------------------------------------------------------------
# phase 5b: the replicated fleet, three hosts in one process
# ---------------------------------------------------------------------------

FLEET_HOSTS = ("h0", "h1", "h2")
FLEET_TIMEOUTS_MS = (500.0, 60.0, 80.0)   # pinned: h1 campaigns first once h0 is cut
FLEET_HEARTBEAT_MS = 5.0
FLEET_SHARD_BLOCKS = 4     # wide blocks each host trains on, per shard
FLEET_ROUNDS = 8           # merge rounds at the default CompressConfig (K)
FLEET_TCP_TIMEOUT_S = 240  # per child of [fleet-tcp]
SKETCH_TOL = dict(rtol=1e-5, atol=1e-6)


def fleet_host(bus, clock, hid, policy, *, data_dir=None, elect=True, leader="h0",
               sync_on_start=True):
    """One fleet host: a ReplicatedRegistry (durable when given a data_dir),
    a pumped Elector on the shared VirtualClock, a DRService over the
    registry and a FleetMerger, all in a dict."""
    from repro_torch.dist import compress
    from repro_torch.serve import DRService, Elector, FleetMerger, ReplicatedRegistry

    index = FLEET_HOSTS.index(hid)
    reg = ReplicatedRegistry(bus.attach(hid), role="leader" if hid == leader else "follower",
                             leader=leader, sync_on_start=sync_on_start,
                             data_dir=None if data_dir is None else str(data_dir / hid))
    t = FLEET_TIMEOUTS_MS[index]
    elector = (Elector(reg, clock=clock, seed=index, election_timeout_ms=(t, t),
                       heartbeat_interval_ms=FLEET_HEARTBEAT_MS) if elect else None)
    svc = DRService(buckets=policy, clock=clock, registry=reg)
    merger = FleetMerger(svc, compress_cfg=compress.CompressConfig(ratio=1))
    return {"id": hid, "reg": reg, "elector": elector, "svc": svc, "merger": merger}


def pump_elections(bus, clock, hosts, max_ms=60_000.0):
    """Advance the shared VirtualClock to the earliest reachable elector
    deadline and poll every reachable elector, until the reachable hosts
    agree on one leader; returns its id."""
    spent = 0.0
    while True:
        cut = set(bus.partitioned())
        live = [h for h in hosts if h["id"] not in cut]
        leaders = [h for h in live if h["reg"].role == "leader"]
        if len(leaders) == 1 and all(h["reg"].leader == leaders[0]["id"]
                                     and h["reg"].term == leaders[0]["reg"].term for h in live):
            return leaders[0]["id"]
        if spent >= max_ms:
            fail(f"fleet: no agreed leader within {max_ms} virtual ms: "
                 f"{[h['elector'].status() for h in live]}")
        step = max(0.0, min(h["elector"].deadline_ms() for h in live) - clock.now()) + 0.001
        clock.advance(step)
        spent += step
        for h in live:
            h["elector"].poll()


def installed_off_card(hosts, name, dev):
    """(host, version, path) of every installed stage tensor that does not
    lie on `dev`'s type (the card); `steps` is the host counter every
    ModelState keeps."""
    from repro_torch import tree as tree_mod

    bad = []
    for h in hosts:
        reg = h["reg"]
        for v in range(reg.n_versions(name)):
            st = reg.state(name, v)
            for path, leaf in tree_mod.flatten_with_path(st.stages):
                if leaf.device.type != dev.type:
                    bad.append((h["id"], v, path, str(leaf.device)))
            if st.steps.device.type != "cpu":
                bad.append((h["id"], v, ".steps", str(st.steps.device)))
    return bad


def carry_norm(hosts, name):
    """‖carry‖ over every host's float carry leaves (the un-installed signal)."""
    from repro_torch import tree as tree_mod

    total = 0.0
    for h in hosts:
        carry = h["merger"].residual(name)
        if carry is not None:
            total += sum(float((leaf.float() ** 2).sum()) for leaf in tree_mod.leaves(carry)
                         if leaf.dtype.is_floating_point)
    return total ** 0.5


class CallMeter:
    """While installed, counts the calls of a few module functions and sums
    their host time (ms), by label: where a merge round's time goes."""

    def __init__(self, targets):
        self.targets = targets          # (module, attribute, label)
        self.count = dict.fromkeys((label for _, _, label in targets), 0)
        self.ms = dict.fromkeys(self.count, 0.0)
        self._saved = []

    def __enter__(self):
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def timed_call(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.count[_label] += 1
                    self.ms[_label] += (time.perf_counter() - t0) * 1e3

            setattr(mod, attr, timed_call)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        return False

    def snapshot(self):
        return {k: (self.count[k], self.ms[k]) for k in self.count}


def run_merge_rounds(hosts, shards, cfgs, sync, meter=None):
    """Each host streams its shard through `serve_and_update`; then one merge
    round per entry of `cfgs` on the leader (every merger set to that
    CompressConfig), a new shard before each round whose index has one.
    Returns per round: its report, host-paced ms, the merged live state's B
    and steps, the carry norm after the round, and what `meter` saw during
    the round (calls, ms by label)."""
    out = []
    for k, cfg in enumerate(cfgs):
        if k in shards:
            for h, shard in zip(hosts, shards[k]):
                for xb in shard:
                    h["svc"].serve_and_update("wide", xb)
        for h in hosts:
            h["merger"].cfg = cfg
        sync()
        before = meter.snapshot() if meter is not None else {}
        t0 = time.perf_counter()
        report = hosts[0]["merger"].merge_round("wide")
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        after = meter.snapshot() if meter is not None else {}
        st = hosts[0]["reg"].get("wide").state
        out.append({"report": report, "ms": ms, "b": st.b.clone(), "steps": int(st.steps),
                    "carry": carry_norm(hosts, "wide"),
                    "calls": {k: [after[k][0] - before[k][0], after[k][1] - before[k][1]]
                              for k in after}})
    return out


def serve_windows(svc, name, reqs):
    """`reqs` through `svc`'s queue SERVE_WINDOW at a time (submit, flush);
    the answers in order."""
    answers = []
    for i in range(0, len(reqs), SERVE_WINDOW):
        tickets = [svc.submit(name, x) for x in reqs[i:i + SERVE_WINDOW]]
        svc.flush()
        answers += [t.result() for t in tickets]
    return answers


def phase_fleet(dev, card_line):
    """Three DRService hosts on one LocalBus and one VirtualClock, every host
    on the card: register + serve, train-while-serve on disjoint shards and
    merge rounds through the RP sketch (B3), failover with fencing, and
    crash recovery from the data_dir; then the same merges on a torch-backend
    fleet as the reference."""
    import os
    import shutil

    import torch
    from repro_torch import kernels
    from repro_torch.dist import compress
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage
    from repro_torch.kernels import ternary_matmul
    from repro_torch.serve import BucketPolicy, LocalBus, ReplicationError, VirtualClock
    from repro_torch.serve.durability import state_hash

    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    policy = BucketPolicy(**SERVE_BUCKETS)

    def wide_model(backend):
        return DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)),
                       execution=Execution(backend=backend, device=dev), block_size=blk)

    wk, wt = wide_model("kernel"), wide_model("torch")
    st1 = wk.init(torch.Generator().manual_seed(0))
    st_failover = wk.init(torch.Generator().manual_seed(2))
    st_down = wk.init(torch.Generator().manual_seed(3))
    reqs = ragged_requests(SERVE_REQUESTS, m, dev, seed=0)
    thirds = [reqs[i::len(FLEET_HOSTS)] for i in range(len(FLEET_HOSTS))]
    gen = torch.Generator().manual_seed(31)
    shards = {k: [[(torch.randn((blk, m), generator=gen) + 0.25 * i).to(dev)
                   for _ in range(FLEET_SHARD_BLOCKS)] for i in range(len(FLEET_HOSTS))]
              for k in (0, 1)}
    cfgs = [compress.CompressConfig(ratio=1)] + [compress.CompressConfig()] * FLEET_ROUNDS
    root = ROOT / "build" / "chip_smoke_fleet"
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    sketches = []
    real_sketch = compress._sketch

    def recording_sketch(chunks, r, backend):
        y = real_sketch(chunks, r, backend)
        sketches.append((chunks.clone(), r.clone(), y.clone(), backend))
        return y

    try:
        # ---- the main path: counts set to 0 just before, read just after --
        clock, bus = VirtualClock(), LocalBus()
        hosts = [fleet_host(bus, clock, hid, policy, data_dir=root / "kernel")
                 for hid in FLEET_HOSTS]
        reset_counts()
        hosts[0]["svc"].register("wide", wk, st1)                    # 1. register, serve
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = [serve_windows(h["svc"], "wide", third) for h, third in zip(hosts, thirds)]
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        off_card_serve = installed_off_card(hosts, "wide", dev)
        # the leader answers the followers' rows in the same windows
        leader_answers = [served[0]] + [serve_windows(hosts[0]["svc"], "wide", third)
                                        for third in thirds[1:]]
        compress._sketch = recording_sketch                           # 2. train, merge
        meter = CallMeter([(os, "fsync", "fsync"), (compress, "_rp_matrix", "R draw (CPU)"),
                           (compress, "_ls_decode", "LS decode"),
                           (compress, "_sketch", "sketch")])
        try:
            with meter:
                t0 = time.perf_counter()
                rounds = run_merge_rounds(hosts, shards, cfgs, torch.cuda.synchronize, meter)
                t_train_merge = time.perf_counter() - t0
        finally:
            compress._sketch = real_sketch
        bus.partition("h0")                                           # 3. failover
        winner = pump_elections(bus, clock, hosts[1:])
        new = hosts[FLEET_HOSTS.index(winner)]
        v_failover = new["reg"].promote("wide", new["reg"].push("wide", st_failover))
        bus.heal("h0")
        try:
            hosts[0]["reg"].promote("wide", 0)
            fenced = None
        except ReplicationError as exc:
            fenced = str(exc)
        old_status = hosts[0]["reg"].leader_status()
        hosts[0]["reg"].sync()
        failover_hashes = [state_hash(h["reg"].get("wide").state) for h in hosts]
        crashed = hosts.pop(2)                                        # 4. crash, restart
        bus.detach(crashed["id"])
        del crashed
        v_down = new["reg"].promote("wide", new["reg"].push("wide", st_down))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restarted = fleet_host(bus, clock, "h2", policy, data_dir=root / "kernel", leader=winner,
                               sync_on_start=False)
        restarted["reg"].join()
        t_recover = time.perf_counter() - t0
        hosts.append(restarted)
        recovered_hash = state_hash(restarted["reg"].get("wide").state)
        live_hash = state_hash(new["reg"].get("wide").state)
        before = kernels.launch_counts()
        recovered_answers = [restarted["svc"].transform("wide", x) for x in thirds[2][:16]]
        torch.cuda.synchronize()
        restart_launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        counts = all_counts()
        # ---- end of the main path ------------------------------------------
        off_card_end = installed_off_card(hosts, "wide", dev)
        live_state = new["reg"].get("wide").state
        recovered_versions = [h["reg"].get("wide").version for h in hosts]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- checks --------------------------------------------------------------
    missing = [k for k in ("ternary_matmul", "fused_transform", "easi_apply") if counts[k] <= 0]
    if missing:
        fail(f"fleet: kernels never launched on the fleet path: {missing} ({counts})")
    if off_card_serve or off_card_end:
        fail(f"fleet: installed states off the card: {(off_card_serve + off_card_end)[:8]}")
    n_req = 0
    for i, (answers, lead) in enumerate(zip(served, leader_answers)):
        for x, got, want in zip(thirds[i], answers, lead):
            check_equal(f"fleet: host h{i}'s answer to {x.shape[0]} rows against the leader's",
                        got, want)
            check_close(f"fleet: host h{i}'s answer against the torch backend", got,
                        wt.transform(st1, x), **OUT_TOL)
            n_req += 1
    exact, compressed = rounds[0], rounds[1:]
    total_blocks = len(FLEET_HOSTS) * FLEET_SHARD_BLOCKS
    if exact["report"]["version"] is None or exact["steps"] != total_blocks:
        fail(f"fleet: the ratio-1 round installed {exact['report']['version']} with steps "
             f"{exact['steps']}, "
             f"want the fleet's {total_blocks} blocks")
    if sorted(exact["report"]["contributors"]) != list(FLEET_HOSTS):
        fail(f"fleet: ratio-1 contributors {exact['report']['contributors']}")
    if compressed[-1]["steps"] != 2 * total_blocks:
        fail(f"fleet: steps {compressed[-1]['steps']} after the compressed rounds, want "
             f"{2 * total_blocks}")
    if not compressed[-1]["carry"] < compressed[0]["carry"]:
        fail(f"fleet: the carry's norm did not fall over {FLEET_ROUNDS} rounds: "
             f"{[r['carry'] for r in compressed]}")
    kernel_sketches = [s for s in sketches if s[3] == "kernel"]
    if not kernel_sketches or any(tuple(s[0].shape) != (8, 4096) or tuple(s[1].shape) != (1024, 4096)
                                  for s in kernel_sketches):
        fail(f"fleet: sketches {[(tuple(s[0].shape), tuple(s[1].shape), s[3]) for s in sketches]}, "
             f"want x (8, 4096) against R (1024, 4096) on the kernel backend")
    sketch_err = max(check_close("fleet: B3 sketch against its plain version", y,
                                 ternary_matmul.plain(x, r), **SKETCH_TOL)
                     for x, r, y, _ in kernel_sketches)
    if not fenced or "fenced" not in fenced or old_status["role"] != "follower" or \
            old_status["leader"] != winner:
        fail(f"fleet: the old leader was not fenced after healing ({fenced!r}, {old_status})")
    if len(set(failover_hashes)) != 1:
        fail(f"fleet: live hashes after failover differ: {failover_hashes}")
    if recovered_hash != live_hash or len(set(recovered_versions)) != 1:
        fail(f"fleet: the restarted host holds {recovered_hash} (versions {recovered_versions}), "
             f"the fleet {live_hash}")
    if restart_launches.get("fused_transform", 0) <= 0:
        fail(f"fleet: the restarted host served without launching: {restart_launches}")
    for x, got in zip(thirds[2][:16], recovered_answers):
        check_equal(f"fleet: restarted host, {x.shape[0]} rows",
                    got, eager_served(wk, live_state, [x], policy)[0])

    # ---- the reference: the same shards and rounds on a torch-backend fleet
    tclock, tbus = VirtualClock(), LocalBus()
    thosts = [fleet_host(tbus, tclock, hid, policy, elect=False) for hid in FLEET_HOSTS]
    thosts[0]["svc"].register("wide", wt, st1)
    trounds = run_merge_rounds(thosts, shards, cfgs, torch.cuda.synchronize)
    merge_err = []
    for k, (r, tr) in enumerate(zip(rounds, trounds)):
        if r["report"]["salt"] != tr["report"]["salt"] or r["steps"] != tr["steps"]:
            fail(f"fleet: round {k} salt {r['report']['salt']} / {tr['report']['salt']}, "
                 f"steps {r['steps']} / {tr['steps']}")
        merge_err.append(check_close(f"fleet: merged B after round {k} (ratio "
                                     f"{cfgs[k].ratio}) against the torch-backend fleet",
                                     r["b"], tr["b"], **TRAJ_TOL))
    del thosts

    # ---- timings -------------------------------------------------------------
    x8, r8 = kernel_sketches[0][0], kernel_sketches[0][1]
    r8f = r8.to(torch.float32)
    sketch = {"shape": [list(x8.shape), list(r8.shape)], "plan": ternary_matmul.plan(8, 4096, 1024),
              "density": float((r8 != 0).float().mean()),
              "ms": time_events(lambda: ternary_matmul.ternary_matmul(x8, r8)),
              "plain_ms": time_events(lambda: ternary_matmul.plain(x8, r8)),
              "library_ms": time_events(lambda: torch.mm(x8, r8f.T)),
              "device_ms": time_graph(lambda: ternary_matmul.ternary_matmul(x8, r8)),
              "plain_device_ms": time_graph(lambda: ternary_matmul.plain(x8, r8)),
              "library_device_ms": time_graph(lambda: torch.mm(x8, r8f.T)),
              "max_abs_err": sketch_err, "launches": len(kernel_sketches)}
    nbytes = x8.numel() * 4 + r8.numel() + x8.shape[0] * r8.shape[0] * 4
    flops = 2.0 * x8.shape[0] * int((r8 != 0).sum())
    sketch["bound_ms"], sketch["bound_by"] = bound_ms(flops, nbytes)
    rows_trained = 2 * total_blocks * blk
    out = {
        "card": card_line, "launches": counts, "restart_launches": restart_launches,
        "requests": n_req, "served_rows": sum(x.shape[0] for x in reqs),
        "serve_s": t_serve, "served_rows_per_s": sum(x.shape[0] for x in reqs) / t_serve,
        "train_merge_s": t_train_merge, "trained_rows": rows_trained,
        "trained_rows_per_s_with_merges": rows_trained / t_train_merge,
        "round_ms_ratio1": exact["ms"],
        "round_ms_ratio4": [r["ms"] for r in compressed],
        "round_calls": [r["calls"] for r in rounds],
        "bytes_sketched_ratio1": exact["report"]["bytes_sketched"],
        "bytes_sketched_ratio4": compressed[0]["report"]["bytes_sketched"],
        "bytes_uncompressed": exact["report"]["bytes_uncompressed"],
        "carry_norm": [r["carry"] for r in compressed],
        "merge_max_abs_dB_vs_torch": merge_err, "sketch": sketch,
        "failover": {"winner": winner, "version": v_failover, "fenced": fenced},
        "recovery_s": t_recover, "recovered_version": v_down,
    }
    print(f"[fleet] ({card_line}) 3 hosts, {n_req} ragged requests ({out['served_rows']} rows) "
          f"served a third each through their own captured programs at "
          f"{out['served_rows_per_s']:.0f} rows/s (host clock); followers bit-identical to the "
          f"leader, within OUT_TOL of the torch backend; every installed state on the card")
    print(f"[fleet] ({card_line}) train-while-serve {rows_trained} rows on disjoint shards + "
          f"{len(cfgs)} merge rounds in {t_train_merge:.3f} s ({out['trained_rows_per_s_with_merges']:.0f} "
          f"rows/s with the merges); merge round ms (host-paced) ratio 1: {exact['ms']:.3f}, "
          f"ratio 4: " + ", ".join(f"{r['ms']:.3f}" for r in compressed))
    for what, r in (("ratio 1", exact), ("first ratio 4", compressed[0]),
                    ("last ratio 4", compressed[-1])):
        print(f"[fleet] ({card_line}) {what} round, calls / host ms inside it: "
              + "; ".join(f"{k} {c[0]} / {c[1]:.3f}" for k, c in r["calls"].items()))
    print(f"[fleet] ({card_line}) bytes sketched ratio 1 {out['bytes_sketched_ratio1']} / ratio 4 "
          f"{out['bytes_sketched_ratio4']} against tree bytes {out['bytes_uncompressed']} "
          f"({len(FLEET_HOSTS)} bundles); steps exact ({exact['steps']}, then "
          f"{compressed[-1]['steps']}); carry norm {compressed[0]['carry']:.4e} -> "
          f"{compressed[-1]['carry']:.4e} over {FLEET_ROUNDS} rounds; "
          f"merged B against the torch-backend fleet max |dB| {max(merge_err):.3e} (TRAJ_TOL)")
    print(f"[fleet] ({card_line}) sketch x {tuple(x8.shape)} against R {tuple(r8.shape)} int8 "
          f"(density {sketch['density']:.6f}, plan {sketch['plan']}): B3 {sketch['ms']:.4f} ms "
          f"host-paced / {sketch['device_ms']:.4f} device-only, plain {sketch['plain_ms']:.4f} / "
          f"{sketch['plain_device_ms']:.4f}, torch.mm f32 {sketch['library_ms']:.4f} / "
          f"{sketch['library_device_ms']:.4f}, bound "
          f"{sketch['bound_ms']:.6f} ({sketch['bound_by']}); max |err| {sketch_err:.3e} over "
          f"{len(kernel_sketches)} sketches")
    print(f"[fleet] ({card_line}) failover: {winner} elected, promoted v{v_failover}, old leader "
          f"fenced ({fenced[:60]!r}...), hashes agree; crash + promote while down + restart: "
          f"recovered in {t_recover:.4f} s, hash {recovered_hash} = fleet's, restarted host "
          f"re-captured and launched {restart_launches}")
    print(f"[fleet] launches on the fleet path {json.dumps(counts)}")
    return out


# ---------------------------------------------------------------------------
# phase 5c: the fleet over TCP, three processes on one card
# ---------------------------------------------------------------------------

def fleet_tcp_child(role, args, dev=None):
    """One process of [fleet-tcp]: the leader (prints its address, waits for
    two followers, registers, pushes an update and promotes it two-phase,
    serves) or a follower (joins, syncs, waits for the flip, serves).  Every
    model on the card with the kernel backend.  Prints one CHILD json line,
    then stays in the fleet until its stdin closes; raises (exit code 1) on
    any failed check."""
    import torch
    from repro_torch import kernels
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage
    from repro_torch.serve import BucketPolicy, DRService, ReplicatedRegistry, TCPTransport
    from repro_torch.serve.replication import state_hash

    dev = torch.device("cuda", 0) if dev is None else dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    model = DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)),
                    execution=Execution(backend="kernel", device=dev), block_size=blk)
    policy = BucketPolicy(**SERVE_BUCKETS)
    reqs = ragged_requests(24, m, dev, seed=7)
    deadline = time.time() + FLEET_TCP_TIMEOUT_S
    if role == "leader":
        t = TCPTransport("h0")
        print(f"ADDR {t.address[0]} {t.address[1]}", flush=True)
        reg = ReplicatedRegistry(t, role="leader")
        while len(t.peers()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        if len(t.peers()) != 2:
            raise RuntimeError(f"leader: followers never joined ({t.peers()})")
        svc = DRService(buckets=policy, registry=reg)
        s0 = model.init(torch.Generator().manual_seed(0))
        svc.register("wide", model, s0)
        xb = torch.randn((blk, m), generator=torch.Generator().manual_seed(1)).to(dev)
        v = reg.push("wide", model.update(s0, xb))
        if reg.promote("wide", v) != 1:
            raise RuntimeError("leader: the promote did not land on v1")
        fs = reg.fleet_status()
        if len(fs) != 3 or any(s["live"]["wide"] != 1 for s in fs.values()):
            raise RuntimeError(f"leader: fleet status {fs}")
    else:
        hid, host, port = args
        t = TCPTransport(hid)
        t.add_peer("h0", (host, int(port)))
        reg = ReplicatedRegistry(t, role="follower", leader="h0", sync_on_start=False)
        reg.join()
        while time.time() < deadline:
            try:
                if reg.get("wide").version == 1:
                    break
            except KeyError:
                pass
            time.sleep(0.05)
        svc = DRService(buckets=policy, registry=reg)
    snap = reg.get("wide")
    if snap.version != 1:
        raise RuntimeError(f"{t.host_id}: live version {snap.version}, want 1")
    off = [(v, i) for v in range(reg.n_versions("wide"))
           for i, s in enumerate(reg.state("wide", v).stages) if s.device.type != dev.type]
    if off:
        raise RuntimeError(f"{t.host_id}: installed stages off the card: {off}")
    tickets = [svc.submit("wide", x) for x in reqs]
    svc.flush()
    won = served_tiles(svc, "wide", policy)
    for x, tk, want in zip(reqs, tickets, eager_served(model, snap.state, reqs, policy, won)):
        if not torch.equal(tk.result(), want):
            raise RuntimeError(f"{t.host_id}: {x.shape[0]} rows not bit-identical to the eager "
                               f"kernel call")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    need = ("ternary_matmul", "fused_transform", "easi_apply") if role == "leader" \
        else ("fused_transform",)
    if any(counts[k] <= 0 for k in need):
        raise RuntimeError(f"{t.host_id}: kernels did not launch: {counts}")
    print("CHILD " + json.dumps({"host": t.host_id, "version": snap.version,
                                 "hash": state_hash(snap.state), "launches": counts,
                                 "requests": len(reqs)}), flush=True)
    sys.stdin.read()           # stay in the fleet until the parent closes stdin
    t.close()
    return 0


def phase_fleet_tcp(card_line):
    """[fleet-tcp]: a leader and two followers as three fresh python3
    processes on the one card, over TCPTransport on 127.0.0.1.  Each child
    has a timeout; any child's failure fails the phase, and every child still
    running then is killed."""
    import queue
    import threading

    lines = queue.Queue()        # (child index, stdout line or None at EOF)
    children = []

    def spawn(*args):
        index = len(children)
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--fleet-tcp-child", *args], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        errs = []
        threading.Thread(target=lambda: [lines.put((index, l)) for l in proc.stdout]
                         + [lines.put((index, None))], daemon=True).start()
        err_reader = threading.Thread(target=lambda: errs.extend(proc.stderr), daemon=True)
        err_reader.start()
        children.append({"proc": proc, "errs": errs, "err_reader": err_reader,
                         "args": args, "result": None})
        return children[-1]

    def tail(child):
        try:
            child["proc"].wait(timeout=10)
        except subprocess.TimeoutExpired:
            child["proc"].kill()
        child["err_reader"].join(timeout=10)
        return "".join(child["errs"])[-3000:]

    def next_line(until):
        """The next (child, line) from any child; fails at the deadline and
        when a child ends its output without its result."""
        left = until - time.time()
        try:
            index, line = lines.get(timeout=max(0.0, left))
        except queue.Empty:
            fail(f"fleet-tcp: no result within {FLEET_TCP_TIMEOUT_S} s from "
                 f"{[c['args'][:2] for c in children if c['result'] is None]}")
        child = children[index]
        if line is None and child["result"] is None:
            fail(f"fleet-tcp: child {child['args'][:2]} ended without its result "
                 f"(exit {child['proc'].poll()}): {tail(child)}")
        return child, line

    t0 = time.perf_counter()
    until = time.time() + FLEET_TCP_TIMEOUT_S
    try:
        spawn("leader")
        addr = None
        while addr is None:
            child, line = next_line(until)
            if line is not None and line.startswith("ADDR "):
                addr = line.split()[1:]
        for i in (1, 2):
            spawn("follower", f"h{i}", *addr)
        while any(c["result"] is None for c in children):
            child, line = next_line(until)
            if line is not None and line.startswith("CHILD "):
                child["result"] = json.loads(line[len("CHILD "):])
        for child in children:
            child["proc"].stdin.close()
        for child in children:
            rc = child["proc"].wait(timeout=max(1.0, until - time.time()))
            if rc != 0:
                fail(f"fleet-tcp: child {child['args'][:2]} exited {rc}: {tail(child)}")
    except subprocess.TimeoutExpired:
        fail("fleet-tcp: a child outlived its timeout")
    finally:
        for child in children:
            if child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait(timeout=30)
    results = {c["result"]["host"]: c["result"] for c in children}
    hashes = {r["hash"] for r in results.values()}
    if sorted(results) != ["h0", "h1", "h2"] or len(hashes) != 1:
        fail(f"fleet-tcp: children disagree: {results}")
    seconds = time.perf_counter() - t0
    launches = {k: sum(r["launches"][k] for r in results.values())
                for k in results["h0"]["launches"]}
    print(f"[fleet-tcp] ({card_line}) 3 processes over TCPTransport: one two-phase promote "
          f"flipped all to v1, hash {hashes.pop()}; every state on the card, every child's "
          f"answers bit-identical to its eager kernel call; launches by host "
          + "; ".join(f"{h}: {json.dumps(r['launches'])}" for h, r in sorted(results.items()))
          + f"; {seconds:.1f} s")
    return {"launches": launches, "by_host": {h: r["launches"] for h, r in results.items()},
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 6: flash attention against its plain version
# ---------------------------------------------------------------------------

def phase_flash(dev, errs):
    import torch
    from repro_torch.kernels import flash_attention

    gen = torch.Generator().manual_seed(4321)

    def qkv(b, sq, skv, hq, hkv, dh, dtype):
        return [torch.randn(s, generator=gen).to(dtype).to(dev)
                for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]

    fa, plain = flash_attention.flash_attention, flash_attention.plain
    n_checks = 0
    for (b, sq, skv, hq, hkv, dh, causal, window) in FLASH_SHAPES:
        q_offset = skv - sq if causal and sq < skv else 0
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            what = f"flash_attention {(b, sq, skv, hq, hkv, dh, causal, window)} " \
                   f"q_offset={q_offset} {dtype}"
            got = fa(q, k, v, **kw)
            err = check_close(what, got, plain(q, k, v, **kw), **FLASH_TOL[key])
            errs[("flash_attention", key)] = max(errs.get(("flash_attention", key), 0.0), err)
            # every row of these shapes sees a key: the whole lse is compared
            out, lse = fa(q, k, v, return_lse=True, **kw)
            if not torch.equal(out, got):
                fail(f"{what}: the output with return_lse differs from the output without")
            want_lse = plain(q, k, v, return_lse=True, **kw)[1]
            err = check_close(f"{what} lse", lse, want_lse, **LSE_TOL[key])
            errs[("lse", key)] = max(errs.get(("lse", key), 0.0), err)
            n_checks += 1
    # rows that see no key: q at 14..21 over 16 keys, causal, window 4 (rows
    # 5..7 see none), and q at 100 (every row blind)
    for (dtype, key), dh in itertools.product(
            ((torch.float32, "f32"), (torch.bfloat16, "bf16")), (120, 72)):
        q, k, v = qkv(2, 8, 16, 4, 2, dh, dtype)
        for q_offset, blind in ((14, slice(5, 8)), (100, slice(0, 8))):
            kw = dict(causal=True, window=4, q_offset=q_offset)
            got, want = fa(q, k, v, **kw), plain(q, k, v, **kw)
            for name, out in (("kernel", got), ("plain", want)):
                if bool(out[:, blind].to(torch.float32).any()):
                    fail(f"flash_attention: {name} gives rows that see no key a value "
                         f"(q_offset={q_offset}, dh={dh}, {dtype})")
            check_close(f"flash_attention rows with keys, q_offset={q_offset} dh={dh} {dtype}", got,
                        want, **FLASH_TOL[key])
            lse, want_lse = (f(q, k, v, return_lse=True, **kw)[1] for f in (fa, plain))
            for name, t in (("kernel", lse), ("plain", want_lse)):
                if not bool((t[..., blind] < -1e29).all()):
                    fail(f"flash_attention: {name} lse of rows that see no key is not about "
                         f"-1e30 (q_offset={q_offset}, dh={dh}, {dtype})")
            seen = [r for r in range(8) if not blind.start <= r < blind.stop]
            check_close(f"flash_attention lse of rows with keys, q_offset={q_offset} dh={dh} "
                        f"{dtype}", lse[..., seen], want_lse[..., seen], **LSE_TOL[key])
            n_checks += 1
    errs["flash_d224"] = flash_d224(dev)
    grad_err = flash_grad_checks(dev, gen)
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention: {n_checks} checks against the plain version passed "
          f"(rows that see no key are 0 in both, their lse about -1e30); largest |err| f32 "
          f"{errs[('flash_attention', 'f32')]:.3e}, bf16 {errs[('flash_attention', 'bf16')]:.3e}; "
          f"lse f32 {errs[('lse', 'f32')]:.3e}, bf16 {errs[('lse', 'bf16')]:.3e} (bounds "
          f"{LSE_TOL['f32']}, {LSE_TOL['bf16']}); FlashAttentionFn's gradients, kernel forward "
          f"(and in bf16 the kernel backward) vs all plain: {json.dumps(grad_err)}")
    errs["flash_grads"] = grad_err
    errs["flash_bwd_timing"] = flash_bwd_timing(dev)


def flash_d224(dev):
    """B4's bf16 forward at Dh 224 with the caller's scale (FLASH_D224)
    against its plain version: elementwise within FLASH_TOL, each (batch,
    head) within FLASH_REL_NORM, the lse within FLASH_D224_LSE_ATOL; at the
    first shape timed (device only) beside its plain version, SDPA with the
    same scale, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention

    gen = torch.Generator().manual_seed(224)
    fa, plain = flash_attention.flash_attention, flash_attention.plain
    kw = dict(causal=True, scale=FLASH_D224_SCALE)
    rows = []
    for (b, s, hq, hkv, dh) in FLASH_D224:
        q, k, v = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
                   for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
        what = f"flash_attention {[b, s, hq, hkv, dh]} bf16 causal, scale (Dh / 2)^-1/2"
        got, lse = fa(q, k, v, return_lse=True, **kw)
        want, want_lse = plain(q, k, v, return_lse=True, **kw)
        err = check_close(what, got, want, **FLASH_TOL["bf16"])
        norms = check_flash_norm(what, got, want,
                                 plain(*(t.to(torch.float32) for t in (q, k, v)), **kw))
        lse_err = check_close(f"{what} lse", lse, want_lse, rtol=0.0, atol=FLASH_D224_LSE_ATOL)
        row = {"shape": [b, s, hq, hkv, dh], "causal": True, "scale": FLASH_D224_SCALE,
               "max_abs_err": err, "lse_max_abs_err": lse_err, **norms}
        del got, want, lse, want_lse
        if not rows:
            kern = lambda: fa(q, k, v, **kw)
            slow = lambda: plain(q, k, v, **kw)
            g = hq // hkv
            qs, ks, vs = (q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
                          v.repeat_interleave(g, dim=2).transpose(1, 2))
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                         scale=FLASH_D224_SCALE)
            dev_ms, plain_dev_ms, lib_dev_ms = (time_graph(kern, 10, 3), time_graph(slow, 3, 2),
                                                time_graph(lib, 10, 3))
            flops = 4.0 * dh * b * hq * (s * (s + 1) // 2)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            bms, bby = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
            row.update(device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                       library_device_ms=lib_dev_ms, bound_ms=bms, bound_by=bby,
                       roofline_pct=100.0 * bms / dev_ms)
            print(f"[time] flash_attention zamba2-7b-instruct {[b, s, hq, hkv, dh]} bf16 causal, "
                  f"scale (Dh / 2)^-1/2: device-only {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} "
                  f"TFLOP/s, {100.0 * bms / dev_ms:.1f} % of the bound); plain (device) "
                  f"{plain_dev_ms:.4f} ms; SDPA (device) {lib_dev_ms:.4f} ms; bound {bms:.6f} ms "
                  f"({bby})")
        print(f"[flash] {what}: max |err| {err:.3e}, relative norm a (batch, head) "
              f"{norms['rel_norm']:.3e} (bound {FLASH_REL_NORM}), lse max |err| {lse_err:.3e} "
              f"(bound {FLASH_D224_LSE_ATOL})")
        rows.append(row)
    return rows


def flash_grad_checks(dev, gen):
    """dq, dk, dv of `blocks.flash_attention` with backend="kernel" (the
    kernel's forward and lse; in bf16 the kernel backward, in f32 the plain
    one) against backend="torch" (all plain), at FLASH_GRAD_SHAPES in f32
    and bf16."""
    import torch
    from repro_torch.models import blocks

    worst = {"f32_max_abs_err": 0.0, "bf16_max_rel_norm": 0.0}
    for (b, sq, skv, hq, hkv, dh, causal, window) in FLASH_GRAD_SHAPES:
        q_offset = skv - sq if causal and sq < skv else 0
        for dtype in (torch.float32, torch.bfloat16):
            base = [torch.randn(s, generator=gen).to(dtype).to(dev)
                    for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
                              (b, sq, hq, dh))]
            grads = {}
            for backend in ("kernel", "torch"):
                q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
                out = blocks.flash_attention(q, k, v, causal=causal, window=window,
                                             q_offset=q_offset, backend=backend)
                out.backward(base[3])
                grads[backend] = (q.grad, k.grad, v.grad)
            what = f"FlashAttentionFn grads {(b, sq, skv, hq, hkv, dh, causal, window)} {dtype}"
            for name, g, w in zip(("dq", "dk", "dv"), grads["kernel"], grads["torch"]):
                if dtype == torch.float32:
                    err = check_close(f"{what} {name}", g, w, **FLASH_GRAD_TOL)
                    worst["f32_max_abs_err"] = max(worst["f32_max_abs_err"], err)
                else:
                    g32, w32 = g.to(torch.float32), w.to(torch.float32)
                    rel = float((g32 - w32).norm() / w32.norm())
                    if not bool(torch.isfinite(g32).all()) or not rel <= FLASH_GRAD_REL_NORM:
                        fail(f"{what} {name}: relative norm {rel:.3e} (bound "
                             f"{FLASH_GRAD_REL_NORM})")
                    worst["bf16_max_rel_norm"] = max(worst["bf16_max_rel_norm"], rel)
    return worst


def flash_bwd_timing(dev):
    """The backward kernel (`flash_attention_bwd`, both passes) at each shape
    of FLASH_BWD_TIMING: device-only ms (graph replay), beside the plain
    version's ms, the backward of SDPA (a yardstick the port never calls)
    and the bound: 10 Dh operations a visible (query, key) pair and query
    head at the bf16 peak, or q, k, v, out, dout, lse read and dq, dk, dv
    written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fake, flash_attention
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    gen = torch.Generator().manual_seed(97)
    rows = {}
    for name, (b, s, hq, hkv, dh, causal, window) in FLASH_BWD_TIMING.items():
        q, k, v, dout = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
                         for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh),
                                       (b, s, hq, dh))]
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
        kernel = lambda: flash_attention.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        plain = lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        g = hq // hkv
        qs = q.transpose(1, 2).detach().requires_grad_(True)
        ks = k.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
        vs = v.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        do_s = dout.transpose(1, 2)
        lib = lambda: torch.autograd.grad(o, (qs, ks, vs), do_s, retain_graph=True)
        dev_ms = time_graph(kernel, 10, 5)
        plain_ms = time_events(plain, 3, 1)
        lib_ms = time_events(lib, 10, 3)
        pairs = fake.visible_pairs(s, s, causal, window, 0) * b * hq
        el = 2
        b_flops = 10.0 * dh * pairs
        b_bytes = el * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        t_ops, t_bytes = b_flops / PEAK_BF16_FLOPS, b_bytes / PEAK_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        rows[name] = {"shape": [b, s, hq, hkv, dh, causal, window], "device_ms": dev_ms,
                      "plain_ms": plain_ms, "sdpa_backward_ms": lib_ms,
                      "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "roofline": bound / dev_ms}
        print(f"[time] flash_attention_bwd {name} {rows[name]['shape']} bf16: kernel "
              f"{dev_ms:.4f} ms device-only, plain {plain_ms:.3f} ms, SDPA backward "
              f"{lib_ms:.4f} ms, bound {bound:.6f} ms ({rows[name]['bound_by']}; "
              f"{100 * bound / dev_ms:.1f} % of it)")
        del q, k, v, dout, out, lse, qs, ks, vs, o
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 7: h2o-danube-3-4b served through the kernels at full width and depth
# ---------------------------------------------------------------------------

def logits_diff(what: str, got, want, pair: str = "kernel vs torch backend"):
    """Largest relative row norm of got − want and largest |got − want|;
    fails beyond LM_REL_NORM or LM_MAX_ABS, or on a non-finite value."""
    import torch

    g, w = got.to(torch.float32), want.to(torch.float32)
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite logits")
    rel = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
    mx = float((g - w).abs().max())
    if rel > LM_REL_NORM or mx > LM_MAX_ABS:
        fail(f"{what}: {pair}: relative row norm {rel:.3e} (bound "
             f"{LM_REL_NORM}), max |err| {mx:.3e} (bound {LM_MAX_ABS})")
    return rel, mx


def phase_lm(dev):
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.kernels import flash_attention
    from repro_torch.models import api
    from repro_torch.serve import serve_step

    cfg = registry.get(LM_ARCH)
    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg, execution=kexe)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} (dh {cfg.dh}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.padded_vocab}, window {cfg.sliding_window}; {n_params} f32 params drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = {r: torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                                generator=gen, device=dev, dtype=torch.int32)
               for r, spec in LM_REQUESTS.items()}

    def serve(exe, name, forced=None):
        """One request: prefill, then greedy decode (or the given tokens)."""
        spec = LM_REQUESTS[name]
        batch = {"tokens": prompts[name]}
        marks = [flash_attention.launches]
        prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"],
                                          execution=exe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        marks.append(flash_attention.launches)
        decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
        outs, toks = [logits], []
        t0 = time.perf_counter()
        for i in range(spec["decode"]):
            tok = (logits.argmax(-1) if forced is None else forced[i]).to(torch.int32)
            toks.append(tok)
            logits, cache = decode(params, tok, cache)
            outs.append(logits)
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / spec["decode"]
        marks.append(flash_attention.launches)
        if int(cache["pos"]) != spec["prompt"] + spec["decode"]:
            fail(f"lm request {name}: cache pos {int(cache['pos'])}")
        return dict(logits=outs, tokens=toks, cache=cache, t_prefill=t_prefill,
                    t_decode=t_decode, launches={"prefill": marks[1] - marks[0],
                                                 "decode": marks[2] - marks[1]})

    for exe in (kexe, texe):              # warm-up: first calls, allocator growth
        for name in LM_REQUESTS:
            serve(exe, name)
    reset_counts()
    kern = {name: serve(kexe, name) for name in LM_REQUESTS}
    counts = all_counts()
    ref = {name: serve(texe, name, forced=kern[name]["tokens"]) for name in LM_REQUESTS}

    worst = (0.0, 0.0)
    for name, spec in LM_REQUESTS.items():
        k, t = kern[name], ref[name]
        for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
            if tuple(gk.shape) != (spec["batch"], cfg.padded_vocab):
                fail(f"lm request {name}: logits shape {tuple(gk.shape)}")
            step = "prefill" if i == 0 else f"decode {i}"
            rel, mx = logits_diff(f"lm request {name} {step}", gk, gt)
            worst = (max(worst[0], rel), max(worst[1], mx))
        for leaf in ("k", "v"):
            kc, tc = k["cache"][leaf].to(torch.float32), t["cache"][leaf].to(torch.float32)
            rel = float((kc - tc).norm() / tc.norm())
            if not bool(torch.isfinite(kc).all()) or rel > LM_REL_NORM:
                fail(f"lm request {name}: cache {leaf} relative norm {rel:.3e}")
        if k["launches"]["prefill"] != cfg.n_layers or k["launches"]["decode"] != 0:
            fail(f"lm request {name}: flash launches {k['launches']}, want "
                 f"{cfg.n_layers} per prefill and none in decode")
        agree = sum(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                    for a, b in zip(k["logits"], t["logits"]))
        print(f"[lm] request {name} ({spec['batch']} x {spec['prompt']} tokens, "
              f"{spec['decode']} decode steps, cache {spec['cache']} -> "
              f"{tuple(k['cache']['k'].shape)}): prefill {k['t_prefill'] * 1e3:.1f} ms "
              f"kernel / {t['t_prefill'] * 1e3:.1f} ms torch; decode step "
              f"{k['t_decode'] * 1e3:.2f} ms kernel / {t['t_decode'] * 1e3:.2f} ms torch; "
              f"flash launches {json.dumps(k['launches'])}; greedy tokens agree at "
              f"{agree}/{len(k['logits'])} steps")
    if counts["flash_attention"] <= 0:
        fail("lm: the flash kernel never launched on the LM path")
    print(f"[lm] kernel vs torch backend: largest relative row norm {worst[0]:.3e} (bound "
          f"{LM_REL_NORM}), largest |err| {worst[1]:.3e} (bound {LM_MAX_ABS}); launches on "
          f"the LM path {json.dumps(counts)}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    by_entry = {name: kern[name]["launches"] for name in LM_REQUESTS}
    steps = {f"{name}_{backend}": {"prefill_ms": run[name]["t_prefill"] * 1e3,
                                   "decode_step_ms": run[name]["t_decode"] * 1e3}
             for backend, run in (("kernel", kern), ("torch", ref)) for name in LM_REQUESTS}

    # device-only times of request A's steps (CUDA graph replay): with the
    # host-paced times above they give the device's idle share of a step
    spec = LM_REQUESTS["A"]
    batch = {"tokens": prompts["A"]}
    tok = torch.zeros((spec["batch"],), dtype=torch.int32, device=dev)
    for backend, exe, run in (("kernel", kexe, kern), ("torch", texe, ref)):
        prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"], execution=exe)
        cache = run["A"]["cache"]
        decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
        row = steps[f"A_{backend}"]
        row["prefill_device_ms"] = time_graph(lambda: prefill(params, batch), 1, 3)
        row["decode_step_device_ms"] = time_graph(lambda: decode(params, tok, cache), 1, 5)
        print(f"[lm-time] request A, {backend} backend: prefill {row['prefill_ms']:.1f} ms "
              f"host-paced, {row['prefill_device_ms']:.1f} ms on the device alone; decode step "
              f"{row['decode_step_ms']:.2f} ms host-paced, {row['decode_step_device_ms']:.2f} ms "
              f"on the device alone (idle share "
              f"{1 - row['decode_step_device_ms'] / row['decode_step_ms']:.2f})")
    lm = dict(cfg=cfg, params=params, prompts=prompts["A"], kern=kern["A"])
    return counts["flash_attention"], by_entry, steps, worst, lm


def flash_timing(dev, errs):
    """The flash kernel at request A's prefill shape, beside its plain
    version, the library's SDPA (timed only) and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention

    cfg = registry.get(LM_ARCH)
    spec = LM_REQUESTS["A"]
    b, s, hq, hkv, dh = spec["batch"], spec["prompt"], cfg.n_heads, cfg.n_kv_heads, cfg.dh
    gen = torch.Generator().manual_seed(99)
    q, k, v = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
               for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
    kern = lambda: flash_attention.flash_attention(q, k, v, causal=True)
    plain = lambda: flash_attention.plain(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                          kv_chunk=cfg.kv_chunk)
    g = hq // hkv
    qs, ks, vs = (q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
                  v.repeat_interleave(g, dim=2).transpose(1, 2))
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    want = plain()
    got = kern()
    err = check_close("flash_attention at the request A shape", got, want, **FLASH_TOL["bf16"])
    norms = check_flash_norm("flash_attention at the request A shape", got, want, plain_f32(
        flash_attention, q, k, v, cfg, causal=True))
    del got
    lib_err = max_err(lib().transpose(1, 2), want)
    ms, plain_ms, lib_ms = time_events(kern, 20, 3), time_events(plain, 20, 3), \
        time_events(lib, 20, 3)
    dev_ms, plain_dev_ms, lib_dev_ms = (time_graph(kern, 10, 3), time_graph(plain, 10, 3),
                                        time_graph(lib, 10, 3))
    ms2 = time_events(kern, 20, 3)
    pairs = b * hq * s * (s + 1) // 2            # visible (query, key) pairs, causal
    flops = 4.0 * dh * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bms, bby = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    shape = [b, s, hq, hkv, dh]
    print(f"[time] flash_attention {shape} bf16 causal: kernel {ms:.4f} ms ({ms2:.4f} again), "
          f"device-only {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s); plain "
          f"{plain_ms:.4f} ms (device {plain_dev_ms:.4f}); SDPA {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}; max |err| against the plain version {lib_err:.3e}); bound "
          f"{bms:.6f} ms ({bby})")
    print(f"[flash] request A shape: relative norm over a (batch, head) {norms['rel_norm']:.3e} "
          f"(bound {FLASH_REL_NORM}); against the plain version in f32 "
          f"{norms['rel_norm_to_f32']:.3e}, where the plain bf16 version is at "
          f"{norms['plain_bf16_rel_norm_to_f32']:.3e}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:83",
        "launches": None, "max_abs_err": err,
        "max_abs_err_sweep_f32": errs.get(("flash_attention", "f32")),
        "max_abs_err_sweep_bf16": errs.get(("flash_attention", "bf16")),
        "ms": ms, "ms_repeat": ms2, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": lib_ms, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
        "library_device_ms": lib_dev_ms, "library_max_abs_err": lib_err,
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) on "
                   "(B, H, S, Dh) views with K/V repeated over the GQA group",
        "shape": shape, "dtype": "bfloat16", "flops": flops, "bytes": nbytes, **norms,
        "request_B": flash_request_b_timing(dev),
    }


def plain_f32(flash_attention, q, k, v, cfg, **kw):
    """The plain version on the same inputs widened to f32."""
    import torch

    return flash_attention.plain(q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, **kw)


def flash_request_b_timing(dev):
    """The bf16 kernel at request B's prefill shape (1 x 4608, window 4096),
    beside its plain version and SDPA with the same mask given explicitly:
    the kernel's share of request B's prefill."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention

    cfg = registry.get(LM_ARCH)
    b, s = LM_REQUESTS["B"]["batch"], LM_REQUESTS["B"]["prompt"]
    hq, hkv, dh, w = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.sliding_window
    gen = torch.Generator().manual_seed(98)
    q, k, v = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
               for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
    kern = lambda: flash_attention.flash_attention(q, k, v, causal=True, window=w)
    plain = lambda: flash_attention.plain(q, k, v, causal=True, window=w, q_chunk=cfg.q_chunk,
                                          kv_chunk=cfg.kv_chunk)
    pos = torch.arange(s, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
    g = hq // hkv
    qs, ks, vs = (q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
                  v.repeat_interleave(g, dim=2).transpose(1, 2))
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    want = plain()
    got = kern()
    err = check_close("flash_attention at the request B shape", got, want, **FLASH_TOL["bf16"])
    norms = check_flash_norm("flash_attention at the request B shape", got, want, plain_f32(
        flash_attention, q, k, v, cfg, causal=True, window=w))
    del got
    lib_err = max_err(lib().transpose(1, 2), want)
    dev_ms, plain_dev_ms, lib_dev_ms = (time_graph(kern, 10, 3), time_graph(plain, 2, 2),
                                        time_graph(lib, 5, 2))
    pairs = b * hq * sum(min(i + 1, w) for i in range(s))   # visible pairs, causal + window
    flops = 4.0 * dh * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bms, bby = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    print(f"[time] flash_attention {[b, s, hq, hkv, dh]} bf16 causal window {w}: device-only "
          f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s), x {cfg.n_layers} layers = "
          f"{cfg.n_layers * dev_ms:.1f} ms of the prefill; plain (device) {plain_dev_ms:.4f} ms; "
          f"SDPA with the mask (device) {lib_dev_ms:.4f} ms (max |err| against the plain "
          f"version {lib_err:.3e}); bound {bms:.6f} ms ({bby})")
    print(f"[flash] request B shape: relative norm over a (batch, head) {norms['rel_norm']:.3e} "
          f"(bound {FLASH_REL_NORM}); against the plain version in f32 "
          f"{norms['rel_norm_to_f32']:.3e}, where the plain bf16 version is at "
          f"{norms['plain_bf16_rel_norm_to_f32']:.3e}")
    return {"shape": [b, s, hq, hkv, dh], "window": w, "device_ms": dev_ms, **norms,
            "plain_device_ms": plain_dev_ms, "library_device_ms": lib_dev_ms,
            "library": "scaled_dot_product_attention with the causal + window mask as a "
                       "boolean attn_mask, K/V repeated over the GQA group",
            "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
            "library_max_abs_err": lib_err, "flops": flops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# phase 8: the LM through DRService's queue, the RP-compressed KV cache
# ---------------------------------------------------------------------------

def all_counts():
    """Every kernel wrapper's launch count, flash included."""
    from repro_torch import kernels

    return dict(kernels.launch_counts())


def wait_ticket(what: str, ticket, timeout_s: float = 300.0):
    if not ticket.wait(timeout_s):
        fail(f"{what}: the ticket was not resolved within {timeout_s} s")
    return ticket.result()


def phase_lm_queue(dev, lm):
    """Request A through a `DRService`'s admission queue: the threaded
    `DeadlineScheduler`'s `lm_prefill`, then LMQ_DECODE `lm_decode` steps on
    the kernel run's tokens, each flushed by the scheduler's loop at its
    deadline.  The logits must equal phase_lm's direct `serve_step` results
    bit for bit, the service's LRU must hold the two step builds, and the
    SLO report must carry both kinds."""
    import torch
    from repro_torch.core.execution import Execution
    from repro_torch.serve import DeadlineScheduler, DRService

    cfg, params, prompts, kern = lm["cfg"], lm["params"], lm["prompts"], lm["kern"]
    spec = LM_REQUESTS["A"]
    kexe = Execution(backend="kernel", device=dev)
    svc = DRService()
    outs = []
    reset_counts()
    t0 = time.perf_counter()
    with DeadlineScheduler(svc, default_max_delay_ms=LMQ_DELAY_MS) as sched:
        ticket = sched.lm_prefill(cfg, None, params, {"tokens": prompts}, spec["cache"],
                                  execution=kexe)
        logits, cache = wait_ticket("lm-queue prefill", ticket)
        outs.append(logits)
        for i in range(LMQ_DECODE):
            ticket = sched.lm_decode(cfg, None, params, kern["tokens"][i], cache,
                                     execution=kexe)
            logits, cache = wait_ticket(f"lm-queue decode {i + 1}", ticket)
            outs.append(logits)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts()
    for i, (got, want) in enumerate(zip(outs, kern["logits"])):
        if not torch.equal(got, want):
            fail(f"lm-queue: {'prefill' if i == 0 else f'decode {i}'} logits differ from the "
                 f"direct serve_step run; max |err| {max_err(got, want):.3e}")
    if int(cache["pos"]) != spec["prompt"] + LMQ_DECODE:
        fail(f"lm-queue: cache pos {int(cache['pos'])}")
    if svc.cache.misses != 2:
        fail(f"lm-queue: {svc.cache.misses} builds in the service's cache, want 2")
    slo = svc.metrics()["slo"].get("lm", {})
    if set(slo) != {"prefill", "decode"}:
        fail(f"lm-queue: SLO keys {sorted(slo)}, want prefill and decode")
    if counts["flash_attention"] != cfg.n_layers or any(
            counts[k] for k in ("ternary_matmul", "fused_transform", "easi_apply")):
        fail(f"lm-queue: launches {counts}, want {cfg.n_layers} flash launches and no other")
    e2e = {kind: slo[kind]["e2e"] for kind in ("prefill", "decode")}
    print(f"[lm-queue] request A through DeadlineScheduler.lm_prefill / lm_decode "
          f"({LMQ_DELAY_MS} ms budget, the loop's own thread): prefill + {LMQ_DECODE} decode "
          f"steps equal the direct serve_step logits bit for bit; {svc.cache.misses} builds in "
          f"the service's LRU; e2e p50 prefill {e2e['prefill']['p50_ms']:.1f} ms, decode "
          f"{e2e['decode']['p50_ms']:.1f} ms (max {e2e['decode']['max_ms']:.1f}); "
          f"{wall:.2f} s in all; launches {json.dumps(counts)}")
    return counts, {"e2e": e2e, "wall_s": wall, "builds": svc.cache.misses}


def rank_corr(a, b):
    """Per-row rank correlation of (B, V) logits (ranks by argsort, as
    tests/test_kv_rp.py takes them)."""
    import torch

    ra, rb = (x.argsort(-1).argsort(-1).to(torch.float64) for x in (a, b))
    ra, rb = ra - ra.mean(-1, keepdim=True), rb - rb.mean(-1, keepdim=True)
    return (ra * rb).sum(-1) / (ra.norm(dim=-1) * rb.norm(dim=-1))


def phase_kv_rp(dev, lm):
    """h2o-danube-3-4b with `kv_rp=KV_RP` (keys sketched Dh 120 -> 60 by the
    port's ternary R): request A, 16 decode steps teacher-forced with the
    exact kernel run's tokens, kernel backend then torch backend."""
    import dataclasses

    import torch
    from repro_torch.core.execution import Execution
    from repro_torch.serve import serve_step

    exact, params, prompts, kern = lm["cfg"], lm["params"], lm["prompts"], lm["kern"]
    cfg = dataclasses.replace(exact, kv_rp=KV_RP)
    spec = LM_REQUESTS["A"]
    batch = {"tokens": prompts}

    def run(exe):
        prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"], execution=exe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
        outs = [logits]
        t0 = time.perf_counter()
        for tok in kern["tokens"]:
            logits, cache = decode(params, tok, cache)
            outs.append(logits)
        torch.cuda.synchronize()
        return dict(logits=outs, cache=cache, t_prefill=t_prefill,
                    t_decode=(time.perf_counter() - t0) / len(kern["tokens"]))

    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    for exe in (kexe, texe):              # warm-up: first calls, allocator growth
        run(exe)
    reset_counts()
    k = run(kexe)
    counts = all_counts()
    t = run(texe)
    kc, ec = k["cache"], kern["cache"]
    if kc["k"].shape[-1] != exact.dh // KV_RP or kc["v"].shape != ec["v"].shape:
        fail(f"kv-rp: cache k {tuple(kc['k'].shape)}, v {tuple(kc['v'].shape)}")
    nbytes = lambda c: sum(c[n].numel() * c[n].element_size() for n in ("k", "v"))
    ratio = nbytes(kc) / nbytes(ec)
    if abs(ratio - 0.75) > 1e-9:
        fail(f"kv-rp: cache bytes {ratio:.4f} of the exact cache, want 0.75")
    worst = (0.0, 0.0)
    for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
        rel, mx = logits_diff(f"kv-rp {'prefill' if i == 0 else f'decode {i}'}", gk, gt)
        worst = (max(worst[0], rel), max(worst[1], mx))
    for leaf in ("k", "v"):
        a, b = kc[leaf].to(torch.float32), t["cache"][leaf].to(torch.float32)
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > LM_REL_NORM:
            fail(f"kv-rp: cache {leaf} relative norm {rel:.3e}")
    corr = [float(rank_corr(gk, ge).min()) for gk, ge in
            zip(k["logits"][1:], kern["logits"][1:])]
    if min(corr) <= KV_RP_RANK_CORR:
        fail(f"kv-rp: a row's logits rank correlation with the exact run fell to "
             f"{min(corr):.4f} (bound {KV_RP_RANK_CORR}); by step {corr}")
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"kv-rp: flash launches {counts['flash_attention']}, want {cfg.n_layers}")
    agree = sum(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(k["logits"][1:], kern["logits"][1:]))
    print(f"[kv-rp] {cfg.name} kv_rp={KV_RP}: K cache {tuple(kc['k'].shape)} (exact "
          f"{tuple(ec['k'].shape)}), cache bytes {ratio:.4f} of the exact cache; over "
          f"{len(corr)} teacher-forced decode steps every row's rank correlation with the exact "
          f"run >= {min(corr):.4f} (bound {KV_RP_RANK_CORR}; mean {sum(corr) / len(corr):.4f}), "
          f"greedy tokens equal the exact run's at {agree}/{len(corr)} steps")
    print(f"[kv-rp] kernel vs torch backend: largest relative row norm {worst[0]:.3e}, largest "
          f"|err| {worst[1]:.3e}; prefill {k['t_prefill'] * 1e3:.1f} ms kernel / "
          f"{t['t_prefill'] * 1e3:.1f} torch, decode step {k['t_decode'] * 1e3:.2f} / "
          f"{t['t_decode'] * 1e3:.2f} ms (host-paced); launches {json.dumps(counts)}")
    return counts, {"cache_bytes_ratio": ratio, "min_rank_corr": min(corr),
                    "rank_corr_by_step": corr, "max_rel_norm": worst[0], "max_abs_err": worst[1],
                    "prefill_ms": k["t_prefill"] * 1e3, "decode_step_ms": k["t_decode"] * 1e3,
                    "torch_prefill_ms": t["t_prefill"] * 1e3,
                    "torch_decode_step_ms": t["t_decode"] * 1e3}


# ---------------------------------------------------------------------------
# phase 9: phi3.5-moe, 8 of 32 layers at full width
# ---------------------------------------------------------------------------

def choice_agreement(a, b) -> float:
    """Share of the (token, slot) expert choices in `a` (T, k) that `b`
    made for the same token."""
    import torch

    return float((a[:, :, None] == b[:, None, :]).any(-1).to(torch.float32).mean())


def phase_moe(dev):
    """phi3.5-moe-42b-a6.6b at full width, cut to MOE_LAYERS layers (f32
    experts are 5.03 GB a layer): request A, 16 greedy decode steps on the
    kernel backend, the torch backend teacher-forced with its tokens.  Every
    routing call is recorded (chosen experts, choices dropped at capacity)
    to tell a routing flip from a numeric difference."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.models import api, blocks
    from repro_torch.serve import serve_step

    cfg = dataclasses.replace(registry.get(MOE_ARCH), n_layers=MOE_LAYERS)
    spec = LM_REQUESTS["A"]
    moe = cfg.moe
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(2), cfg,
                             execution=Execution(device=dev))
    torch.cuda.synchronize()
    expert_gb = 3 * moe.n_experts * cfg.d_model * moe.d_ff_expert * 4 / 1e9
    print(f"[moe] {cfg.name}: {cfg.n_layers} of {registry.get(MOE_ARCH).n_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (dh {cfg.dh}), "
          f"{moe.n_experts} experts top-{moe.top_k} of d_ff {moe.d_ff_expert} "
          f"({expert_gb:.2f} GB of f32 experts a layer); params drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB")
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                                     generator=gen, device=dev, dtype=torch.int32)}
    route = blocks._route
    records = []

    def recording_route(x, router, mspec):
        r, aux = route(x, router, mspec)
        c = blocks.moe_capacity(x.shape[0], mspec)
        records.append((r.top_e, (r.pos >= c).sum(), c))
        return r, aux

    def serve(exe, forced=None):
        records.clear()
        prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"], execution=exe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
        outs, toks = [logits], []
        t0 = time.perf_counter()
        for i in range(spec["decode"]):
            tok = (logits.argmax(-1) if forced is None else forced[i]).to(torch.int32)
            toks.append(tok)
            logits, cache = decode(params, tok, cache)
            outs.append(logits)
        torch.cuda.synchronize()
        return dict(logits=outs, tokens=toks, cache=cache, routes=list(records),
                    t_prefill=t_prefill, t_decode=(time.perf_counter() - t0) / spec["decode"])

    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    blocks._route = recording_route
    try:
        for exe in (kexe, texe):          # warm-up: first calls, allocator growth
            serve(exe)
        reset_counts()
        k = serve(kexe)
        counts = all_counts()
        t = serve(texe, forced=k["tokens"])
    finally:
        blocks._route = route
    n_calls = cfg.n_layers * (1 + spec["decode"])
    if len(k["routes"]) != n_calls or len(t["routes"]) != n_calls:
        fail(f"moe: {len(k['routes'])} / {len(t['routes'])} routing calls, want {n_calls}")
    layers = range(cfg.n_layers)
    agree_prefill = [choice_agreement(k["routes"][i][0], t["routes"][i][0]) for i in layers]
    agree_decode = [min(choice_agreement(k["routes"][s * cfg.n_layers + i][0],
                                         t["routes"][s * cfg.n_layers + i][0])
                        for s in range(1, 1 + spec["decode"])) for i in layers]
    dropped_prefill = [int(k["routes"][i][1]) for i in layers]
    dropped_decode = sum(int(r[1]) for r in k["routes"][cfg.n_layers:])
    caps = (k["routes"][0][2], k["routes"][cfg.n_layers][2])
    print(f"[moe] capacity {caps[0]} a expert at prefill ({spec['batch']} x {spec['prompt']} "
          f"tokens), {caps[1]} at decode; choices dropped at capacity by layer at prefill "
          f"{dropped_prefill} (of {spec['batch'] * spec['prompt'] * moe.top_k}), "
          f"{dropped_decode} in all decode steps")
    print(f"[moe] (token, slot) expert choices agreeing between backends, by layer: prefill "
          f"{[round(a, 6) for a in agree_prefill]}; fewest in a decode step "
          f"{[round(a, 6) for a in agree_decode]}")
    worst = (0.0, 0.0)
    for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
        rel, mx = logits_diff(f"moe {'prefill' if i == 0 else f'decode {i}'}", gk, gt)
        worst = (max(worst[0], rel), max(worst[1], mx))
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"moe: flash launches {counts['flash_attention']}, want {cfg.n_layers}")
    agree = sum(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(k["logits"], t["logits"]))
    print(f"[moe] kernel vs torch backend: largest relative row norm {worst[0]:.3e} (bound "
          f"{LM_REL_NORM}), largest |err| {worst[1]:.3e} (bound {LM_MAX_ABS}); greedy tokens "
          f"agree at {agree}/{len(k['logits'])} steps; launches {json.dumps(counts)}; peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    steps = {"layers": cfg.n_layers, "capacity": caps, "agree_prefill": agree_prefill,
             "agree_decode_min": agree_decode, "dropped_prefill": dropped_prefill,
             "dropped_decode": dropped_decode, "max_rel_norm": worst[0], "max_abs_err": worst[1]}
    # device-only times of the steps (CUDA graph replay) beside the host-paced
    # ones: the device's idle share of a step
    tok = torch.zeros((spec["batch"],), dtype=torch.int32, device=dev)
    for backend, exe, run in (("kernel", kexe, k), ("torch", texe, t)):
        prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"], execution=exe)
        decode = serve_step.make_decode(cfg, None, params, run["cache"], execution=exe)
        row = {"prefill_ms": run["t_prefill"] * 1e3, "decode_step_ms": run["t_decode"] * 1e3,
               "prefill_device_ms": time_graph(lambda: prefill(params, batch), 1, 3),
               "decode_step_device_ms": time_graph(lambda: decode(params, tok, run["cache"]),
                                                   1, 5)}
        steps[backend] = row
        print(f"[moe-time] request A, {backend} backend: prefill {row['prefill_ms']:.1f} ms "
              f"host-paced, {row['prefill_device_ms']:.1f} ms on the device alone; decode step "
              f"{row['decode_step_ms']:.2f} ms host-paced, {row['decode_step_device_ms']:.2f} ms "
              f"on the device alone (idle share "
              f"{1 - row['decode_step_device_ms'] / row['decode_step_ms']:.2f})")
    return counts, steps


# ---------------------------------------------------------------------------
# phase 10: the audio / vision front-ends through the paper's DR front-end
# ---------------------------------------------------------------------------

def phase_frontend(dev):
    """hubert-xlarge and internvl2-1b `CONFIG_DR` at full width and depth.
    Raw features (frames or patches) drawn from a seed go through the DR
    front-end as the reference's train step and serving read them: the DR
    unit's init, one `dr_unit.update` on the first 4096 normalised rows
    (ternary_matmul + easi_apply), `_apply_dr_frontend` (fused_transform),
    then `api.prefill` (flash; non-causal for hubert) and, for internvl2,
    16 greedy decode steps.  After a warm-up of both backends, the kernel
    backend serves both models (counted), then the torch backend
    teacher-forced, which must launch nothing."""
    import torch
    from repro_torch.configs import hubert_xlarge, internvl2_1b
    from repro_torch.core import dr_unit
    from repro_torch.core.execution import Execution
    from repro_torch.models import api
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step

    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    b, s = FRONTEND_BATCH, FRONTEND_SEQ
    out = {}

    def run(cfg, params, raw, tokens, exe, forced=None):
        key = "frames" if cfg.frontend == "audio" else "patches"
        dcfg = train_step._dr_cfg(cfg)
        marks = [all_counts()]
        t0 = time.perf_counter()
        st = dr_unit.init(torch.Generator().manual_seed(7), dcfg, execution=exe)
        flat = train_step._dr_normalize(raw.reshape(-1, cfg.frontend_dim))
        st = dr_unit.update(st, dcfg, flat[:4096], execution=exe)
        batch = train_step._apply_dr_frontend(st, dcfg, {key: raw, **tokens}, execution=exe)
        torch.cuda.synchronize()
        t_dr = time.perf_counter() - t0
        marks.append(all_counts())
        cache_size = batch[key].shape[1] + (tokens["tokens"].shape[1] if tokens else 0) + \
            FRONTEND_DECODE * bool(cfg.causal)
        prefill = serve_step.make_prefill(cfg, None, params, batch, cache_size, execution=exe)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        outs, toks = [logits], []
        if cfg.causal:
            decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
            for i in range(FRONTEND_DECODE):
                tok = (logits.argmax(-1) if forced is None else forced[i]).to(torch.int32)
                toks.append(tok)
                logits, cache = decode(params, tok, cache)
                outs.append(logits)
        torch.cuda.synchronize()
        marks.append(all_counts())
        launches = {what: {n: after[n] - before[n] for n in after}
                    for what, before, after in zip(("dr", "lm"), marks, marks[1:])}
        return dict(b=st.b, feats=batch[key], logits=outs, tokens=toks, t_dr=t_dr,
                    t_prefill=t_prefill, launches=launches)

    models = {}
    for name, mod in (("hubert", hubert_xlarge), ("internvl2", internvl2_1b)):
        cfg = mod.CONFIG_DR
        t0 = time.perf_counter()
        params = api.init_params(torch.Generator(device=dev).manual_seed(4), cfg, execution=kexe)
        gen = torch.Generator(device=dev).manual_seed(5)
        if cfg.frontend == "audio":
            raw, tokens = torch.randn((b, s, cfg.frontend_dim), generator=gen, device=dev), {}
        else:
            raw = torch.randn((b, cfg.frontend_seq, cfg.frontend_dim), generator=gen, device=dev)
            tokens = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - cfg.frontend_seq),
                                              generator=gen, device=dev, dtype=torch.int32)}
        raw = raw * 3.0 + 0.5          # raw features at their own scale and offset
        torch.cuda.synchronize()
        models[name] = (cfg, params, raw, tokens, time.perf_counter() - t0)
        for exe in (kexe, texe):       # warm-up: first calls, allocator growth
            run(cfg, params, raw, tokens, exe)
    reset_counts()
    kern = {name: run(*m[:4], kexe) for name, m in models.items()}
    counts = all_counts()
    for name, (cfg, params, raw, tokens, t_init) in models.items():
        k = kern[name]
        t = run(cfg, params, raw, tokens, texe, forced=k["tokens"])
        if any(c for step in t["launches"].values() for c in step.values()):
            fail(f"frontend {name}: the torch backend launched kernels {t['launches']}")
        err_b = check_close(f"frontend {name} DR B after the update", k["b"], t["b"], **TRAJ_TOL)
        err_f = check_close(f"frontend {name} reduced features", k["feats"], t["feats"],
                            **TRAJ_TOL)
        if tuple(k["feats"].shape[-1:]) != (cfg.dr_frontend.n,):
            fail(f"frontend {name}: reduced features {tuple(k['feats'].shape)}")
        worst = (0.0, 0.0)
        for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
            if tuple(gk.shape) != (b, cfg.padded_vocab):
                fail(f"frontend {name}: logits shape {tuple(gk.shape)}")
            rel, mx = logits_diff(f"frontend {name} {'prefill' if i == 0 else f'decode {i}'}",
                                  gk, gt)
            worst = (max(worst[0], rel), max(worst[1], mx))
        want = {"dr": {"ternary_matmul": 1, "easi_apply": 1, "fused_transform": 1},
                "lm": {"flash_attention": cfg.n_layers}}
        for what, names in want.items():
            for n, c in names.items():
                if k["launches"][what][n] < c:
                    fail(f"frontend {name}: {n} launched {k['launches'][what][n]} times in "
                         f"{what}, want at least {c}")
        print(f"[frontend] {cfg.name} CONFIG_DR ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"heads {cfg.n_heads}/{cfg.n_kv_heads} dh {cfg.dh}, causal {cfg.causal}): "
              f"{cfg.frontend} features {tuple(raw.shape)} -> RP {cfg.dr_frontend.p} -> EASI "
              f"{cfg.dr_frontend.n}; params drawn in {t_init:.2f} s; DR init + update + "
              f"front-end {k['t_dr'] * 1e3:.1f} ms kernel / {t['t_dr'] * 1e3:.1f} torch; "
              f"prefill {k['t_prefill'] * 1e3:.1f} ms / {t['t_prefill'] * 1e3:.1f} "
              f"(host-paced), {len(k['logits']) - 1} decode steps")
        print(f"[frontend] {name}: max |B_kernel - B_torch| {err_b:.3e}, max |features| err "
              f"{err_f:.3e} (TRAJ_TOL); logits kernel vs torch: relative row norm "
              f"{worst[0]:.3e}, |err| {worst[1]:.3e}; launches {json.dumps(k['launches'])}")
        out[name] = {"max_abs_err_b": err_b, "max_abs_err_features": err_f,
                     "max_rel_norm": worst[0], "max_abs_err": worst[1],
                     "launches": k["launches"], "dr_ms": k["t_dr"] * 1e3,
                     "prefill_ms": k["t_prefill"] * 1e3, "torch_dr_ms": t["t_dr"] * 1e3,
                     "torch_prefill_ms": t["t_prefill"] * 1e3}
    counts = all_counts()
    missing = [n for n, c in counts.items() if c <= 0 and n != "flash_attention_bwd"]
    if missing or counts["flash_attention_bwd"]:
        fail(f"frontend: kernels never launched on the front-end path: {missing}, or a "
             f"backward launched: {counts}")
    print(f"[frontend] launches on the front-end path: {json.dumps(counts)}")
    return counts, out


# ---------------------------------------------------------------------------
# phases 11 and 12: the recurrent families at full width and depth
# ---------------------------------------------------------------------------

def recurrent_model(dev, arch, seed):
    """(config, params drawn on the card, request A's prompts, the 16 tokens
    its decode steps are forced with)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.models import api

    cfg = registry.get(arch)
    spec = LM_REQUESTS["A"]
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                             execution=Execution(device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for tree in (params, params["layers"], params.get("shared", {}))
                   for t in tree.values() if isinstance(t, torch.Tensor))
    print(f"[{cfg.family}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.padded_vocab}; {n_params} f32 params "
          f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"] + spec["decode"]),
                         generator=gen, device=dev, dtype=torch.int32)
    return cfg, params, toks[:, :spec["prompt"]], toks[:, spec["prompt"]:]


def serve_forced(cfg, params, prompts, forced, exe, cache_size):
    """Prefill, then one decode step per column of `forced` (teacher
    forcing), through `serve_step`; host-paced times and flash launches."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.serve import serve_step

    batch = {"tokens": prompts}
    marks = [flash_attention.launches]
    prefill = serve_step.make_prefill(cfg, None, params, batch, cache_size, execution=exe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    marks.append(flash_attention.launches)
    decode = serve_step.make_decode(cfg, None, params, cache, execution=exe)
    outs = [logits]
    t0 = time.perf_counter()
    for i in range(forced.shape[1]):
        logits, cache = decode(params, forced[:, i], cache)
        outs.append(logits)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / max(1, forced.shape[1])
    marks.append(flash_attention.launches)
    if int(cache["pos"]) != prompts.shape[1] + forced.shape[1]:
        fail(f"{cfg.name}: state pos {int(cache['pos'])}")
    return dict(logits=outs, cache=cache, t_prefill=t_prefill, t_decode=t_decode,
                flash={"prefill": marks[1] - marks[0], "decode": marks[2] - marks[1]})


def state_bytes(cache) -> dict:
    return {name: t.numel() * t.element_size() for name, t in cache.items()
            if t.is_cuda}


def device_ops(fn, top: int = 8):
    """One call of fn under torch.profiler: the device's busy ms, its kernel
    count, and the device ms of the `top` ops that launched the most device
    time (by the aten op that launched each kernel); None where the trace
    shows no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    by_op = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CPU and us:
            by_op[e.key] = by_op.get(e.key, 0.0) + us / 1e3
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
            "kernels": len(device), "top_ms": {k: round(v, 4) for k, v in ranked}}


def decode_timing(cfg, params, run, exe, prompts, dev, what, with_prefill):
    """Device-only step times (CUDA-graph replay) beside the host-paced ones
    of `run`, the device's idle share of a decode step, and on the kernel
    backend where a step's device time goes (`device_ops`)."""
    import torch
    from repro_torch.serve import serve_step

    spec = LM_REQUESTS["A"]
    tok = torch.zeros((spec["batch"],), dtype=torch.int32, device=dev)
    batch = {"tokens": prompts}
    decode = serve_step.make_decode(cfg, None, params, run["cache"], execution=exe)
    prefill = serve_step.make_prefill(cfg, None, params, batch, spec["cache"], execution=exe)
    row = {"prefill_ms": run["t_prefill"] * 1e3, "decode_step_ms": run["t_decode"] * 1e3,
           "decode_step_device_ms": time_graph(lambda: decode(params, tok, run["cache"]), 1, 5)}
    row["decode_idle_share"] = 1 - row["decode_step_device_ms"] / row["decode_step_ms"]
    text = ""
    if with_prefill:
        row["prefill_device_ms"] = time_graph(lambda: prefill(params, batch), 1, 3)
        text = f", {row['prefill_device_ms']:.1f} ms on the device alone"
    print(f"[{what}-time] request A, {exe.backend} backend: prefill {row['prefill_ms']:.1f} ms "
          f"host-paced{text}; decode step {row['decode_step_ms']:.2f} ms host-paced, "
          f"{row['decode_step_device_ms']:.2f} ms on the device alone (idle share "
          f"{row['decode_idle_share']:.2f})")
    if exe.backend == "kernel":
        steps = [("decode step", lambda: decode(params, tok, run["cache"]))]
        if with_prefill:
            steps.insert(0, ("prefill", lambda: prefill(params, batch)))
        for step, fn in steps:
            ops = device_ops(fn)
            row[f"{step.replace(' ', '_')}_device_ops"] = ops
            text = ("not measured (the trace shows no device work)" if ops is None else
                    f"device busy {ops['busy_ms']:.2f} ms in {ops['kernels']} kernels; by "
                    f"launching op (ms) {json.dumps(ops['top_ms'])}")
            print(f"[{what}-ops] request A {step}, {exe.backend} backend: {text}")
    return row


def phase_rwkv6(dev):
    """rwkv6-1.6b at full width and depth: request A (4 x 1024 tokens, 16
    decode steps forced with drawn tokens) on the kernel backend, counted,
    then on the torch backend.  No kernel is on this path: every counter
    must read 0, and the backends must agree bit for bit.  Then decode
    against a prefill of all 1040 tokens, the reference's own
    test_rwkv_decode_matches_forward at full size."""
    import torch
    from repro_torch.core.execution import Execution
    from repro_torch.serve import serve_step

    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, prompts, forced = recurrent_model(dev, RWKV_ARCH, 6)
    spec = LM_REQUESTS["A"]
    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    for exe in (kexe, texe):              # warm-up: first calls, allocator growth
        serve_forced(cfg, params, prompts, forced, exe, spec["cache"])
    reset_counts()
    k = serve_forced(cfg, params, prompts, forced, kexe, spec["cache"])
    counts = all_counts()
    if any(counts.values()):
        fail(f"rwkv6: kernels launched on a path that has none: {counts}")
    t = serve_forced(cfg, params, prompts, forced, texe, spec["cache"])
    for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
        if tuple(gk.shape) != (spec["batch"], cfg.padded_vocab) or \
                not bool(torch.isfinite(gk).all()):
            fail(f"rwkv6: logits at step {i}: shape {tuple(gk.shape)} or non-finite")
        if not torch.equal(gk, gt):
            fail(f"rwkv6: kernel and torch backends differ at step {i}")
    for name, leaf in k["cache"].items():
        if not torch.equal(leaf, t["cache"][name]):
            fail(f"rwkv6: kernel and torch backends differ on state {name}")
    # decode after 1024 tokens against a prefill of all 1040
    full = {"tokens": torch.cat([prompts, forced], dim=1)}
    long_prefill = serve_step.make_prefill(cfg, None, params, full, spec["cache"],
                                           execution=kexe)
    want, want_state = long_prefill(params, full)
    rel, mx = logits_diff("rwkv6 decode step 16", k["logits"][-1], want,
                          pair=f"decode vs a prefill of {full['tokens'].shape[1]} tokens")
    wkv = k["cache"]["wkv"]
    wkv_rel = float((wkv - want_state["wkv"]).norm() / want_state["wkv"].norm())
    nbytes = state_bytes(k["cache"])
    print(f"[rwkv6] request A ({spec['batch']} x {spec['prompt']} tokens, {spec['decode']} "
          f"forced decode steps): no kernel on this path, every launch counter reads 0 "
          f"{json.dumps(counts)}; kernel and torch backends bit-identical on "
          f"{len(k['logits'])} logits and every state leaf; decode vs a prefill of "
          f"{full['tokens'].shape[1]} tokens: relative row norm {rel:.3e} (bound {LM_REL_NORM}), "
          f"|err| {mx:.3e} (bound {LM_MAX_ABS}), wkv state relative norm {wkv_rel:.3e}")
    print(f"[rwkv6] state bytes {json.dumps(nbytes)} (wkv {tuple(wkv.shape)} f32); prefill "
          f"{k['t_prefill'] * 1e3:.1f} ms kernel / {t['t_prefill'] * 1e3:.1f} ms torch, decode "
          f"step {k['t_decode'] * 1e3:.2f} / {t['t_decode'] * 1e3:.2f} ms (host-paced); peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    row = decode_timing(cfg, params, k, kexe, prompts, dev, "rwkv6", with_prefill=False)
    out = {"decode_vs_prefill_rel_norm": rel, "decode_vs_prefill_max_abs_err": mx,
           "wkv_rel_norm": wkv_rel, "state_bytes": nbytes, "kernel": row,
           "torch": {"prefill_ms": t["t_prefill"] * 1e3, "decode_step_ms": t["t_decode"] * 1e3},
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return counts, out


def phase_zamba(dev):
    """zamba2-7b at full width and depth: request A (16 decode steps forced
    with drawn tokens) on the kernel backend, counted, then on the torch
    backend: logits and every cache leaf within the LM bounds, flash
    launched once per shared-block application of a prefill and never in
    decode.  Then, in f32 on the torch backend, the SSD block form against
    the step form over all 81 layers: a prefill of ZAMBA_SPLIT tokens and
    teacher-forced decode steps to 1024 against a prefill of 1024."""
    import dataclasses

    import torch
    from repro_torch.core.execution import Execution
    from repro_torch.models import ssm

    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, prompts, forced = recurrent_model(dev, ZAMBA_ARCH, 8)
    spec = LM_REQUESTS["A"]
    slots = ssm.n_shared_slots(cfg)
    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    for exe in (kexe, texe):              # warm-up: first calls, allocator growth
        serve_forced(cfg, params, prompts, forced, exe, spec["cache"])
    reset_counts()
    k = serve_forced(cfg, params, prompts, forced, kexe, spec["cache"])
    counts = all_counts()
    t = serve_forced(cfg, params, prompts, forced, texe, spec["cache"])
    if k["flash"] != {"prefill": slots, "decode": 0}:
        fail(f"zamba: flash launches {k['flash']}, want {slots} per prefill and none in decode")
    if counts["flash_attention"] != slots or t["flash"] != {"prefill": 0, "decode": 0}:
        fail(f"zamba: launches {counts} on the kernel path, {t['flash']} on the torch path")
    worst = (0.0, 0.0)
    for i, (gk, gt) in enumerate(zip(k["logits"], t["logits"])):
        if tuple(gk.shape) != (spec["batch"], cfg.padded_vocab):
            fail(f"zamba: logits shape {tuple(gk.shape)}")
        rel, mx = logits_diff(f"zamba {'prefill' if i == 0 else f'decode {i}'}", gk, gt)
        worst = (max(worst[0], rel), max(worst[1], mx))
    leaf_rel = {}
    for name in ("ssm", "conv", "k", "v"):
        kc, tc = k["cache"][name].to(torch.float32), t["cache"][name].to(torch.float32)
        leaf_rel[name] = float((kc - tc).norm() / tc.norm())
        if not bool(torch.isfinite(kc).all()) or not leaf_rel[name] <= LM_REL_NORM:
            fail(f"zamba: cache {name} relative norm {leaf_rel[name]:.3e} (bound {LM_REL_NORM})")
    nbytes = state_bytes(k["cache"])
    print(f"[zamba] request A ({spec['batch']} x {spec['prompt']} tokens, {spec['decode']} forced "
          f"decode steps, cache {spec['cache']}): kernel vs torch backend: largest relative row "
          f"norm {worst[0]:.3e} (bound {LM_REL_NORM}), largest |err| {worst[1]:.3e} (bound "
          f"{LM_MAX_ABS}); cache leaves' relative norms {json.dumps(leaf_rel)}; flash launches "
          f"{json.dumps(k['flash'])} ({slots} shared-block slots); launches {json.dumps(counts)}")
    print(f"[zamba] cache bytes {json.dumps(nbytes)}; prefill {k['t_prefill'] * 1e3:.1f} ms "
          f"kernel / {t['t_prefill'] * 1e3:.1f} ms torch, decode step {k['t_decode'] * 1e3:.2f} / "
          f"{t['t_decode'] * 1e3:.2f} ms (host-paced); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    rows = {backend: decode_timing(cfg, params, run, exe, prompts, dev, "zamba",
                                   with_prefill=True)
            for backend, exe, run in (("kernel", kexe, k), ("torch", texe, t))}
    del k, t
    # the SSD block form against the step form at full depth, in f32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    split = serve_forced(cfg32, params, prompts[:, :ZAMBA_SPLIT], prompts[:, ZAMBA_SPLIT:], texe,
                         spec["prompt"])
    whole = serve_forced(cfg32, params, prompts, prompts[:, :0], texe, spec["prompt"])
    g, w = split["logits"][-1], whole["logits"][0]
    block_step = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
    if not bool(torch.isfinite(g).all()) or not block_step <= ZAMBA_BLOCK_STEP_REL_NORM:
        fail(f"zamba f32: prefill {ZAMBA_SPLIT} + {spec['prompt'] - ZAMBA_SPLIT} decode steps vs "
             f"prefill {spec['prompt']}: relative row norm {block_step:.3e} (bound "
             f"{ZAMBA_BLOCK_STEP_REL_NORM})")
    print(f"[zamba] f32, torch backend: prefill {ZAMBA_SPLIT} (block form) + "
          f"{spec['prompt'] - ZAMBA_SPLIT} decode steps (step form) vs prefill {spec['prompt']} "
          f"(block form) over {cfg.n_layers} layers: relative row norm {block_step:.3e} (bound "
          f"{ZAMBA_BLOCK_STEP_REL_NORM}), max |err| {float((g - w).abs().max()):.3e}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    out = {"max_rel_norm": worst[0], "max_abs_err": worst[1], "cache_rel_norm": leaf_rel,
           "cache_bytes": nbytes, "block_vs_step_rel_norm_f32": block_step, **rows,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return counts, out


def phase_zamba_published(dev):
    """Zamba2-7B-Instruct at its published layout (configs/zamba2_7b.PUBLISHED)
    at full width and depth: 81 Mamba-2 layers with B and C in 2 groups, 2
    shared blocks in alternation at 13 layers (32/32 heads of Dh 224,
    per-use adapters and output Linears), 7.36 B f32 params drawn on the
    card.  One prompt of ZAMBA_PUB_PROMPT tokens through `api.prefill` on the
    kernel backend, counted from zero, then on the torch backend, in bf16,
    and on the torch backend in f32: kernel vs torch within
    ZAMBA_PUB_REL_NORM on the last logits' relative row norm and on every
    cache leaf, B4 launched once a use of a shared block on the kernel path
    and never on the torch path."""
    import dataclasses

    import torch
    from repro_torch.configs.zamba2_7b import PUBLISHED as cfg
    from repro_torch.core.execution import Execution
    from repro_torch.models import api

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(32), cfg,
                             execution=Execution(device=dev))
    torch.cuda.synchronize()
    print(f"[zamba-published] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{len(cfg.hybrid.layer_ids)} uses of {cfg.hybrid.n_blocks} shared blocks (heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of Dh {cfg.dh}), {cfg.ssm.n_groups} SSD groups; "
          f"{cfg.param_count()} f32 params drawn on the card in {time.perf_counter() - t0:.2f} s")
    toks = torch.randint(0, cfg.vocab_size, (1, ZAMBA_PUB_PROMPT), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(33), device=dev)
    uses = len(cfg.hybrid.layer_ids)
    runs = {}
    for name, backend, c in (("kernel", "kernel", cfg), ("torch", "torch", cfg),
                             ("torch_f32", "torch",
                              dataclasses.replace(cfg, compute_dtype="float32"))):
        exe = Execution(backend=backend, device=dev)
        api.prefill(params, {"tokens": toks}, c, ZAMBA_PUB_PROMPT, execution=exe)     # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": toks}, c, ZAMBA_PUB_PROMPT, execution=exe)
        torch.cuda.synchronize()
        runs[name] = dict(logits=logits.to(torch.float32), cache=cache, counts=all_counts(),
                          ms=(time.perf_counter() - t) * 1e3)
    k, t, w32 = runs["kernel"], runs["torch"], runs["torch_f32"]["logits"]
    flash = {name: r["counts"]["flash_attention"] for name, r in runs.items()}
    if flash != {"kernel": uses, "torch": 0, "torch_f32": 0}:
        fail(f"zamba-published: flash launches {flash}; want {uses} on the kernel path, none on "
             f"the torch path")
    g, w = k["logits"], t["logits"]
    if tuple(g.shape) != (1, cfg.padded_vocab) or not bool(torch.isfinite(g).all()):
        fail(f"zamba-published: logits of shape {tuple(g.shape)}, finite "
             f"{bool(torch.isfinite(g).all())}")

    def rel(a, b):
        return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())

    rels = {"kernel_vs_torch": rel(g, w), "kernel_vs_f32": rel(g, w32),
            "torch_vs_f32": rel(w, w32)}
    if not rels["kernel_vs_torch"] <= ZAMBA_PUB_REL_NORM:
        fail(f"zamba-published: kernel vs torch backend: relative row norm "
             f"{rels['kernel_vs_torch']:.3e} (bound {ZAMBA_PUB_REL_NORM})")
    leaf_rel = {}
    for name in ("ssm", "conv", "k", "v"):
        kc, tc = k["cache"][name].to(torch.float32), t["cache"][name].to(torch.float32)
        leaf_rel[name] = float((kc - tc).norm() / tc.norm())
        if not bool(torch.isfinite(kc).all()) or not leaf_rel[name] <= ZAMBA_PUB_REL_NORM:
            fail(f"zamba-published: cache {name} relative norm {leaf_rel[name]:.3e} (bound "
                 f"{ZAMBA_PUB_REL_NORM})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = {name: r["ms"] for name, r in runs.items()}
    print(f"[zamba-published] 1 x {ZAMBA_PUB_PROMPT} tokens through api.prefill: last logits' "
          f"relative row norms {json.dumps(rels)} (kernel vs torch bound {ZAMBA_PUB_REL_NORM}); "
          f"cache leaves kernel vs torch {json.dumps(leaf_rel)}; flash launches "
          f"{json.dumps(flash)} ({uses} uses); prefill ms (host-paced) {json.dumps(ms)}; peak "
          f"memory {peak:.1f} GiB")
    out = {"rel_norm": rels, "cache_rel_norm": leaf_rel, "flash_launches": flash,
           "prefill_ms": ms, "peak_gib": peak}
    return k["counts"], out


def flash_geometry_timing(dev):
    """The bf16 kernel at the prefill shape of each new head geometry (4 x
    1024 positions), beside its plain version, SDPA (timed only) and its
    bound; each checked against the plain version first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention

    rows = []
    for name, (hq, hkv, dh, causal) in FLASH_GEOMETRIES.items():
        b, s = LM_REQUESTS["A"]["batch"], LM_REQUESTS["A"]["prompt"]
        gen = torch.Generator().manual_seed(97)
        q, k, v = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
                   for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
        kern = lambda: flash_attention.flash_attention(q, k, v, causal=causal)
        plain = lambda: flash_attention.plain(q, k, v, causal=causal)
        g = hq // hkv
        qs, ks, vs = (q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
                      v.repeat_interleave(g, dim=2).transpose(1, 2))
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        want, got = plain(), kern()
        err = check_close(f"flash_attention at the {name} shape", got, want, **FLASH_TOL["bf16"])
        wide = [t.to(torch.float32) for t in (q, k, v)]
        norms = check_flash_norm(f"flash_attention at the {name} shape", got, want,
                                 flash_attention.plain(*wide, causal=causal))
        lib_err = max_err(lib().transpose(1, 2), want)
        del got
        dev_ms, plain_dev_ms, lib_dev_ms = (time_graph(kern, 10, 3), time_graph(plain, 3, 2),
                                            time_graph(lib, 10, 3))
        pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
        flops = 4.0 * dh * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        bms, bby = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
        print(f"[time] flash_attention {name} {[b, s, hq, hkv, dh]} bf16 causal {causal}: "
              f"device-only {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s); plain "
              f"(device) {plain_dev_ms:.4f} ms; SDPA (device) {lib_dev_ms:.4f} ms (max |err| "
              f"against the plain version {lib_err:.3e}); bound {bms:.6f} ms ({bby}); max "
              f"|err| {err:.3e}, relative norm {norms['rel_norm']:.3e}")
        rows.append({"geometry": name, "shape": [b, s, hq, hkv, dh], "causal": causal,
                     "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
                     "library_device_ms": lib_dev_ms, "bound_ms": bms, "bound_by": bby,
                     "max_abs_err": err, "library_max_abs_err": lib_err, **norms})
    return rows


# ---------------------------------------------------------------------------
# phases 13-17: LM training
# ---------------------------------------------------------------------------

def tree_worst_rel(got, want):
    """(largest relative norm of got − want over the leaves of two trees of
    the same nesting, its leaf's path, the relative norm of all leaves at
    once); a non-finite leaf counts as inf."""
    import torch
    from repro_torch.checkpoint.manager import flatten_with_path

    worst, num, den = (0.0, ""), 0.0, 0.0
    for (path, g), (_, w) in zip(flatten_with_path(got), flatten_with_path(want)):
        g32, w32 = g.to(torch.float32), w.to(torch.float32)
        d2, w2 = float((g32 - w32).square().sum()), float(w32.square().sum())
        rel = math.sqrt(d2 / max(w2, 1e-60))
        if not bool(torch.isfinite(g32).all()):
            rel = d2 = math.inf
        num, den = num + d2, den + w2
        if not rel <= worst[0]:
            worst = (rel, path)
    return worst[0], worst[1], math.sqrt(num / max(den, 1e-60))


def trees_equal(got, want) -> list:
    """The paths of the leaves that differ in any bit."""
    import torch
    from repro_torch.checkpoint.manager import flatten_with_path

    return [p for (p, g), (_, w) in zip(flatten_with_path(got), flatten_with_path(want))
            if not torch.equal(torch.as_tensor(g), torch.as_tensor(w))]


def to_device(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def backend_grads(what, tcfg, state, batch, dev, *, bit_identical=False):
    """Loss and gradients from one state and batch on the kernel backend
    (counted) and on the torch backend: the loss and every gradient leaf
    within LM_REL_NORM in relative norm (or equal bit for bit).  Returns
    (readings, the kernel run's launches)."""
    import torch
    from repro_torch.core.execution import Execution
    from repro_torch.train import train_step as ts

    runs = {}
    for name in ("kernel", "torch"):
        exe = Execution(backend=name, device=dev)
        loss_fn = ts.make_loss(tcfg, ts._dr_cfg(tcfg.arch), execution=exe)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, grads = ts.value_and_grad(loss_fn, state.params, state.dr, batch)
        torch.cuda.synchronize()
        runs[name] = (loss, grads, time.perf_counter() - t0, all_counts())
    (lk, gk, tk, counts), (lt, gt, tt, _) = runs["kernel"], runs["torch"]
    if not (math.isfinite(float(lk)) and math.isfinite(float(lt))):
        fail(f"{what}: non-finite loss {float(lk)} / {float(lt)}")
    loss_rel = abs(float(lk) - float(lt)) / abs(float(lt))
    if bit_identical:
        diff = trees_equal(gk, gt)
        if diff or not torch.equal(lk, lt):
            fail(f"{what}: kernel and torch backends differ: loss {float(lk)} / {float(lt)}, "
                 f"gradient leaves {diff[:5]}")
        grad_rel = (0.0, "", 0.0)
    else:
        grad_rel = tree_worst_rel(gk, gt)
        if not loss_rel <= LM_REL_NORM or not grad_rel[2] <= LM_REL_NORM or \
                not grad_rel[0] <= GRAD_LEAF_REL_NORM:
            fail(f"{what}: kernel vs torch backend: loss relative {loss_rel:.3e}, gradient "
                 f"relative norm {grad_rel[2]:.3e} (bound {LM_REL_NORM}), leaf {grad_rel[1]} "
                 f"{grad_rel[0]:.3e} (bound {GRAD_LEAF_REL_NORM})")
    print(f"[{what}] loss kernel {float(lk):.6f} / torch {float(lt):.6f} (relative "
          f"{loss_rel:.3e}); gradient relative norm {grad_rel[2]:.3e} (bound {LM_REL_NORM}), "
          f"largest by leaf {grad_rel[0]:.3e} at {grad_rel[1] or '-'} (bound "
          f"{GRAD_LEAF_REL_NORM}); loss + grads {tk * 1e3:.1f} ms kernel / {tt * 1e3:.1f} ms "
          f"torch (host-paced, first call); launches {json.dumps(counts)}")
    return {"loss_kernel": float(lk), "loss_torch": float(lt), "loss_rel": loss_rel,
            "grad_rel_norm": grad_rel[2], "grad_max_leaf_rel_norm": grad_rel[0],
            "grad_worst_leaf": grad_rel[1]}, counts


def model_flops(cfg, tokens: int, batch: int, seq: int) -> float:
    """6·N·tokens (N from `api.exact_param_counts`, active for MoE) plus
    attention's forward 4·B·S²·Hq·Dh a layer, × 3.5 for its backward and
    remat recompute."""
    from repro_torch.models import api

    _, active = api.exact_param_counts(cfg)
    n_attn = cfg.n_layers if cfg.family == "transformer" else 0
    return 6.0 * active * tokens + 3.5 * 4.0 * batch * seq * seq * cfg.n_heads * cfg.dh * n_attn


def run_steps(what, step_fn, state, batches, dev):
    """The train steps over `batches` (counted from 0 by the caller):
    (state, losses, host-paced seconds of each step)."""
    import torch

    losses, secs = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not math.isfinite(losses[-1]) or not math.isfinite(float(metrics["grad_norm"])):
            fail(f"{what}: non-finite loss or grad norm at step {len(losses)}: {metrics}")
    return state, losses, secs


def step_timing(what, cfg, step_fn, state, batch, secs, batch_size, seq, dev):
    """Host-paced ms a step (the mean after the first), device-busy ms of one
    more step from a torch.profiler trace, the idle share, tokens/s, model
    TFLOP/s and peak memory."""
    import torch

    host_ms = sum(secs[1:]) / max(1, len(secs) - 1) * 1e3
    ops = device_ops(lambda: step_fn(state, batch))
    tokens = batch_size * seq
    flops = model_flops(cfg, tokens, batch_size, seq)
    row = {"step_ms": host_ms, "device_busy_ms": None if ops is None else ops["busy_ms"],
           "idle_share": None if ops is None else 1 - ops["busy_ms"] / host_ms,
           "tokens_per_s": tokens / host_ms * 1e3, "model_tflops": flops / host_ms / 1e9,
           "model_flops": flops, "device_kernels": None if ops is None else ops["kernels"],
           "device_top_ms": None if ops is None else ops["top_ms"],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[train-time] {what}: step {host_ms:.1f} ms host-paced, device busy "
          f"{fmt_ms(row['device_busy_ms'])} ms (idle share {fmt_share(row['idle_share'])}), "
          f"{row['tokens_per_s']:.0f} tokens/s, model {row['model_tflops']:.1f} TFLOP/s "
          f"({flops:.4e} FLOP a step), peak {row['peak_gib']:.1f} GiB; device ms by launching "
          f"op {json.dumps(row['device_top_ms'])}")
    return row


def phase_train_lm(dev):
    """h2o-danube-3-4b at full width, TRAIN_LM["layers"] of its 24 layers,
    2 x 4096 tokens from the synthetic stream: loss and every gradient leaf
    on the kernel backend against the torch backend from one seeded state,
    then TRAIN_LM["steps"] steps of `make_train_step` on the kernel backend,
    counted (flash twice a layer a step: forward and remat recompute)."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.data import synthetic
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(registry.get(LM_ARCH), n_layers=TRAIN_LM["layers"])
    tcfg = ts.TrainConfig(arch=cfg)
    t0 = time.perf_counter()
    state = ts.init_state(torch.Generator(device=dev).manual_seed(11), tcfg,
                          execution=Execution(device=dev))
    n_params = sum(t.numel() for t in opt_mod.tree_leaves(state.params))
    torch.cuda.synchronize()
    print(f"[train-lm] {cfg.name} at full width, {cfg.n_layers} of 24 layers: {n_params} f32 "
          f"params drawn on the card in {time.perf_counter() - t0:.2f} s; batch "
          f"{TRAIN_LM['batch']} x {TRAIN_LM['seq']} tokens")
    data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LM["seq"],
                                       global_batch=TRAIN_LM["batch"], seed=0)
    batches = [to_device({"tokens": synthetic.token_batch(data, i)["tokens"]}, dev)
               for i in range(TRAIN_LM["steps"] + 1)]
    grads, counts_g = backend_grads("train-lm", tcfg, state, batches[0], dev)
    if counts_g["flash_attention"] != 2 * cfg.n_layers or \
            counts_g["flash_attention_bwd"] != 2 * cfg.n_layers:
        fail(f"train-lm: flash launched {counts_g['flash_attention']} times and its backward "
             f"{counts_g['flash_attention_bwd']} in one loss + grads, want {2 * cfg.n_layers} "
             f"each (forward and remat recompute per layer; the backward's two passes)")
    step_fn = ts.make_train_step(tcfg, execution=Execution(backend="kernel", device=dev))
    reset_counts()
    state, losses, secs = run_steps("train-lm", step_fn, state, batches[:TRAIN_LM["steps"]], dev)
    counts = all_counts()
    want = 2 * cfg.n_layers * TRAIN_LM["steps"]
    if counts["flash_attention"] != want or counts["flash_attention_bwd"] != want:
        fail(f"train-lm: flash launched {counts['flash_attention']} times and its backward "
             f"{counts['flash_attention_bwd']} in {TRAIN_LM['steps']} steps, want {want} each")
    print(f"[train-lm] {TRAIN_LM['steps']} train steps (kernel backend): losses "
          f"{json.dumps(losses)}; launches {json.dumps(counts)}")
    timing = step_timing(f"h2o-danube-3-4b ({cfg.n_layers} layers, {TRAIN_LM['batch']} x "
                         f"{TRAIN_LM['seq']})", cfg, step_fn, state, batches[-1], secs,
                         TRAIN_LM["batch"], TRAIN_LM["seq"], dev)
    return counts, {"grads": grads, "losses": losses, "step_seconds": secs, **timing}


def phase_train_dr(dev):
    """hubert-xlarge CONFIG_DR at full width and depth, 2 x 1024 frames of 512
    features from the synthetic stream: loss and gradients kernel vs torch
    from one seeded state, then TRAIN_DR["steps"] train steps on each
    backend from that state, the DR unit co-trained in each (its B after
    every step within TRAJ_TOL between backends); every kernel launched on
    the kernel path, counted."""
    import torch
    from repro_torch.configs import hubert_xlarge
    from repro_torch.core.execution import Execution
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = hubert_xlarge.CONFIG_DR
    tcfg = ts.TrainConfig(arch=cfg)

    def fresh():        # the card's generator repeats its draws from a seed
        return ts.init_state(torch.Generator(device=dev).manual_seed(12), tcfg,
                             execution=Execution(device=dev))

    data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_DR["seq"],
                                       global_batch=TRAIN_DR["batch"], seed=0)
    batches = [to_device(trainer.make_batch(cfg, data, i), dev)
               for i in range(TRAIN_DR["steps"] + 1)]
    print(f"[train-dr] {cfg.name} CONFIG_DR ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} dh {cfg.dh}, non-causal): frames "
          f"{tuple(batches[0]['frames'].shape)} -> RP {cfg.dr_frontend.p} -> EASI "
          f"{cfg.dr_frontend.n}")
    grads, _ = backend_grads("train-dr", tcfg, fresh(), batches[0], dev)
    states = {"kernel": fresh(), "torch": fresh()}
    steps = {name: ts.make_train_step(tcfg, execution=Execution(backend=name, device=dev))
             for name in states}
    losses = {"kernel": [], "torch": []}
    counts, secs, err_b = {}, [], []
    for i in range(TRAIN_DR["steps"]):
        reset_counts()
        states["kernel"], ls, sc = run_steps("train-dr", steps["kernel"], states["kernel"],
                                             [batches[i]], dev)
        counts = {k: counts.get(k, 0) + c for k, c in all_counts().items()}
        losses["kernel"] += ls
        secs += sc
        states["torch"], ls, _ = run_steps("train-dr", steps["torch"], states["torch"],
                                           [batches[i]], dev)
        losses["torch"] += ls
        err_b.append(check_close(f"train-dr DR B after step {i + 1}", states["kernel"].dr.b,
                                 states["torch"].dr.b, **TRAJ_TOL))
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        fail(f"train-dr: kernels never launched on the training path: {missing}")
    want = 2 * cfg.n_layers * TRAIN_DR["steps"]
    if counts["flash_attention"] != want or counts["flash_attention_bwd"] != want:
        fail(f"train-dr: flash launched {counts['flash_attention']} times and its backward "
             f"{counts['flash_attention_bwd']}, want {want} each (two a layer a step)")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["torch"]))
    if not rel <= LM_REL_NORM:
        fail(f"train-dr: losses kernel {losses['kernel']} vs torch {losses['torch']}")
    print(f"[train-dr] {TRAIN_DR['steps']} train steps a backend: losses kernel "
          f"{json.dumps(losses['kernel'])} / torch {json.dumps(losses['torch'])}; max |B_kernel - "
          f"B_torch| after each step {json.dumps(err_b)} (TRAJ_TOL); DR steps "
          f"{int(states['kernel'].dr.steps)}; launches on the kernel path {json.dumps(counts)}")
    timing = step_timing(f"hubert-xlarge CONFIG_DR ({TRAIN_DR['batch']} x {TRAIN_DR['seq']})",
                         cfg, steps["kernel"], states["kernel"], batches[-1], secs,
                         TRAIN_DR["batch"], TRAIN_DR["seq"], dev)
    return counts, {"grads": grads, "losses": losses, "max_abs_err_b": err_b,
                    "step_seconds": secs, **timing}


def deterministic_warnings(fn):
    """fn() with `torch.use_deterministic_algorithms(True, warn_only=True)`:
    (its result, the first line of each distinct warning, which names an op
    that has no deterministic implementation on the card)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = fn()
        finally:
            torch.use_deterministic_algorithms(False)
    notes = sorted({str(w.message).strip().splitlines()[0][:160] for w in caught
                    if "determinis" in str(w.message).lower()})
    return out, notes


def phase_train_recurrent(dev):
    """The recurrent families at full width and reduced depth, each with its
    own train_grad_accum: rwkv6-1.6b (TRAIN_RWKV) on both backends
    bit-identical with no launch (deterministic algorithms on), and
    zamba2-7b (TRAIN_ZAMBA) within the LM bounds, flash counted: loss and
    gradients of one micro-batch, then one train step a backend.  Each
    backend's state is drawn anew from the same seed (the card's generator
    repeats its draws), so no second copy of a state is held."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as ts

    out, counts = {}, {}
    for arch, spec, seed in ((RWKV_ARCH, TRAIN_RWKV, 13), (ZAMBA_ARCH, TRAIN_ZAMBA, 14)):
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = dataclasses.replace(registry.get(arch), n_layers=spec["layers"])
        if cfg.train_grad_accum != 2:
            fail(f"train-recurrent: {cfg.name} train_grad_accum {cfg.train_grad_accum}, want 2")
        tcfg = ts.TrainConfig(arch=cfg, grad_accum=cfg.train_grad_accum)

        def fresh():
            return ts.init_state(torch.Generator(device=dev).manual_seed(seed), tcfg,
                                 execution=Execution(device=dev))

        data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                                           global_batch=spec["batch"], seed=0)
        batch = to_device({"tokens": synthetic.token_batch(data, 0)["tokens"]}, dev)
        micro = {"tokens": batch["tokens"][: spec["batch"] // cfg.train_grad_accum]}
        name = cfg.family
        bit = name == "rwkv6"
        what = f"train-recurrent {name}"
        t0 = time.perf_counter()

        def run():
            grads, cg = backend_grads(what, tcfg, fresh(), micro, dev, bit_identical=bit)
            finals = {}
            for backend in ("kernel", "torch"):
                step = ts.make_train_step(tcfg, execution=Execution(backend=backend, device=dev))
                reset_counts()
                st, losses, secs = run_steps(what, step, fresh(), [batch], dev)
                finals[backend] = (st if bit else st.params, losses, secs, all_counts())
                del st
            return grads, cg, finals

        (grads, cg, finals), notes = deterministic_warnings(run) if bit else (run(), [])
        (k_final, k_losses, secs, c), (t_final, t_losses, _, _) = finals["kernel"], \
            finals["torch"]
        if bit:
            diff = trees_equal(k_final, t_final)
            if any(c.values()) or any(cg.values()) or diff or k_losses != t_losses:
                fail(f"train-recurrent rwkv6: launches {c} / {cg}, or the backends' states "
                     f"differ after a train step: {diff[:5]}, losses {k_losses} / {t_losses}")
            state_rel = (0.0, "", 0.0)
            text = "bit-identical states"
        else:
            want = 2 * 2 * -(-cfg.n_layers // cfg.hybrid.attn_every)
            if any(c[n_] != want or cg[n_] != want // 2
                   for n_ in ("flash_attention", "flash_attention_bwd")):
                fail(f"train-recurrent zamba: flash launched {c['flash_attention']} times in a "
                     f"step (want {want}: 2 applications x forward + recompute x 2 "
                     f"micro-batches), {cg['flash_attention']} in one micro-batch's loss + "
                     f"grads; its backward {c['flash_attention_bwd']} / "
                     f"{cg['flash_attention_bwd']} (two passes a call: the same counts)")
            state_rel = tree_worst_rel(k_final, t_final)
            if abs(k_losses[0] - t_losses[0]) / abs(t_losses[0]) > LM_REL_NORM:
                fail(f"train-recurrent zamba: step losses {k_losses} / {t_losses}")
            text = (f"params after the step: relative norm {state_rel[2]:.3e}, largest by leaf "
                    f"{state_rel[0]:.3e} at {state_rel[1]}")
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        print(f"[train-recurrent] {cfg.name} ({cfg.n_layers} layers, {spec['batch']} x "
              f"{spec['seq']} tokens, grad_accum {cfg.train_grad_accum}): one train step, loss "
              f"kernel {k_losses[0]:.6f} / torch {t_losses[0]:.6f}, {text}; step "
              f"{secs[0] * 1e3:.1f} ms host-paced (first); launches {json.dumps(c)}; "
              f"deterministic-mode notes {json.dumps(notes)}; phase "
              f"{time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        out[name] = {"grads": grads, "losses": [k_losses, t_losses], "step_ms": secs[0] * 1e3,
                     "params_rel_norm": state_rel[2], "params_max_leaf_rel_norm": state_rel[0],
                     "launches": c, "deterministic_notes": notes,
                     "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        del finals, k_final, t_final
        torch.cuda.empty_cache()
    return counts, out


def phase_trainer(dev):
    """smollm-135m at full width and depth through `trainer.train` (kernel
    backend, deterministic algorithms on): TRAINER["steps"] steps straight,
    checkpoints every TRAINER["ckpt_every"]; then the same run stopped after
    the first checkpoint (its state restored into a fresh init must equal
    the saved one bit for bit) and resumed into a fresh state to the end.
    The loss must fall (the mean of the last three steps under the first
    three's); the resumed run's losses and final state must equal
    the straight run's bit for bit, else within 1e-6 relative, with the ops
    the deterministic mode names."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.data import synthetic
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = registry.get(TRAINER["arch"])
    exe = Execution(backend="kernel", device=dev)
    root = ROOT / "build" / "chip_smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    tcfg = ts.TrainConfig(arch=cfg, opt=opt_mod.AdamWConfig(lr=TRAINER["lr"]))
    base = trainer.TrainerConfig(train=tcfg, total_steps=TRAINER["steps"],
                                 ckpt_every=TRAINER["ckpt_every"], keep_n=1, log_every=10 ** 6)
    data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAINER["seq"],
                                       global_batch=TRAINER["batch"], seed=0)
    run_kw = dict(execution=exe, data_cfg=data, log=lambda line: None)
    first = TRAINER["ckpt_every"]

    def runs():
        t0 = time.perf_counter()
        reset_counts()
        full = trainer.train(dataclasses.replace(base, ckpt_dir=str(root / "a")), **run_kw)
        counts = all_counts()
        t_full = time.perf_counter() - t0
        short = trainer.train(dataclasses.replace(base, ckpt_dir=str(root / "b"),
                                                  total_steps=first), **run_kw)
        fresh = ts.init_state(torch.Generator(device=dev).manual_seed(99), tcfg, execution=exe)
        step, restored = CheckpointManager(str(root / "b")).restore(fresh)
        restore_diff = trees_equal(restored, short["state"])
        resumed = trainer.train(dataclasses.replace(base, ckpt_dir=str(root / "b")), **run_kw)
        return full, short, step, restore_diff, resumed, counts, t_full

    try:
        (full, short, step, restore_diff, resumed, counts, t_full), notes = \
            deterministic_warnings(runs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if step != first or restore_diff:
        fail(f"trainer: checkpoint of step {step} restored with differing leaves "
             f"{restore_diff[:5]}")
    if resumed["start_step"] != first:
        fail(f"trainer: resumed from step {resumed['start_step']}, want {first}")
    losses = full["losses"]
    # tests/test_fault_tolerance.py::test_loss_decreases's reading: the last
    # three steps' mean under the first three's (each step reads a new batch)
    if not all(math.isfinite(x) for x in losses) or \
            not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"trainer: the loss did not fall: {losses}")
    joined = short["losses"] + resumed["losses"]
    diff = trees_equal(resumed["state"], full["state"])
    bitwise = not diff and joined == losses
    if not bitwise:
        rel = tree_worst_rel(resumed["state"], full["state"])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(joined, losses))
        if not (rel[0] <= 1e-6 and loss_rel <= 1e-6):
            fail(f"trainer: the resumed run differs from the straight run: params relative norm "
                 f"{rel[0]:.3e} at {rel[1]}, losses {loss_rel:.3e}; deterministic-mode notes "
                 f"{notes}")
    want = 2 * cfg.n_layers * TRAINER["steps"]
    if counts["flash_attention"] != want or counts["flash_attention_bwd"] != want:
        fail(f"trainer: flash launched {counts['flash_attention']} times and its backward "
             f"{counts['flash_attention_bwd']} in {TRAINER['steps']} steps, want {want} each")
    print(f"[trainer] {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{TRAINER['batch']} x {TRAINER['seq']} tokens, lr {TRAINER['lr']}): {len(losses)} steps "
          f"in {t_full:.1f} s with checkpoints every {TRAINER['ckpt_every']}; losses "
          f"{json.dumps([round(x, 5) for x in losses])}; the step-{first} checkpoint restored bit "
          f"for bit; stopped at {first} and resumed: "
          f"{'bit-identical losses and state' if bitwise else 'within 1e-6 (not bit-identical): ' + ', '.join(diff[:3])}; "
          f"deterministic-mode notes {json.dumps(notes)}; launches {json.dumps(counts)}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    return counts, {"losses": losses, "resumed_losses": joined, "bit_identical": bitwise,
                    "seconds": t_full, "deterministic_notes": notes}


def phase_train_time(dev):
    """One attention layer of the train-lm shape (2 x 4096, 32/8 heads, Dh
    120, bf16, causal, window 4096): B4's forward with lse, the plain
    backward (`flash_attention_bwd_ref`) on its output, and SDPA's forward +
    backward as a yardstick, each beside its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    cfg = registry.get(LM_ARCH)
    b, s, hq, hkv, dh = TRAIN_LM["batch"], TRAIN_LM["seq"], cfg.n_heads, cfg.n_kv_heads, cfg.dh
    gen = torch.Generator().manual_seed(98)
    q, k, v, dout = [torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
                     for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh),
                                   (b, s, hq, dh))]
    kw = dict(causal=True, window=cfg.sliding_window)
    fwd = lambda: flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    out, lse = fwd()
    bwd = lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, q_chunk=cfg.q_chunk,
                                          kv_chunk=cfg.kv_chunk, **kw)
    g = hq // hkv
    qs = q.transpose(1, 2).detach().requires_grad_(True)
    ks = k.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    vs = v.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    ds = dout.transpose(1, 2)

    def lib():
        qs.grad = ks.grad = vs.grad = None
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=True).backward(ds)

    fwd_ms, fwd_dev_ms = time_events(fwd, 20, 3), time_graph(fwd, 10, 3)
    bwd_ms = time_events(bwd, 3, 1)
    bwd_ops = device_ops(bwd)
    lib_ms = time_events(lib, 10, 3)
    pairs = b * hq * s * (s + 1) // 2
    el = 2                                                   # bf16 bytes
    f_flops, f_bytes = 4.0 * dh * pairs, el * (2 * q.numel() + k.numel() + v.numel()) + \
        4 * lse.numel()
    b_flops = 10.0 * dh * pairs                              # s, dp, dq, dk, dv
    b_bytes = el * (3 * q.numel() + 2 * (k.numel() + v.numel()) + q.numel()) + 4 * lse.numel()
    bound = {}
    for name, fl, by in (("forward", f_flops, f_bytes), ("backward", b_flops, b_bytes),
                         ("forward+backward", f_flops + b_flops, f_bytes + b_bytes)):
        t_ops, t_bytes = fl / PEAK_BF16_FLOPS, by / PEAK_BYTES
        bound[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    row = {"shape": [b, s, hq, hkv, dh], "forward_lse_ms": fwd_ms,
           "forward_lse_device_ms": fwd_dev_ms, "plain_backward_ms": bwd_ms,
           "plain_backward_device_busy_ms": None if bwd_ops is None else bwd_ops["busy_ms"],
           "sdpa_forward_backward_ms": lib_ms,
           "bound_ms": {k_: v_[0] for k_, v_ in bound.items()},
           "bound_by": {k_: v_[1] for k_, v_ in bound.items()}}
    print(f"[train-time] attention layer {row['shape']} bf16 causal (window "
          f"{cfg.sliding_window}): B4 forward + lse {fwd_ms:.4f} ms ({fwd_dev_ms:.4f} device-only; "
          f"bound {bound['forward'][0]:.6f} ms, {bound['forward'][1]}); plain backward "
          f"{bwd_ms:.2f} ms host-paced (device busy {fmt_ms(row['plain_backward_device_busy_ms'])} "
          f"ms; bound {bound['backward'][0]:.6f} ms, {bound['backward'][1]}); SDPA forward + "
          f"backward {lib_ms:.4f} ms (bound {bound['forward+backward'][0]:.6f} ms)")
    return row


MESH_DR_BATCHES = (13, 16)      # dr_transform at an odd and an even batch
MESH_ENSEMBLE = 4               # members of the paper model's ensemble
MESH_ENSEMBLE_ROWS = 100        # test rows served through register(..., ensemble=)
MESH_DP = dict(arch="smollm_135m", batch=8, seq=512, steps=2)
MESH_SYNC_REL = 1e-5            # a synced leaf, B3 vs the plain sketch, relative norm
MESH_RECURRENT_DECODE = 4       # decode steps after each recurrent family's meshed prefill
MESH_RECURRENT_STEPS = 2        # train steps of each (the first pays one-time costs)


def _ms(v) -> str:
    """A time in ms, or a list of them (one a step), to 3 decimals."""
    return ", ".join(f"{t:.3f}" for t in v) if isinstance(v, list) else f"{v:.3f}"


def mesh_recurrent(dev, mesh, arch, spec, seed, exe, path):
    """One recurrent family at its [train-recurrent] cut (`spec`: layers,
    batch, seq) on the one-rank mesh against the unmeshed run on the same
    card, every run under deterministic algorithms: a prefill of
    `spec`'s batch and MESH_RECURRENT_DECODE teacher-forced decode steps
    through `serve_step` (logits every step, every cache leaf at the end),
    then MESH_RECURRENT_STEPS train steps (the last one's loss and grad
    norm, every updated param leaf), each bit-identical to the unmeshed
    one; each train step timed host-paced.  `path` zeroes the counts just
    before each meshed run and reads them just after.  Params and states
    are drawn anew from `seed` for each run (the card's generator repeats
    its draws), so no two copies of a model are held."""
    import dataclasses

    import torch
    from repro_torch import tree as tree_mod
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.dist import sharding
    from repro_torch.models import api
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(registry.get(arch), n_layers=spec["layers"])
    name, b, s = cfg.family, spec["batch"], spec["seq"]
    toks = torch.randint(0, cfg.vocab_size, (b, s + MESH_RECURRENT_DECODE),
                         generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev,
                         dtype=torch.int32)
    batch, cache_size = {"tokens": toks[:, :s]}, s + MESH_RECURRENT_DECODE

    def serve(msh):
        params = api.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, execution=exe)
        if msh is not None:
            params = sharding.lay_out(params, sharding.param_specs(params, msh), msh)
        t0 = time.perf_counter()
        logits, cache = serve_step.make_prefill(cfg, msh, params, batch, cache_size,
                                                execution=exe)(params, batch)
        outs = [sharding.full(logits)]
        decode = serve_step.make_decode(cfg, msh, params, cache, execution=exe)
        for i in range(MESH_RECURRENT_DECODE):
            logits, cache = decode(params, toks[:, s + i], cache)
            outs.append(sharding.full(logits))
        torch.cuda.synchronize()
        return outs, {k: sharding.full(v) for k, v in cache.items()}, time.perf_counter() - t0

    tcfg = ts.TrainConfig(arch=cfg, grad_accum=cfg.train_grad_accum)
    data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                       seed=0)
    tb = to_device({"tokens": synthetic.token_batch(data, 0)["tokens"]}, dev)

    def train(msh):
        state = ts.init_state(torch.Generator(device=dev).manual_seed(seed), tcfg, execution=exe)
        if msh is not None:
            state = ts.lay_out_state(state, msh)
        step = ts.make_train_step(tcfg, execution=exe, mesh=msh)
        secs = []
        for _ in range(MESH_RECURRENT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, tb)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return ({k: float(v) for k, v in metrics.items()},
                {p: sharding.full(v) for p, v in tree_mod.flatten_with_path(state.params)}, secs)

    def det(fn):
        return lambda: deterministic_warnings(fn)

    (u_logits, u_cache, u_serve_s), _ = det(lambda: serve(None))()
    (m_logits, m_cache, m_serve_s), notes = path(f"{name}_serve", det(lambda: serve(mesh)))
    torch.cuda.empty_cache()
    (u_metrics, u_params, u_train_s), _ = det(lambda: train(None))()
    torch.cuda.empty_cache()
    (m_metrics, m_params, m_train_s), notes_t = path(f"{name}_train", det(lambda: train(mesh)))
    serve_same = (all(torch.equal(g, w) for g, w in zip(m_logits, u_logits))
                  and not trees_equal(m_cache, u_cache))
    params_diff = trees_equal(m_params, u_params)
    if not serve_same or params_diff or m_metrics != u_metrics:
        fail(f"mesh {name}: the one-rank meshed run differs from the unmeshed one: serving "
             f"bit-identical {serve_same}; train metrics {m_metrics} / {u_metrics}, param "
             f"leaves differing {params_diff[:5]}")
    apps = -(-cfg.n_layers // cfg.hybrid.attn_every) if name == "zamba" else 0
    return {"family": name, "layers": cfg.n_layers, "batch": b, "seq": s,
            "shared_applications": apps,
            "serve_ms": {"meshed": m_serve_s * 1e3, "unmeshed": u_serve_s * 1e3},
            "train_step_ms": {"meshed": [t * 1e3 for t in m_train_s],
                              "unmeshed": [t * 1e3 for t in u_train_s]},
            "loss": m_metrics["loss"], "grad_norm": m_metrics["grad_norm"],
            "deterministic_notes": sorted(set(notes) | set(notes_t))}


def phase_mesh(dev, card_line):
    """[mesh]: the mesh path on a one-rank NCCL mesh (`make_smoke_mesh(1)`),
    each path against the unmeshed one on the same card, counts zeroed just
    before each path and read just after: DR serving (`DRService(mesh=)` over
    [serve]'s ragged requests, `dr_serve.dr_transform` at an odd and an even
    batch, bit-identical to `DRService(mesh=None)`), the paper model's
    ensemble (every member bit-identical to its solo run, within TRAJ_TOL of
    the torch backend; `register(..., ensemble=)` on the mesh service),
    h2o-danube-3-4b request A through `DRService.lm_prefill` / `lm_decode`
    with the mesh (logits within [lm]'s bounds of the unmeshed run), one
    meshed [train-lm] step against one unmeshed step, and smollm-135m through
    `make_dp_compressed_step` (the first step's gradients synced again with
    B3 and with the plain sketch, every compressed leaf within
    MESH_SYNC_REL; the first loss equal to its state's plain loss; synced +
    new error feedback = gradient + old error feedback per leaf), and
    zamba2-7b and rwkv6-1.6b at [train-recurrent]'s cuts (`mesh_recurrent`:
    prefill + decode and two train steps, bit-identical to unmeshed, B4
    counted in zamba's prefill and train).  The MoE all-to-all and the layers'
    split over `model` need two `model` ranks: one card cannot reach them
    (tests/test_torch_dist.py, tests/test_torch_mesh_tp.py and
    tests/test_torch_mesh_recurrent.py hold them on gloo ranks; `[dryrun]`
    prices the split at (16, 16))."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.execution import Execution
    from repro_torch.data import synthetic
    from repro_torch import tree as tree_mod
    from repro_torch.dist import compress, sharding
    from repro_torch.dr import DRModel, EASIStage, RPStage
    from repro_torch.dr.model import member
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.serve import BucketPolicy, DRService, VirtualClock, dr_serve, serve_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts

    mesh = make_smoke_mesh(1)
    print(f"[mesh] {card_line}: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over a "
          f"{dist.get_backend()} group of {dist.get_world_size()} rank")
    kexe, texe = Execution(backend="kernel", device=dev), Execution(backend="torch", device=dev)
    counts, times, out = {}, {}, {}

    def path(name, fn):
        torch.cuda.synchronize()
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[name] = all_counts()
        return res

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    # ---- DR serving -------------------------------------------------------
    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    wk = DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)), execution=kexe,
                 block_size=blk)
    st = wk.init(torch.Generator().manual_seed(0))
    reqs = ragged_requests(SERVE_REQUESTS, m, dev, seed=0)
    windows = [reqs[i:i + SERVE_WINDOW] for i in range(0, len(reqs), SERVE_WINDOW)]
    gen = torch.Generator().manual_seed(5)
    xs = {b: torch.randn((b, m), generator=gen).to(dev) for b in MESH_DR_BATCHES}

    def stream(svc):
        answers = []
        for win in windows:
            tickets = [svc.submit("wide", x) for x in win]
            svc.flush()
            answers += [t.result() for t in tickets]
        return answers

    # the meshed service serves with the model's own tiles (no race); a
    # VirtualClock ties the unmeshed service's race, so it keeps them too
    plain = DRService(buckets=BucketPolicy(**SERVE_BUCKETS), clock=VirtualClock())
    plain.register("wide", wk, st)
    want = stream(plain)
    want_x = {b: plain.transform("wide", x) for b, x in xs.items()}
    meshed = DRService(mesh=mesh, buckets=BucketPolicy(**SERVE_BUCKETS))

    def dr_path():
        meshed.register("wide", wk, st)
        got = stream(meshed)
        got_x = {b: sharding.full(dr_serve.dr_transform(wk, st, x, mesh=mesh))
                 for b, x in xs.items()}
        return got, got_x

    got, got_x = path("dr_serve", dr_path)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
    if bad:
        fail(f"mesh: DRService(mesh=) differs from DRService(mesh=None) on requests {bad[:5]}")
    for b in MESH_DR_BATCHES:
        if not torch.equal(got_x[b], want_x[b]):
            fail(f"mesh: dr_transform at {b} rows differs from DRService(mesh=None): max |err| "
                 f"{max_err(got_x[b], want_x[b]):.3e}")
    if counts["dr_serve"]["fused_transform"] <= 0:
        fail(f"mesh: the DR serving path never launched fused_transform: {counts['dr_serve']}")
    x256 = torch.randn((256, m), generator=gen).to(dev)
    times["dr_bucket_256_ms"] = {"meshed": host_ms(lambda: meshed.transform("wide", x256)),
                                 "unmeshed": host_ms(lambda: plain.transform("wide", x256))}
    print(f"[mesh] DR serving: {SERVE_REQUESTS} ragged requests and dr_transform at "
          f"{list(MESH_DR_BATCHES)} rows bit-identical to DRService(mesh=None); "
          f"{meshed.cache.misses} meshed programs; launches {json.dumps(counts['dr_serve'])}")

    # ---- the paper model's ensemble ----------------------------------------
    def paper_model(exe):
        return DRModel(stages=(RPStage(PAPER["m"], PAPER["p"]),
                               EASIStage.rotation(PAPER["p"], PAPER["n"], mu=PAPER["mu"])),
                       execution=exe, block_size=PAPER["block"])

    pk, pt = paper_model(kexe), paper_model(texe)
    xtr, xte = paper_data(dev)
    est = pk.ensemble(MESH_ENSEMBLE).init(torch.Generator().manual_seed(0))

    def ens_path():
        fitted = pk.ensemble(MESH_ENSEMBLE).fit(est, xtr, epochs=PAPER["epochs"])
        return fitted, pk.ensemble(MESH_ENSEMBLE).transform(fitted, xte)

    fitted, y_ens = path("ensemble", ens_path)
    for i in range(MESH_ENSEMBLE):
        one = member(est, i)
        solo = pk.fit(one._replace(stages=tuple(t.clone() for t in one.stages)), xtr,
                      epochs=PAPER["epochs"])
        if not torch.equal(fitted.stages[1][i], solo.stages[1]) or \
                not torch.equal(y_ens[i], pk.transform(solo, xte)):
            fail(f"mesh: ensemble member {i} differs from its solo run")
    fitted_t = pt.ensemble(MESH_ENSEMBLE).fit(est, xtr, epochs=PAPER["epochs"])
    ens_err = check_close("mesh: ensemble B, kernel vs torch backend", fitted.stages[1],
                          fitted_t.stages[1], **TRAJ_TOL)
    for k in ("ternary_matmul", "easi_apply", "fused_transform"):
        if counts["ensemble"][k] <= 0:
            fail(f"mesh: the ensemble path never launched {k}: {counts['ensemble']}")

    def ens_serve():
        meshed.register("ens", pk, fitted, ensemble=MESH_ENSEMBLE)
        return meshed.transform("ens", xte[:MESH_ENSEMBLE_ROWS])

    y_served = path("ensemble_serve", ens_serve)
    served_err = check_close("mesh: served ensemble vs DREnsemble.transform", y_served,
                             y_ens[:, :MESH_ENSEMBLE_ROWS], **OUT_TOL)
    print(f"[mesh] ensemble of {MESH_ENSEMBLE} x {PAPER['m']}->{PAPER['p']}->{PAPER['n']}: fit "
          f"({PAPER['epochs']} epochs) + transform, every member bit-identical to its solo run; "
          f"B kernel vs torch backend max |err| {ens_err:.3e} (TRAJ_TOL); served through "
          f"register(ensemble=) max |err| {served_err:.3e} (bit-identical: "
          f"{bool(torch.equal(y_served, y_ens[:, :MESH_ENSEMBLE_ROWS]))}); launches "
          f"{json.dumps(counts['ensemble'])}, serving {json.dumps(counts['ensemble_serve'])}")
    del plain, meshed
    torch.cuda.empty_cache()

    # ---- LM serving at full width ----------------------------------------
    cfg = registry.get(LM_ARCH)
    spec = LM_REQUESTS["A"]
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg, execution=kexe)
    prompts = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev,
                            dtype=torch.int32)
    batch = {"tokens": prompts}
    laid = sharding.lay_out(params, sharding.param_specs(params, mesh), mesh)
    svc = DRService()

    def serve(msh, prm, forced=None):
        t = svc.lm_prefill(cfg, msh, prm, batch, spec["cache"], execution=kexe)
        svc.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = svc.lm_prefill(cfg, msh, prm, batch, spec["cache"], execution=kexe)
        svc.flush()
        logits, cache = wait_ticket("mesh lm prefill", t)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        outs, toks = [sharding.full(logits)], []
        t0 = time.perf_counter()
        for i in range(spec["decode"]):
            tok = (outs[-1].argmax(-1) if forced is None else forced[i]).to(torch.int32)
            toks.append(tok)
            t = svc.lm_decode(cfg, msh, prm, tok, cache, execution=kexe)
            svc.flush()
            logits, cache = wait_ticket("mesh lm decode", t)
            outs.append(sharding.full(logits))
        torch.cuda.synchronize()
        return outs, toks, t_pre * 1e3, (time.perf_counter() - t0) / spec["decode"] * 1e3

    ref_logits, ref_toks, pre_u, dec_u = serve(None, params)
    marks = {}

    def lm_path():
        marks["before"] = all_counts()["flash_attention"]
        return serve(mesh, laid, forced=ref_toks)

    got_logits, _, pre_m, dec_m = path("lm", lm_path)
    worst = (0.0, 0.0)
    for i, (g, w) in enumerate(zip(got_logits, ref_logits)):
        rel, mx = logits_diff(f"mesh lm step {i}", g, w, pair="meshed vs unmeshed")
        worst = (max(worst[0], rel), max(worst[1], mx))
    identical = all(torch.equal(g, w) for g, w in zip(got_logits, ref_logits))
    if counts["lm"]["flash_attention"] != 2 * cfg.n_layers:
        fail(f"mesh: flash launched {counts['lm']['flash_attention']} times for two prefills "
             f"and {spec['decode']} decode steps, want {cfg.n_layers} per prefill")
    times["lm_prefill_ms"] = {"meshed": pre_m, "unmeshed": pre_u}
    times["lm_decode_step_ms"] = {"meshed": dec_m, "unmeshed": dec_u}
    print(f"[mesh] {cfg.name} request A ({spec['batch']} x {spec['prompt']} + {spec['decode']} "
          f"decode) through DRService.lm_prefill / lm_decode on the mesh: largest relative row "
          f"norm {worst[0]:.3e}, |err| {worst[1]:.3e} against the unmeshed run (bounds "
          f"{LM_REL_NORM} / {LM_MAX_ABS}); bit-identical: {identical}; flash "
          f"{cfg.n_layers} launches per prefill")
    out["lm"] = {"max_rel_norm": worst[0], "max_abs_err": worst[1], "bit_identical": identical}
    del params, laid, svc, ref_logits, got_logits
    torch.cuda.empty_cache()

    # ---- one train step, meshed against unmeshed --------------------------
    tcfg = ts.TrainConfig(arch=dataclasses.replace(cfg, n_layers=TRAIN_LM["layers"]))
    data = synthetic.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_LM["seq"],
                                       global_batch=TRAIN_LM["batch"], seed=0)
    tbs = [to_device({"tokens": synthetic.token_batch(data, i)["tokens"]}, dev) for i in (0, 1)]

    def one_step(msh):
        """The first step's metrics and updated params' leaf norms; the
        second step's host-paced ms (the first pays the allocator); the
        peak GiB allocated over both steps, the state included."""
        state = ts.init_state(torch.Generator(device=dev).manual_seed(11), tcfg, execution=kexe)
        if msh is not None:
            state = ts.lay_out_state(state, msh)
        step = ts.make_train_step(tcfg, execution=kexe, mesh=msh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        state, metrics = step(state, tbs[0])
        norms = {k: float(torch.linalg.vector_norm(sharding.full(v).to(torch.float32)))
                 for k, v in tree_mod.flatten_with_path(state.params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, tbs[1])
        torch.cuda.synchronize()
        res = ({k: float(v) for k, v in metrics.items()}, norms,
               (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated(dev) / 2**30)
        del state, step
        torch.cuda.empty_cache()
        return res

    m_u, n_u, ms_u, peak_u = one_step(None)
    m_m, n_m, ms_m, peak = path("train", lambda: one_step(mesh))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss_rel, gn_rel = rel(m_m["loss"], m_u["loss"]), rel(m_m["grad_norm"], m_u["grad_norm"])
    leaf_rel = max(rel(n_m[k], n_u[k]) for k in n_u)
    if not (loss_rel <= 1e-6 and gn_rel <= 1e-6 and leaf_rel <= 1e-6):
        fail(f"mesh: meshed train step vs unmeshed: loss {loss_rel:.3e}, grad norm "
             f"{gn_rel:.3e}, params' leaf norms {leaf_rel:.3e} (relative; bound 1e-6)")
    if counts["train"]["flash_attention"] != 4 * tcfg.arch.n_layers or \
            counts["train"]["flash_attention_bwd"] != 4 * tcfg.arch.n_layers:
        fail(f"mesh: flash launched {counts['train']['flash_attention']} times and its backward "
             f"{counts['train']['flash_attention_bwd']} in two meshed steps, want "
             f"{4 * tcfg.arch.n_layers} each (forward and remat recompute, the backward's two "
             f"passes, per layer)")
    times["train_step_ms"] = {"meshed": ms_m, "unmeshed": ms_u}
    print(f"[mesh] train step ({tcfg.arch.name}, {tcfg.arch.n_layers} of 24 layers, "
          f"{TRAIN_LM['batch']} x {TRAIN_LM['seq']}): loss {m_m['loss']:.6f} meshed / "
          f"{m_u['loss']:.6f} unmeshed (relative {loss_rel:.3e}), grad norm relative "
          f"{gn_rel:.3e}, updated params' leaf norms relative {leaf_rel:.3e}; second step "
          f"{ms_m:.1f} ms meshed / {ms_u:.1f} ms unmeshed host-paced; peak {peak:.3f} GiB "
          f"meshed / {peak_u:.3f} GiB unmeshed (the meshed step computes on its shards: on one "
          f"rank every gather is a view); bit-identical: {bool(loss_rel == gn_rel == leaf_rel == 0)}")
    out["train"] = {"loss_rel": loss_rel, "grad_norm_rel": gn_rel, "leaf_norm_rel": leaf_rel,
                    "peak_gib": peak, "peak_gib_unmeshed": peak_u}

    # ---- the recurrent families at [train-recurrent]'s cuts -----------------
    torch.cuda.empty_cache()
    for arch, spec, seed in ((ZAMBA_ARCH, TRAIN_ZAMBA, 14), (RWKV_ARCH, TRAIN_RWKV, 13)):
        rec = mesh_recurrent(dev, mesh, arch, spec, seed, kexe, path)
        fam = rec["family"]
        flash = {k: counts[f"{fam}_{k}"]["flash_attention"] for k in ("serve", "train")}
        bwd = {k: counts[f"{fam}_{k}"]["flash_attention_bwd"] for k in ("serve", "train")}
        # one launch a shared-block application in prefill; in each train
        # step forward + recompute for each of the 2 micro-batches, and the
        # backward's two passes for each
        apps = rec["shared_applications"]
        want = {"serve": apps, "train": MESH_RECURRENT_STEPS * 2 * 2 * apps}
        flash_names = ("flash_attention", "flash_attention_bwd")
        if flash != want or bwd != {"serve": 0, "train": want["train"]} or any(
                v for k in ("serve", "train")
                for n_, v in counts[f"{fam}_{k}"].items() if n_ not in flash_names):
            fail(f"mesh {fam}: launches {counts[f'{fam}_serve']} / {counts[f'{fam}_train']}, want "
                 f"flash {want}, its backward as many in training, and no other kernel")
        times[f"{fam}_serve_ms"] = rec.pop("serve_ms")
        times[f"{fam}_train_step_ms"] = rec.pop("train_step_ms")
        out[fam] = rec
        print(f"[mesh] {arch} ({rec['layers']} layers, {rec['batch']} x {rec['seq']}): prefill + "
              f"{MESH_RECURRENT_DECODE} decode steps and {MESH_RECURRENT_STEPS} train steps (loss "
              f"{rec['loss']:.6f}, "
              f"grad norm {rec['grad_norm']:.6f}) on the mesh bit-identical to unmeshed under "
              f"deterministic algorithms; launches serving {json.dumps(counts[f'{fam}_serve'])}, "
              f"train {json.dumps(counts[f'{fam}_train'])}; notes "
              f"{json.dumps(rec['deterministic_notes'])}")
        torch.cuda.empty_cache()

    # ---- the RP-compressed data-parallel step -------------------------------
    dcfg = registry.get(MESH_DP["arch"])
    ccfg = compress.CompressConfig()
    dtcfg = ts.TrainConfig(arch=dcfg, grad_compress=ccfg)
    state = ts.init_state(torch.Generator(device=dev).manual_seed(3), dtcfg, execution=kexe)
    ddata = synthetic.TokenStreamConfig(vocab_size=dcfg.vocab_size, seq_len=MESH_DP["seq"],
                                        global_batch=MESH_DP["batch"], seed=0)
    dbatches = [to_device({"tokens": synthetic.token_batch(ddata, i)["tokens"]}, dev)
                for i in range(MESH_DP["steps"])]
    ident, first = [], {}

    def inspect(grads, ef, synced, new_ef):
        if not first:
            first.update(grads=grads, ef=ef, synced=synced)
        for g, e1, s_, e2 in zip(*(tree_mod.leaves(t) for t in
                                   (grads, ef, synced, new_ef))):
            ident.append(float((s_ + e2 - g - e1).abs().max() / (g + e1).abs().max()))

    step = ts.make_dp_compressed_step(dtcfg, mesh, execution=kexe, inspect=inspect)

    def dp_path():
        st_, ef, losses = state, compress.residual_init(state.params), []
        for b in dbatches:
            torch.cuda.synchronize()
            st_, ef, metrics = step(st_, b, ef)
            losses.append(float(metrics["loss"]))
        return losses

    dp_losses = path("dp_compressed", dp_path)
    n_comp = sum(1 for t in tree_mod.leaves(state.params) if t.numel() >= ccfg.min_size)
    if not all(math.isfinite(v) for v in dp_losses):
        fail(f"mesh: compressed DP step losses are not finite: {dp_losses}")
    with torch.no_grad():
        plain_loss = float(ts.make_loss(dtcfg, None, execution=kexe)(
            state.params, None, dbatches[0])[0])
    first_loss_rel = abs(dp_losses[0] - plain_loss) / abs(plain_loss)
    if first_loss_rel > 1e-6:
        fail(f"mesh: the compressed step's first loss {dp_losses[0]} differs from the loss of "
             f"its initial state {plain_loss} by {first_loss_rel:.3e} relative (bound 1e-6)")
    # B3 at the gradient chunks' shapes against its plain version: the first
    # step's gradients and carries synced again on each backend
    with torch.no_grad():
        again = {b: compress.compress_sync(first["grads"], first["ef"], ccfg,
                                           sharding.batch_axes(mesh), mesh=mesh, backend=b)[0]
                 for b in ("kernel", "torch")}
    norm = lambda t: float(torch.linalg.vector_norm(t.to(torch.float32)))
    sync_rel, rerun_rel, rerun_same = 0.0, 0.0, True
    for g, s_in, s_k, s_t in zip(*(tree_mod.leaves(t) for t in
                                   (first["grads"], first["synced"], again["kernel"],
                                    again["torch"]))):
        if g.numel() < ccfg.min_size:
            continue
        sync_rel = max(sync_rel, norm(s_k - s_t) / norm(s_t))
        rerun_rel = max(rerun_rel, norm(s_in - s_k) / norm(s_k))
        rerun_same = rerun_same and torch.equal(s_in, s_k)
    if sync_rel > MESH_SYNC_REL:
        fail(f"mesh: compressed sync on B3 vs the plain sketch: a synced leaf differs by "
             f"{sync_rel:.3e} in relative norm (bound {MESH_SYNC_REL})")
    if rerun_rel > MESH_SYNC_REL:
        fail(f"mesh: the step's synced gradients differ from the same sync run again by "
             f"{rerun_rel:.3e} in relative norm (bound {MESH_SYNC_REL})")
    del first, again
    if max(ident) > 1e-6:
        fail(f"mesh: compressed sync: synced + new carry != gradient + old carry, largest "
             f"relative {max(ident):.3e} (bound 1e-6)")
    if counts["dp_compressed"]["ternary_matmul"] != n_comp * MESH_DP["steps"]:
        fail(f"mesh: ternary_matmul launched {counts['dp_compressed']['ternary_matmul']} "
             f"times, want {n_comp} compressed leaves x {MESH_DP['steps']} steps")
    print(f"[mesh] {dcfg.name} ({MESH_DP['batch']} x {MESH_DP['seq']}) through "
          f"make_dp_compressed_step, {MESH_DP['steps']} steps: losses {json.dumps(dp_losses)}; "
          f"first loss vs its state's plain loss {first_loss_rel:.3e} relative; synced leaves, "
          f"B3 vs plain sketch, {sync_rel:.3e} in relative norm (bound {MESH_SYNC_REL}); the "
          f"step's sync run again bit-identical: {rerun_same}; synced + new carry = gradient + "
          f"old carry to {max(ident):.3e} relative; {n_comp} compressed leaves, B3 launches "
          f"{counts['dp_compressed']['ternary_matmul']}")
    out["dp_compressed"] = {"losses": dp_losses, "first_loss_rel": first_loss_rel,
                            "sync_kernel_vs_plain_rel": sync_rel, "rerun_bit_identical": rerun_same,
                            "identity_rel": max(ident), "compressed_leaves": n_comp}
    print("[mesh] MoE expert parallelism (the all-to-all path) needs more than one `model` "
          "rank: one card cannot reach it; tests/test_torch_dist.py holds it on 8 gloo ranks")
    print(f"[mesh-time] {card_line}: host-paced ms meshed / unmeshed "
          + "; ".join(f"{k} {_ms(v['meshed'])} / {_ms(v['unmeshed'])}" for k, v in times.items()))
    total = {k: sum(c[k] for c in counts.values()) for k in all_counts()}
    out.update(times=times, launches_by_path=counts)
    dist.destroy_process_group()
    return total, out


# ---------------------------------------------------------------------------
# phase: the dry run against the step it predicts
# ---------------------------------------------------------------------------

DRYRUN_TOL = 0.10    # predicted peak within 10% of the measured one


def dryrun_cut(dev, card_line, arch, spec):
    """The dry run's prediction of one train step of `arch` cut to
    `spec`'s layers at its batch x seq (the reference's train_4k cell) on a
    one-rank mesh, built on fake CUDA tensors over a fake one-rank group,
    against the same step run for real on a one-rank NCCL mesh: the
    predicted peak within DRYRUN_TOL of max_memory_allocated over the step
    (reset just before, read just after, less what earlier phases left
    allocated), and the counted FLOPs at least the model FLOPs
    6·N·tokens."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    layers, batch, seq = spec["layers"], spec["batch"], spec["seq"]
    cfg = dryrun.apply_cut(registry.get(arch), layers=layers)
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        pred = dryrun.build_and_count(cfg, "train_4k", dryrun.make_mesh("one", dev), batch=batch,
                                      seq=seq, device=dev)
    t_pred = time.perf_counter() - t0
    count = pred["count"]
    if not count.flops >= pred["model_flops"]:
        fail(f"dryrun {arch}: counted {count.flops:.4e} FLOPs, under the model's 6·N·tokens "
             f"{pred['model_flops']:.4e}")

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    mesh = make_smoke_mesh(1, device=dev)
    try:
        cell = dryrun.build_cell(cfg, "train_4k", mesh, batch=batch, seq=seq, device=dev,
                                 fake=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = cell.run()
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated(dev) - base
        loss = float(out[1]["loss"])
        del out, cell
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(count.peak_bytes - measured) / measured
    print(f"[dryrun] ({card_line}) {cfg.name} {layers} layers, {batch} x {seq}, one-rank mesh: "
          f"predicted peak {count.peak_bytes / 2**30:.3f} GiB (fake CUDA tensors, built in "
          f"{t_pred:.1f} s), measured {measured / 2**30:.3f} GiB (max_memory_allocated over "
          f"one step of {t_step:.3f} s, loss {loss:.4f}): {100 * rel:.2f}% apart; counted "
          f"{count.flops:.4e} FLOPs against 6·N·tokens {pred['model_flops']:.4e} "
          f"(ratio {count.flops / pred['model_flops']:.3f}); kernels {json.dumps(count.kernels)}")
    if not rel <= DRYRUN_TOL:
        fail(f"dryrun {arch}: predicted peak {count.peak_bytes} B is {100 * rel:.2f}% from the "
             f"measured {measured} B (bound {100 * DRYRUN_TOL:.0f}%)")
    return {"predicted_peak_bytes": count.peak_bytes, "measured_peak_bytes": measured,
            "peak_rel_diff": rel, "flops": count.flops, "model_flops": pred["model_flops"],
            "bytes": count.bytes, "build_s": t_pred, "step_s": t_step, "loss": loss}


def phase_dryrun(dev, card_line):
    """`launch/dryrun.py` on the card's machine: `dryrun_cut` for h2o at
    [train-lm]'s cut (8 layers, 2 x 4096) and for zamba2 at
    [train-recurrent]'s (12 layers, 2 x 512).  Then the production mesh's
    records for h2o train_4k and decode_32k with their collective wire
    bytes by kind and axis (no card memory)."""
    from repro_torch.launch import dryrun, report

    res = {"h2o": dryrun_cut(dev, card_line, LM_ARCH, TRAIN_LM),
           "zamba": dryrun_cut(dev, card_line, ZAMBA_ARCH, TRAIN_ZAMBA)}
    production = {}
    for shape in ("train_4k", "decode_32k"):
        t0 = time.perf_counter()
        prod = dryrun.run_cell(LM_ARCH, shape, "single", verbose=False)
        t_prod = time.perf_counter() - t0
        shown = {k: v for k, v in prod.items() if k != "collective_calls"}
        shown["wire_bytes_by_axis"] = report.wire_by_axis(prod, by_kind=True)
        production[shape] = shown
        print(f"[dryrun] ({card_line}) production mesh, {LM_ARCH} {shape} (dry run, priced with "
              f"H100 data-sheet figures; built in {t_prod:.1f} s): per-rank peak "
              f"{prod['peak_bytes_per_device'] / 1e9:.2f} GB over a stored state of "
              f"{prod['state_bytes_per_device'] / 1e9:.2f} GB (the layers split over `model`: "
              f"the stream by sequence, the products and heads tensor-parallel); "
              f"{json.dumps(shown)}")
    return {**res, "production_train_4k": production["train_4k"],
            "production_decode_32k": production["decode_32k"]}


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--fleet-tcp-child"]:
        sys.path.insert(0, str(SRC))
        return fleet_tcp_child(args[1], args[2:])
    only = None
    if args[:1] == ["--only"] and len(args) == 2:
        only = args[1].split(",")
    elif args:
        print("usage: chip_smoke.py [--only kernels,resources,wide,serve,autotune,fleet,"
              "fleet-tcp,flash,zamba-published,mesh,dryrun]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 tolerances do not survive TF32
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    errs = {}
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {seconds[name]:.1f} s")
        return out

    if only is not None:
        standalone = {"kernels": lambda card: phase_kernels(dev, {}),
                      "resources": phase_resources,
                      "wide": lambda card: phase_wide(dev, {}, card),
                      "fleet": lambda card: phase_fleet(dev, card),
                      "fleet-tcp": phase_fleet_tcp,
                      "serve": lambda card: phase_serve(dev, card),
                      "autotune": lambda card: phase_autotune(dev, card),
                      "flash": lambda card: phase_flash(dev, {}),
                      "zamba-published": lambda card: phase_zamba_published(dev)[1],
                      "mesh": lambda card: phase_mesh(dev, card)[1],
                      "dryrun": lambda card: phase_dryrun(dev, card)}
        try:
            card_line = timed("card", phase_card)
            for name in only:
                if name not in standalone:
                    fail(f"--only takes {sorted(standalone)}, not {name!r}")
                out = timed(name, standalone[name], card_line)
                print(f"[{name}-steps] {json.dumps(out)}")
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        print(f"[only] {only} passed; the full run prints the contract's lines")
        return 0
    try:
        card_line = timed("card", phase_card)
        timed("kernels", phase_kernels, dev, errs)
        resources = timed("resources", phase_resources, card_line)
        counts, paper_times = timed("paper", phase_paper, dev)
        t1_counts, table1 = timed("table1", phase_table1, dev)
        rows = timed("wide", phase_wide, dev, errs, card_line)
        serve = timed("serve", phase_serve, dev, card_line)
        tuned = timed("autotune", phase_autotune, dev, card_line)
        fleet = timed("fleet", phase_fleet, dev, card_line)
        fleet_tcp = timed("fleet-tcp", phase_fleet_tcp, card_line)
        timed("flash", phase_flash, dev, errs)
        lm_launches, lm_by_entry, lm_steps, lm_worst, lm = timed("lm", phase_lm, dev)
        lmq_counts, lmq = timed("lm-queue", phase_lm_queue, dev, lm)
        kvrp_counts, kvrp = timed("kv-rp", phase_kv_rp, dev, lm)
        lm.clear()
        torch.cuda.empty_cache()
        flash_row = timed("flash-time", flash_timing, dev, errs)
        flash_row["geometries"] = timed("flash-geometries", flash_geometry_timing, dev)
        moe_counts, moe = timed("moe", phase_moe, dev)
        torch.cuda.empty_cache()
        front_counts, front = timed("frontend", phase_frontend, dev)
        torch.cuda.empty_cache()
        rwkv_counts, rwkv = timed("rwkv6", phase_rwkv6, dev)
        torch.cuda.empty_cache()
        zamba_counts, zamba = timed("zamba", phase_zamba, dev)
        torch.cuda.empty_cache()
        zpub_counts, zpub = timed("zamba-published", phase_zamba_published, dev)
        torch.cuda.empty_cache()
        train_lm_counts, train_lm = timed("train-lm", phase_train_lm, dev)
        torch.cuda.empty_cache()
        train_dr_counts, train_dr = timed("train-dr", phase_train_dr, dev)
        torch.cuda.empty_cache()
        train_rec_counts, train_rec = timed("train-recurrent", phase_train_recurrent, dev)
        torch.cuda.empty_cache()
        trainer_counts, trainer_out = timed("trainer", phase_trainer, dev)
        torch.cuda.empty_cache()
        train_layer = timed("train-time", phase_train_time, dev)
        torch.cuda.empty_cache()
        mesh_counts, mesh_out = timed("mesh", phase_mesh, dev, card_line)
        torch.cuda.empty_cache()
        dryrun = timed("dryrun", phase_dryrun, dev, card_line)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_table1"] = t1_counts[row["name"]]
        row["paper"] = paper_times[row["name"]]
        if row["name"] == "ternary_matmul":
            row["fleet_sketch"] = fleet["sketch"]   # the merge's sketch, a new call site
    flash_row.update(lse_max_abs_err_f32=errs[("lse", "f32")],
                     lse_max_abs_err_bf16=errs[("lse", "bf16")], grad_check=errs["flash_grads"],
                     train_layer=train_layer, backward=errs["flash_bwd_timing"],
                     d224=errs["flash_d224"])
    flash_row.update(launches=lm_launches, launches_table1=t1_counts["flash_attention"],
                     launches_by_request=lm_by_entry,
                     lm_max_rel_norm=lm_worst[0], lm_max_abs_err=lm_worst[1])
    rows.append(flash_row)
    for row in rows:           # the serving path counts only warm-up calls and captures
        name = row["name"]
        row["launches_serve"] = serve["launches"][name]
        row["launches_serve_warmup"] = serve["launches_by_program"]["warmup"][name]
        row["launches_serve_captured"] = serve["launches_by_program"]["captured"][name]
        row["runs_serve_replayed"] = serve["launches_by_program"]["replayed"][name]
        row["launches_fleet"] = fleet["launches"][name]
        row["launches_fleet_tcp"] = fleet_tcp["launches"][name]
        row["launches_lm_queue"] = lmq_counts[name]
        row["launches_kv_rp"] = kvrp_counts[name]
        row["launches_moe"] = moe_counts[name]
        row["launches_frontend"] = front_counts[name]
        row["launches_rwkv6"] = rwkv_counts[name]
        row["launches_zamba"] = zamba_counts[name]
        row["launches_zamba_published"] = zpub_counts[name]
        row["launches_train_lm"] = train_lm_counts[name]
        row["launches_train_dr"] = train_dr_counts[name]
        row["launches_train_recurrent"] = train_rec_counts[name]
        row["launches_trainer"] = trainer_counts[name]
        row["launches_mesh"] = mesh_counts[name]
    print(f"[paper-steps] {json.dumps({k: paper_times[k] for k in ('update', 'transform', 'transform_1000')})}")
    print(f"[table1-steps] {json.dumps(table1)}")
    print(f"[lm-steps] {json.dumps(lm_steps)}")
    print(f"[serve-steps] {json.dumps(serve)}")
    print(f"[fleet-steps] {json.dumps({'fleet': fleet, 'fleet_tcp': fleet_tcp})}")
    zoo = {"lm_queue": lmq, "kv_rp": kvrp, "moe": moe, "frontend": front, "rwkv6": rwkv,
           "zamba": zamba, "zamba_published": zpub}
    print(f"[lm-zoo-steps] {json.dumps(zoo)}")
    train = {"train_lm": train_lm, "train_dr": train_dr, "train_recurrent": train_rec,
             "trainer": trainer_out, "train_layer": train_layer}
    print(f"[train-steps] {json.dumps(train)}")
    print(f"[mesh-steps] {json.dumps(mesh_out)}")
    print(f"[resources-steps] {json.dumps(resources)}")
    print(f"[autotune-steps] {json.dumps(tuned)}")
    print(f"[dryrun-steps] {json.dumps(dryrun)}")
    print(f"[phase-seconds] {json.dumps(seconds)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
