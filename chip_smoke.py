#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the GS-TG renderer, and of its LM
serving and training paths, on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (sm_90a). It
imports nothing of JAX or of the JAX package ``repro``. Phases, one JSON
line each:

  1. device   — the card (nvidia-smi name and power limit), the kernels'
                build times (one nvcc per source, started together), and
                the block shape, registers, shared memory and spills of
                both raster kernels, the BGM and the GSM (a GSM instance
                that spills fails the run).
  2. kernel   — each CUDA kernel against its plain PyTorch version on the
                main path's inputs (bitmask: 3 methods, bit-exact; raster:
                max-abs <= 1e-4, counters within 1e-5 relative), with
                CUDA-event times (median of 10 after a warm-up); then
                fused_vs_tile: the fused raster kernel against the tile
                kernel over the compacted lists of the same table and
                masks, bit for bit (rgb and counters with early exit, all
                four rows without), and out-of-image member tiles rgb 0,
                T 1, counts 0. The tile kernel's bound counts the entries
                its early exit walks (the plain version's stops); it is also
                timed with early exit off (every live entry walked).
     bgm_edge_cases — the BGM kernel against its plain version on the
                package's edge_case_block, gf 1-5 x tile 8 and 16 x 3
                methods, bit for bit.
     tile_edge_cases — the tile kernel against its plain version (run on
                the host) on the package's edge_case_lists, tile 4-64 (4,
                6, 12 and 48 leave pixel slots idle) x chunk 32, the window
                and 2048 x early exit on and off: rgb within 1e-5, T within
                1e-4 relative, NaN in the same places, counters equal.
     wide_chunk — chunk 2048 on a small frame whose group lists pass 1,024
                entries: the fused kernel, the tile kernel over the
                compacted lists and over the group lists as 64-px tiles
                against their plain versions (rgb and counters as above, T
                within 1e-4 relative), and fused_vs_tile.
     gsm      — the GSM entry point ops.sort_groups_bitonic on the main
                frame's group lists (527 x 8192, rows permuted): keys and
                payload bitwise equal to the plain network, keys bitwise
                equal to torch.sort, live keys in the bin table's depth
                order; then K = 16384 and 65536 (global-memory passes)
                against the plain network. Kernel, plain and torch.sort +
                gather times; kernel times at K = 16384 and 65536 on the
                table cut into as many whole rows that long as it holds.
     gsm_edge_cases — the bitonic kernel against its plain version (run on
                the host) on the package's edge_case_rows, K = 1 .. 65536
                (every layout boundary of the kernel), bit for bit.
  3. render   — the main path: engine.open(scene, cfg).render(cam) in gstg
                mode on the cuda backend, 1,026,000 gaussians at 1952x1088.
                Launch counts are zeroed just before each path (gsm, render,
                batch, tile_baseline) and read just after.
     stages   — each of its six stages timed on its own (CUDA events).
     batch    — the handle's batch and futures paths on four cameras near
                the main one: render_batch lanes and four submits (one
                dispatch at max_batch=4) bitwise equal to render(cam_i);
                the submits' own request spans (queue, batch wait, device
                and host copy, resolve) beside the first submit call (it
                starts the worker) and the host copy of the stacked lanes
                alone.
  4. parity   — the same camera on the reference backend on the card:
                frontend counters equal, image within 1e-4.
  5. lossless — gstg against tile_baseline on the cuda backend (120,000
                gaussians, 1952x1088, camera twice as far so that no list
                is cut): bitwise-equal images; both frames' times (CUDA
                events, median of 10 after a warm-up) and their ratio.
     cost_model — the analytic cost model (core/cost_model.py) on both
                frames' counters: every stage finite and non-negative (the
                baseline has no bitmask stage), totals and energies
                positive, gstg's total below tile_baseline's. Its outputs
                are the model's estimates for the paper's ASIC, not times
                of this card.
     sharded  — the scene cut into D logical shards of the gaussian axis on
                the card: engine.open(scene, cfg, scene_shards=D).render(cam)
                at D = 2 and 7 (7 leaves 4 padding rows), image and every
                counter bitwise equal to the main path's D = 1 render; at
                D = 2 under the index, psum and flat feature gathers; at
                D = 7 also a shard_scene_host layout moved to the card;
                render_batch of the batch phase's four cameras at D = 2
                against its D = 1 lanes; the lossless frame at D = 2, gstg
                bitwise equal to tile_baseline at D = 2 and to gstg at
                D = 1. Launch counts zeroed just before the D = 2 and D = 7
                frames (the BGM and the fused RM once each) and the D = 2
                tile_baseline frame (the tile RM once), read just after;
                frame ms at D = 1, 2 and 7 (host clock to synchronize,
                median of 10) and each D's peak memory.
     timed    — RenderConfig(timing=True), fenced per-stage spans: the main
                frame through engine.open(scene, cfg_timed).render(cam), one
                warm render then 10, image and every counter bitwise equal to
                the render phase's frame, the BGM and the fused RM once per
                frame, the stage/{project,identify,bin,bitmask,compact,
                rasterize,render} spans validated; each stage span's median
                ms, their sum, the umbrella's median and the glue (umbrella
                minus its stages), beside the untimed frame's median (host
                clock to synchronize, 10 frames). 10 timed frames at D = 2
                (bitwise the sharded phase's, one stage/merge, two spans of
                each frontend stage a frame), a timed render_batch of the
                batch phase's cameras (bitwise its lanes), and a timed
                lossless tile_baseline frame (bitwise, the tile RM once). The
                device's busy share of an untimed main frame: the union of
                its kernel intervals over the frame's host-clock span, from a
                torch.profiler trace of three frames (the median one). Then
                the one-shot CLI in a subprocess
                (python -m repro_torch.launch.render --backend cuda at
                1952x1088, capacity 8192, --stats --trace-json): exit 0, its
                counter lines equal an in-process engine.open render at its
                config, its trace valid with at least 7 stage span names.
     serve    — the serving tier at the paper's scene sizes (train
                1,026,000, truck 2,541,000, playroom 2,343,000 gaussians),
                every frame 1952x1088 on the cuda backend. Stateless: a
                RenderServer over train and truck, max_batch 4, 16 requests
                from poisson_arrivals at 8 req/s in real time, then the same
                load closed-loop; four train requests in tile_baseline (two
                configs, one scene copy). Every request completes bitwise
                equal to Renderer.render of its camera; padded lanes and
                (closed-loop) dispatches equal the scheduler's arithmetic;
                the BGM and fused RM launch once per gstg lane, padded lanes
                included, the tile RM once per tile_baseline lane. Residency:
                three scenes under a budget that holds the two largest, 9
                round-robin requests bitwise equal to an unbudgeted server's,
                evictions > 0, page-in/out spans equal their counters; each
                page-in's ms and GB/s and memory_allocated. Streams: one
                stream over train, 24 frames of a 16-pose orbit then an
                8-frame float32-exact dolly (the speculation worker idle
                before each frame): every frame bitwise equal to render, 8+
                exact hits on the second lap, a speculative hit on the dolly,
                spec/verify spans equal to the frames, the BGM once a frame,
                the frontend cache counted in the residency entry's cost;
                hit (backend only) against miss frame ms on a stream
                without speculation (8 orbit poses, twice). Then the serve CLI
                in two subprocesses (stateless under a budget, one stream;
                --parity-check): exit 0, traces that pass the cross-checks.
     autotune — tile-parameter autotune (repro_torch.autotune) on the main
                frame, its cache in a temporary file: the main triple (16,
                64, 2048) probed with frontend_stats at spans 6, 8, 12, 16
                (each probe's cut lists and max_memory_allocated), the
                smallest uncut span tuned (else the lossless frame), base
                group_capacity 16,384; a sweep over tiles (8, 16, 32) x
                factors (2, 4, 8) x capacities (2048, 4096), every feasible
                point measured (median of 3 after a warm-up, no cache
                written), its trajectory and the cost model's ranking
                beside the card's; gstg past 32 member tiles refused with
                its reason and no stats pass; autotune(top_k=3,
                verify=True), whose winner is its fastest survivor; then
                engine.open(tile_params='auto') bitwise (image and
                counters) an open of the winner fixed, a second 'auto' open
                that hits the cache with no stats pass, after close no
                entry in memory, the file kept, and a re-open from the
                file; RenderServer(autotune=True) serving two requests
                bitwise like render at the tuned triple; the one-shot CLI
                with --autotune in a subprocess (3,000 gaussians,
                256x192). The BGM and the fused RM launch once a measured
                frame, the BGM also once a stats pass. Prints the winner's
                frame time beside the main triple's, the search's wall
                time cold and on a cache hit, and the phase's peak memory.
     gateway  — the gateway tier (repro_torch.gateway) over train
                (1,026,000) and truck (2,541,000) at 1952x1088, the serve
                phase's config. In process: two InprocWorkers, train
                pre-committed on w0 and truck on w1, each warmed once per
                scene; 16 requests at once through RenderGateway.run, every
                dispatch held until all 16 are routed (so routing cannot
                race a finished dispatch) and w0 killed as its first
                dispatch returns (so it still holds queued requests): every
                request completes, a failover and retries served by w1,
                every image bitwise a direct handle's render_batch lane
                padded to 4, validate_gateway_trace clean, the BGM and the
                fused RM once per rendered lane; p50/p99, req/s, dispatches
                and completions per worker, the gateway's dispatch seconds
                beside the servers' render_s. Then the gateway CLI in a
                subprocess (--backend cuda, two subprocess workers,
                1,026,000 gaussians a scene, --kill-worker auto
                --kill-after 2 --parity-check): exit 0, failovers >= 1,
                8/8 bitwise, a valid trace; each child's start-up seconds,
                the round trips against the children's own latency, the
                largest reply line. Then a checkpoint of the train scene
                and an AdamW state saved synchronously from the card and
                restored onto it: every leaf bitwise, and the restored
                scene renders bitwise; file MB, write and read seconds,
                whether zstandard was present.
     mesh     — rendering over several devices, one process driving a
                (data, model) mesh (launch/mesh.py). (a) Virtual devices:
                the card listed four times as (4, 1), (2, 2) and (1, 4);
                render_batch of the batch phase's four cameras at the main
                frame bitwise (image and counters) the one-device handle's,
                a model axis committing 'psum' with physical_shards equal
                to it and the JAX formula's feature_mb_per_device, the BGM
                and the fused RM once a lane; an 'auto' open over the four
                under a budget of 1.2 x half the full model escalating to a
                physical psum commit; a RenderServer over (2, 1) and a
                stream frame on (2, 2) bitwise their renders; the lossless
                frame in tile_baseline over (2, 2) bitwise one device's
                (the tile RM once). Batch ms beside the one-device batch:
                virtual devices share the card, so these are not multi-card
                numbers. (b) A mixed (1, 2) mesh over [card, host] on the
                lossless frame: shard 1's frontend on the host, the psum
                copying its contribution to the card; no device mismatch,
                'psum' bitwise 'index', the image bitwise the card's
                backend over the same features moved to the card, and
                within 1e-4 of the one-card D = 2 render unless the host
                projected shard 1 other than the card (ulps: an alpha
                can cross 1/255), both frames' counters and the
                differing projection elements printed. (c) With two or more
                cards, (a) over distinct cards, not gated; with one, a line
                saying so.
  6. train   — scene training (core/train.py) on the main path's scene,
                camera and config, backend reference, outside inference
                mode: the main path's image is the target, the scene is
                perturbed (means + 0.08 N(0,1), opacity - 1, sh + 0.1
                N(0,1)), then 4 AdamW steps. Checks: finite losses, the
                last below the first; at step 0 every gradient field finite
                and not all zero, and the forward image bitwise equal to an
                inference-mode render. Prints each step's loss and PSNR,
                step_ms (median of steps 2-4, host clock to synchronize),
                peak_mem_gb (GiB), the phase's seconds, and one more loss
                and backward under torch.profiler (device time and the top
                kernels).
     train_grad_vs_host — scene_loss and its five gradients on a small
                frame (20,000 gaussians, 256x192, overflow 0), on the card
                and on the host with the same code: loss rtol 1e-4, each
                gradient max-abs within 1e-4 of its largest magnitude (the
                CPU tests' bounds against the JAX package).
  7. lm      — the LM serving path (models/*, launch/serve.py), eager,
                weights from a seeded generator on the card. (a)
                granite-3-2b at full width and depth (40 layers, d_model
                2,048, 2,635,237,376 parameters) in bf16, served through the
                serve loop at batch 8, prompt 64, gen 64 after a short
                warm-up: the median prefill and decode step (CUDA events
                between steps), tok/s, peak memory, the step's bound (the
                weights and the cache over the memory rate), one more
                decode step under torch.profiler (kernels, device ms, busy
                share); gates: finite logits, every token inside the vocab.
                (b) The same model in float32 (TF32 off): 32 teacher-forced
                positions of 2 prompts through decode_step within 2e-3 of
                forward. (c) mamba2-370m and granite-moe-1b-a400m at full
                width in bf16, batch 4, prompt 16, gen 16, as (a). (d) The
                smoke config of each of the nine decoders in float32 on the
                card and on the host from the same weights: 8
                teacher-forced steps within 1e-4 of the host's logits and
                2e-3 of the card's forward. None of the four kernels may
                launch in the phase.
  8. lm_train — the LM training path (launch/steps.py::make_train_step,
                launch/train.py, the flash and MoE-dispatch backwards as
                autograd Functions), outside inference mode. (a)
                granite-3-2b at full width and depth in bf16, AdamW, remat,
                batch 2 x seq 4,096: a warm-up step (rate 0) then 4 steps on
                one repeated TokenStream batch: loss and grad_norm each
                step, median step ms, tok/s, peak memory, the step's bound
                (matmuls at the bf16 rate, attention's float32 contractions
                at the float32 rate), one more step under torch.profiler
                and its busy share; gates: finite, the last loss below the
                first. (b) granite-moe-1b-a400m and mamba2-370m likewise, 3
                steps. (c) The flash Function against autograd through a
                full-softmax attention (float32, B 2, S 1,024, H 8, hd 64,
                chunk 256, causal and not) and the dispatch Function
                against autograd through the plain gather at
                granite-moe's train shape, within 5e-5. (d) Every smoke
                config in float32: loss and every gradient leaf on the card
                against the host's (1e-5 relative, 1e-4 of the leaf's max).
                (e) The train CLI resuming a step-50 checkpoint on the card,
                and an in-process resume, against 52 steps straight through
                (1e-5 relative). None of the four kernels may launch.
  9. lm_mesh — the LM steps over a mesh (launch/steps.py, sharding/
                policies.py), outside inference mode. (a) granite-3-2b at
                full width and depth in bf16, AdamW, remat, on a (2, 2)
                mesh of the card listed four times: FSDP and ZeRO-1, batch
                2 x 4,096 (one sequence a data row). The one-device step
                from the same parameters and batch, then a control mesh
                step with data row 1 left out of the loss (rate 0), a
                warm-up step (rate 0) and two timed mesh steps: step ms,
                peak memory and the bytes of parameters, gradients and
                AdamW state each mesh position holds beside one device's.
                Gates: the first loss within 1e-5 and the gradient norm
                within 1e-3 (relative) of the one-device step's, the
                control outside one of the two, losses finite and falling.
                (b) Every smoke config in float32 over the (2, 2) card
                mesh, FSDP off and on, and granite-moe-1b-a400m's over a
                (2, 1) [card, host] mesh, against one device on the card:
                two train steps (metrics 1e-5, gradient norm 1e-4 relative,
                parameters 1e-5 of each leaf's max plus the Adam steps'
                rates times 1e-8 of the gradient norm over the element's
                own gradient), prefill logits
                (1e-5), four decode steps (tokens equal, cache 1e-5). None
                of the four kernels may launch.
 10. dryrun  — the dry-run tools (launch/dryrun.py) and the kernels'
                dense oracles (kernels/ref.py). (a) Each CUDA kernel against
                its ref.py oracle, run on the host on a copy of the same
                inputs: three of the main frame's groups (BGM, 3 methods;
                the fused RM without a FIFO clamp), four of its compacted
                tiles (the tile RM) and its whole sort table, and the
                package's edge_case_block, edge_case_lists (the fused RM at
                gf 1 on them too) and edge_case_rows (K = 1 .. 65536).
                Gates: BGM words bit for bit; images within 1e-4, NaN in
                the same places (the kernels stop a tile whose pixels all
                fall below T = 1e-4 and keep its T, where the oracle
                multiplies on); sorted keys equal (rows holding NaN
                excepted: the network places NaN by its own order) and each
                row's (key, payload) pairs equal as a multiset. (b)
                granite-3-2b at full width, one pattern unit (FSDP pinned
                on, as the calibration pins the full model's), bf16, AdamW,
                remat, batch 2 x 4,096: one train step on the card under the
                dry run's counters (launch/dryrun.py::count_step), on one
                device and on a (2, 2) mesh of the card, and the same steps
                on meta. Gates: the FLOP counts equal exactly, and so do the
                bytes each position holds. Printed, not gated: bytes moved
                and collective bytes beside each other, and the meta peak of
                live tensors beside the card's max_memory_allocated over the
                step (less what was allocated before it), with their ratio.
                (c) python -m repro_torch.launch.dryrun in three
                subprocesses started together: granite-3-2b train_4k
                (16x16), mamba2-370m long_500k --multi-pod (a batch of one
                that does not split) and hubert-xlarge decode_32k (a skip
                record); each must exit 0 and write its record, whose key
                numbers are printed. None of the four kernels may launch in
                (b); the count covers this process only, so it does not see
                (c), whose cells run on meta in child processes.
 11. kernels  — every ported kernel: launches on its path, on the sharded
                path, in the serve phase's realtime run, over the
                autotune phase, in the gateway's in-process run, on the
                mesh phase's (2, 2) mesh (its batch and tile_baseline
                frame), in the lm, lm_train, lm_mesh and dryrun phases
                (none), error, times,
                bound, library time (torch.sort + gather for the bitonic
                sort). The train phase launches none of them.

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it. Without CUDA, or without the repository beside this
file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Main-path configuration: the paper's train scene at its resolution.
WIDTH, HEIGHT = 1952, 1088
MAIN_GAUSSIANS = 1_026_000
LOSSLESS_GAUSSIANS = 120_000
BATCH_AZIMUTHS_DEG = (0.0, -3.0, 3.0, 6.0)   # the batch phase's four cameras
GSM_WIDE_K = (16384, 65536)                  # rows past one block's shared span
GSM_EDGE_MAX_LOG2 = 16                       # gsm_edge_cases: K = 1 .. 65536
CFG_KW = dict(
    mode="gstg", tile=16, group=64, boundary_group="ellipse", boundary_tile="ellipse",
    group_capacity=8192, tile_capacity=2048, span=6, chunk=32,
)
IMAGE_TOL = 1e-4          # sequential blend vs the chunked cumprod reassociates
COUNTER_RTOL = 1e-5       # alpha/blend flips at the T_before > 1e-4 gate
REPS = 10

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# float32 operations, counted from the CUDA sources: an add, multiply,
# division, square root, abs, min, max, compare or expf counts one; a
# negation or a select nothing. The BGM kernel's shared form, per live entry
# of a group: per entry, per tile column, per tile row, per tile, per
# vertical and per horizontal tile line, per (vertical line, tile row) and
# per (horizontal line, tile column) point. Work that depends on the group
# alone (line positions, tile centres and half-sizes) counts nothing.
BGM_OPS = {"aabb": (4, 2, 2, 0, 0, 0, 0, 0), "obb": (14, 11, 9, 8, 0, 0, 0, 0),
           "ellipse": (7, 2, 2, 4, 6, 5, 8, 9)}
# One whole boundary test per (entry, member tile), as core/boundary.py and
# the BGM of PR 11 run it: reported beside the bound, for comparison with
# the rows of earlier designs.
OPS_PER_TEST = {"aabb": 8, "obb": 54, "ellipse": 75}
# An alpha test per (pixel, entry) and a blend per contributing one.
# Bytes the kernels need from these inputs: the valid row over the whole
# padded list (it says which entries are live), the other rows a kernel reads
# over the live entries only, and every output in full.
ENTRY_ROWS = {"aabb": 3, "obb": 6, "ellipse": 5}  # mean x/y + the method's rows
RASTER_ROWS = 9   # mean x/y, conic a/b/c, opacity, rgb
OPS_PER_ALPHA = 17
OPS_PER_BLEND = 9
# wide_chunk: the cuda tests' 20,000-gaussian frame, lists up to ~2,400.
WIDE_CHUNK, WIDE_GAUSSIANS, WIDE_SIZE = 2048, 20_000, (256, 192)
# train: AdamW steps at the main path's size; train_grad_vs_host: a frame the
# host differentiates in seconds, and the CPU tests' bounds against JAX.
TRAIN_STEPS = 4
SHARDS = (2, 7)           # sharded: 1,026,000 = 7 x 146,572 - 4, so D = 7 pads
HOST_GAUSSIANS, HOST_SIZE, HOST_TILE_CAPACITY = 20_000, (256, 192), 1024
CLI_CAPACITY = 8192       # timed: the one-shot CLI's --capacity
STAGE_SPANS = ("stage/project", "stage/identify", "stage/bin", "stage/bitmask",
               "stage/compact", "stage/rasterize", "stage/render")
# serve: the serving tier at the paper's scene sizes (configs/gs_scenes.py).
SERVE_SCENES = ("train", "truck", "playroom")
SERVE_AZIMUTHS_DEG = (0.0, -3.0, 3.0, 6.0)
SERVE_REQUESTS, SERVE_RATE_HZ, SERVE_MAX_BATCH = 16, 8.0, 4
SERVE_TILE_REQUESTS = (2, 6, 10, 14)      # train requests in tile_baseline mode
RESIDENCY_REQUESTS = 9
ORBIT_POSES, ORBIT_FRAMES, DOLLY_FRAMES, DOLLY_STEP = 16, 24, 8, 0.25
SERVE_CLI_GAUSSIANS = 200_000
# gateway: two workers over train and truck at their paper sizes; the CLI's
# two subprocess workers over both at the train size.
GATEWAY_SCENES = ("train", "truck")
GATEWAY_REQUESTS, GATEWAY_MAX_BATCH, GATEWAY_CLI_REQUESTS = 16, 4, 8
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4           # max-abs difference over the field's largest magnitude
# autotune: the main frame's triple probed at rising spans (the smallest with
# no cut list is tuned), over a grid that holds that triple, feasible points
# at another tile and another group, and gstg points past 32 member tiles.
# The base group capacity holds group-128 lists, and capacity 4,096 the
# 32-px tile lists (the sweep line's list_max gives their longest).
AUTOTUNE_SPANS = (6, 8, 12, 16)
AUTOTUNE_GROUP_CAPACITY = 16384
AUTOTUNE_GRID = dict(tiles=(8, 16, 32), group_factors=(2, 4, 8), capacities=(2048, 4096))
AUTOTUNE_REPS = 3
AUTOTUNE_TOP_K = 3
AUTOTUNE_CLI = ["--gaussians", "3000", "--width", "256", "--height", "192",
                "--capacity", "512"]


def eval_cameras(extent: float, azimuths_deg, width: int, height: int) -> list:
    """Cameras on the circle of a scene's eval camera (``configs/gs_scenes.py::
    scene_and_camera``: eye (0, 0.35 extent, 1.5 extent), 62 degree field of
    view, looking at the origin), at these azimuths; azimuth 0 is the eval
    camera itself, bit for bit."""
    from repro_torch.core import make_camera

    radius = math.hypot(extent * 0.35, extent * 1.5)
    elev = math.atan2(extent * 0.35, extent * 1.5)
    cams = []
    for deg in azimuths_deg:
        az = math.radians(deg)
        eye = ((0.0, extent * 0.35, extent * 1.5) if deg == 0 else
               (radius * math.cos(elev) * math.sin(az), radius * math.sin(elev),
                radius * math.cos(elev) * math.cos(az)))
        cams.append(make_camera(eye, (0, 0, 0), width, height, fov_x_deg=62.0))
    return cams


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float):
    """The least time for the work in ms, and what bounds it: the bytes
    over the memory rate or the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bgm_ops(method: str, live_per_group, in_img, gf: int) -> int:
    """The BGM's operations on this data: each group's live entries times
    the shared form's count over the tile lines and tiles that its in-image
    member tiles (a cols x rows rectangle) need."""
    e, col, row, tile, v_line, h_line, v_pt, h_pt = BGM_OPS[method]
    m = in_img.reshape(-1, gf, gf).to("cpu")
    c, r = m.any(1).sum(1).double(), m.any(2).sum(1).double()
    per = (e + col * c + row * r + tile * c * r + v_line * (c + 1) + h_line * (r + 1)
           + v_pt * (c + 1) * r + h_pt * (r + 1) * c)
    return int((live_per_group.to("cpu").double() * per * (c * r > 0)).sum())


def ptxas_instances(build, source: str, pattern: str, label) -> dict:
    """Registers, shared memory and spills of each compiled instance of a
    kernel in ``csrc/<source>.cu``, from the ptxas report beside its
    library: ``pattern`` matches the instance's mangled name and ``label``
    names it from the match."""
    instances = {}
    log = Path(f"{build.library_path(source)}.log")
    if log.exists():
        name = None
        for line in log.read_text().splitlines():
            m = re.search(pattern, line)
            if "Compiling entry function" in line:
                name = label(m) if m else None
            elif name and "spill" in line:
                instances.setdefault(name, {})["spills"] = line.strip()
            elif name and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line)
                smem = re.search(r"(\d+) bytes smem", line)
                instances.setdefault(name, {}).update(
                    registers=int(regs.group(1)) if regs else None,
                    smem_bytes=int(smem.group(1)) if smem else 0)
    return instances


def fused_build_report(build) -> dict:
    """The fused raster kernel as built: its block shape (from the source's
    constants) and, per instance, registers and shared memory. NPIX is
    pixels a thread; FULL says every pixel slot lies in the tile."""
    src = (build.CSRC / "raster_tile.cu").read_text()
    warps = int(re.search(r"constexpr int FUSED_WARPS = (\d+);", src).group(1))
    pix = int(re.search(r"constexpr int MAX_PIX_PER_THREAD = (\d+);", src).group(1))
    tile_px = CFG_KW["tile"]
    per_tile = -(-tile_px * tile_px // (32 * pix))
    return {"block_threads": 32 * warps, "warps_per_tile": per_tile,
            "tiles_per_block": warps // per_tile,
            "instances": ptxas_instances(
                build, "raster_tile", r"raster_group_fusedILi(\d+)ELb([01])E",
                lambda m: f"NPIX={m.group(1)},FULL={m.group(2)}")}


def tile_build_report(build, tile_kernel_shape) -> dict:
    """The tile raster kernel as built: its launch for the main path's tile,
    as the CUDA source reports it, and, per instance, registers, shared
    memory and spills. NPIX is pixels a thread; FULL says every pixel slot
    lies in the tile."""
    return {**tile_kernel_shape(CFG_KW["tile"]),
            "instances": ptxas_instances(
                build, "raster_tile", r"raster_tileILi(\d+)ELb([01])E",
                lambda m: f"NPIX={m.group(1)},FULL={m.group(2)}")}


def bgm_build_report(build, methods) -> dict:
    """The BGM kernel as built: its block size and, per (gf, method)
    instance, registers, shared memory and spills."""
    src = (build.CSRC / "bitmask_gen.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    return {"block_threads": threads,
            "instances": ptxas_instances(
                build, "bitmask_gen", r"bitmask_gen_kernelILi(\d+)ELi(\d+)E",
                lambda m: f"GF={m.group(1)},{methods[int(m.group(2))]}")}


def bitonic_build_report(build, block_shape) -> dict:
    """The GSM kernel as built: its block for the main path's rows (threads,
    slots a thread holds in registers, slots a block sorts, dynamic shared
    memory), as the CUDA source reports it, and, per instance (E slots a
    thread x T threads, and the global-memory pass), registers, static
    shared memory and spills, with the spilled bytes."""
    instances = ptxas_instances(
        build, "bitonic_sort",
        r"bitonic_(?:block_kernelILi(\d+)ELi(\d+)E|global_pass_kernel)",
        lambda m: f"E={m.group(1)},T={m.group(2)}" if m.group(1) else "global_pass")
    for inst in instances.values():
        inst["spill_bytes"] = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill", inst.get("spills", "")))
    return {**block_shape(CFG_KW["group_capacity"]), "instances": instances}


def perturbed(scene, gen):
    """The training example's start: means + 0.08 N(0,1), opacity - 1,
    sh + 0.1 N(0,1), drawn from ``gen`` on the scene's device."""
    import torch

    def noise(x):
        return torch.randn(x.shape, generator=gen, device=x.device)

    return dataclasses.replace(scene, means3d=scene.means3d + 0.08 * noise(scene.means3d),
                               opacity=scene.opacity - 1.0, sh=scene.sh + 0.1 * noise(scene.sh))


def loss_and_grads(scene, cam, target, cfg, lam):
    """scene_loss of ``scene`` and its gradient per field, by autograd."""
    import torch
    from repro_torch.core.gaussians import SCENE_FIELDS
    from repro_torch.core.train import scene_loss, trainable

    leaves = trainable(scene)
    loss, img = scene_loss(leaves, cam, target, cfg, lam)
    grads = torch.autograd.grad(loss, [getattr(leaves, f) for f in SCENE_FIELDS])
    return loss.detach(), img.detach(), dict(zip(SCENE_FIELDS, grads))


def profile_step(on_card, fn, top=12) -> dict:
    """One call of ``fn`` under torch.profiler, in a range of its own ended
    by a synchronize: its wall time, the device time of all its kernels,
    the ``top`` kernels by device time (ms and launches) and, on the card,
    the device's busy share of the range (the union of its device
    intervals inside the range's host span, over that span; read from the
    profiler's events, as a train step's trace file runs to hundreds of MB).
    Operator rows are left out: they repeat their kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function("chip_smoke/step"):
            fn()
            if on_card:
                torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != "chip_smoke/step"]
    rows.sort(key=lambda r: -r[1])
    out = {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows),
           "kernel_launches": sum(r[2] for r in rows),
           "top_kernels_ms": [{"kernel": k[:120], "ms": ms, "launches": n}
                              for k, ms, n in rows[:top]]}
    if on_card:
        # The range appears twice, on the host and as a device annotation
        # over the step's device work (left out of the rows above too): only
        # kernels, copies and memsets are device intervals.
        events = prof.events()
        (step,) = [e for e in events if e.name == "chip_smoke/step"
                   and e.device_type == DeviceType.CPU]
        f0, f1 = step.time_range.start, step.time_range.end
        spans = sorted((max(e.time_range.start, f0), min(e.time_range.end, f1))
                       for e in events if e.device_type == DeviceType.CUDA
                       and e.name != "chip_smoke/step"
                       and e.time_range.end > f0 and e.time_range.start < f1)
        busy, end = 0.0, f0
        for lo, hi in spans:
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        out.update(step_span_ms=(f1 - f0) / 1e3, busy_ms=busy / 1e3,
                   busy_share=busy / (f1 - f0))
    return out


def train_phase(dev, on_card, check, cam, target, n_main, width, height) -> None:
    """Scene training on the main path's scene, camera and config through
    the reference backend, then the card's gradients against the host's on
    a small frame. Runs outside inference mode: autograd saves no
    inference tensor."""
    import torch

    from repro_torch.core import RenderConfig, make_camera, render, scene_like_paper
    from repro_torch.core.gaussians import random_scene
    from repro_torch.core.train import SceneTrainConfig, make_train_step
    from repro_torch.optim import adamw_init

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    cfg = RenderConfig(backend="reference", **CFG_KW)
    tcfg = SceneTrainConfig()
    init = perturbed(scene_like_paper("train", n_main, device=dev),
                     torch.Generator(device=dev).manual_seed(1))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # Step 0: gradients, and the forward image against an inference render.
    _, img0, grads = loss_and_grads(init, cam, target, cfg, tcfg.lambda_dssim)
    with torch.inference_mode():
        plain = render(init, cam, cfg)
    forward_bitwise = bool(torch.equal(img0, plain.image))
    overflow = plain.stats.as_dict()["overflow"]
    grad_stats = {k: {"finite": bool(torch.isfinite(g).all()), "max_abs": float(g.abs().max())}
                  for k, g in grads.items()}
    del img0, grads, plain

    step = make_train_step(cam, cfg, tcfg)
    scene, opt = init, adamw_init(init)
    losses, psnrs, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        sync()
        t = time.perf_counter()
        scene, opt, loss, p = step(scene, opt, target, i)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        psnrs.append(float(p))
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    profile = profile_step(on_card, lambda: loss_and_grads(scene, cam, target, cfg,
                                                           tcfg.lambda_dssim))
    del scene, opt, init
    emit({"phase": "train", "gaussians": n_main, "width": width, "height": height,
          "steps": TRAIN_STEPS, "config": CFG_KW, "backend": "reference",
          "losses": losses, "psnrs": psnrs, "step_ms": statistics.median(step_ms[1:]),
          "step_ms_each": step_ms, "peak_mem_gb": peak, "step0_overflow": overflow,
          "step0_forward_bitwise_vs_inference_render": forward_bitwise,
          "step0_grads": grad_stats, "profile": profile,
          "phase_s": time.perf_counter() - t_phase})
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train: losses not finite or not falling: {losses}")
    check(all(g["finite"] and g["max_abs"] > 0 for g in grad_stats.values()),
          f"train: a step-0 gradient is not finite or all zero: {grad_stats}")
    check(forward_bitwise, "train: the step-0 forward image differs from an inference render")

    # The same loss and gradients on the card and on the host.
    t_check = time.perf_counter()
    h_w, h_h = HOST_SIZE
    h_cam = make_camera((0.0, 1.2, 5.0), (0, 0, 0), h_w, h_h)
    h_cfg = RenderConfig(backend="reference", **{**CFG_KW, "group_capacity": 4096,
                                                 "tile_capacity": HOST_TILE_CAPACITY})
    h_scene = random_scene(HOST_GAUSSIANS, extent=3.0, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        h_ref = render(h_scene, h_cam, h_cfg)
    h_init = perturbed(h_scene, torch.Generator().manual_seed(1))
    t_host = time.perf_counter()
    loss_h, _, grads_h = loss_and_grads(h_init, h_cam, h_ref.image, h_cfg, tcfg.lambda_dssim)
    host_s = time.perf_counter() - t_host
    loss_d, _, grads_d = loss_and_grads(h_init.to(dev), h_cam, h_ref.image.to(dev), h_cfg,
                                        tcfg.lambda_dssim)
    loss_rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    grad_rel = {k: float((grads_d[k].cpu() - g).abs().max() / g.abs().max())
                for k, g in grads_h.items()}
    h_overflow = h_ref.stats.as_dict()["overflow"]
    emit({"phase": "train", "check": "train_grad_vs_host", "gaussians": HOST_GAUSSIANS,
          "width": h_w, "height": h_h, "tile_capacity": HOST_TILE_CAPACITY,
          "overflow": h_overflow, "loss_host": float(loss_h), "loss_device": float(loss_d),
          "loss_rel_diff": loss_rel, "grad_max_abs_over_max": grad_rel,
          "loss_rtol": LOSS_RTOL, "grad_tol": GRAD_TOL, "host_s": host_s,
          "check_s": time.perf_counter() - t_check})
    check(h_overflow == 0, f"train_grad_vs_host: overflow {h_overflow}")
    check(loss_rel <= LOSS_RTOL and all(v <= GRAD_TOL for v in grad_rel.values()),
          f"train_grad_vs_host: loss {loss_rel}, gradients {grad_rel}")


def sharded_phase(dev, on_card, check, cfg, scene, cam, cams, main, batch_one, scene_l,
                  cam_l, lossless_one) -> dict:
    """The scene in D logical shards on one card, bitwise against the D = 1
    renders of this run: ``main`` (the main path's frame), ``batch_one``
    (the batch phase's render_batch) and ``lossless_one`` (the lossless
    gstg frame). Returns the sharded path's launches of each kernel and the
    D = 2 frame."""
    import torch

    from repro_torch import engine
    from repro_torch.core import render
    from repro_torch.kernels import build
    from repro_torch.sharding import shard_scene_host

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def bitwise(out, want) -> bool:
        """Image and every counter equal (per lane for a batch)."""
        return bool(torch.equal(out.image, want.image)) and all(
            torch.equal(getattr(out.stats, f.name), getattr(want.stats, f.name))
            for f in dataclasses.fields(out.stats))

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else None

    def frame_ms(handle):
        """Median of REPS frames after a warm-up, host clock to sync."""
        handle.render(cam)
        sync()
        times = []
        for _ in range(REPS):
            t = time.perf_counter()
            handle.render(cam)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), times

    t_phase = time.perf_counter()
    same, times, frame_each, peaks, launches, gathers = {}, {}, {}, {}, {}, {}
    for shards in (1, *SHARDS):
        reset_peak()
        with engine.open(scene, cfg, device=dev, scene_shards=shards) as h:
            build.reset_launches()
            out = h.render(cam)
            sync()
            launches[shards] = dict(build.LAUNCHES)
            same[f"D{shards}"] = bitwise(out, main)
            if shards == 2:
                d2_frame = out
            del out
            times[shards], frame_each[shards] = frame_ms(h)
            gathers[shards] = h.stats()["feature_gather"]
        peaks[shards] = peak_gb()
    for gather in ("index", "psum", "flat"):
        with engine.open(scene, dataclasses.replace(cfg, feature_gather=gather), device=dev,
                         scene_shards=2) as h:
            same[f"D2_{gather}"] = bitwise(h.render(cam), main)
    hosted = shard_scene_host(scene, SHARDS[-1])
    padding = hosted.padded_size - hosted.num_real
    with engine.open(hosted.to(dev), cfg, device=dev) as h:
        same[f"D{SHARDS[-1]}_host_layout"] = bitwise(h.render(cam), main)
    del hosted
    with engine.open(scene, cfg, device=dev, scene_shards=2) as h:
        build.reset_launches()
        batch = h.render_batch(cams, pad_to=len(cams))
        sync()
        batch_launches = dict(build.LAUNCHES)
        same["D2_render_batch"] = bitwise(batch, batch_one)
    del batch
    two = dataclasses.replace(cfg, scene_shards=2)
    gstg_two = render(scene_l, cam_l, two)
    build.reset_launches()
    tile_two = render(scene_l, cam_l, dataclasses.replace(two, mode="tile_baseline"))
    sync()
    tile_launches = dict(build.LAUNCHES)
    same["lossless_D2_gstg_vs_D1"] = bitwise(gstg_two, lossless_one)
    same["lossless_D2_gstg_vs_tile_baseline"] = bool(torch.equal(gstg_two.image, tile_two.image))
    lossless_stats = tile_two.stats.as_dict()
    del gstg_two, tile_two
    path = {s: {k: launches[s][k] for k in ("bitmask_gen", "raster_group_fused")}
            for s in SHARDS}
    emit({"phase": "sharded", "gaussians": scene.num_gaussians, "shards": list(SHARDS),
          "padding_rows": {str(SHARDS[-1]): padding}, "bitwise_vs_D1": same,
          "feature_gather": {str(k): v for k, v in gathers.items()},
          "frame_ms_median": {str(k): v for k, v in times.items()},
          "frame_ms": {str(k): v for k, v in frame_each.items()},
          "peak_mem_gb": {str(k): v for k, v in peaks.items()},
          "launches_per_frame": {str(k): v for k, v in path.items()},
          "batch_launches": batch_launches, "lossless_tile_baseline_launches": tile_launches,
          "lossless_tile_baseline_stats": lossless_stats,
          "phase_s": time.perf_counter() - t_phase})
    for what, ok in same.items():
        check(ok, f"sharded: {what} is not bitwise equal")
    check(padding == -scene.num_gaussians % SHARDS[-1] > 0,
          f"sharded: D = {SHARDS[-1]} pads {padding} rows")
    check(lossless_stats["overflow"] == 0 and lossless_stats["span_overflow"] == 0,
          f"sharded: a lossless list was cut: {lossless_stats}")
    for s, counts in path.items():
        check(counts == {"bitmask_gen": 1, "raster_group_fused": 1},
              f"sharded: D = {s} frame launched {counts}")
    check(all(batch_launches[k] == len(cams) for k in ("bitmask_gen", "raster_group_fused")),
          f"sharded: render_batch launched {batch_launches}")
    check(tile_launches["raster_tile"] == 1, f"sharded: tile_baseline launched {tile_launches}")
    check(gathers[1] == "flat" and all(gathers[s] == "index" for s in SHARDS),
          f"sharded: committed feature gathers {gathers}")
    return {"bitmask_gen": launches[2]["bitmask_gen"],
            "raster_group_fused": launches[2]["raster_group_fused"],
            "raster_tile": tile_launches["raster_tile"],
            "bitonic_sort": launches[2]["bitonic_sort"]}, d2_frame


def run_serve_cli(dev, gaussians: int, width: int, height: int, budget_mb: float) -> dict:
    """The serve CLI in two subprocesses on the card, started together: a
    stateless load over two scenes under a budget that holds one, and one
    stream lapping its orbit; each with --parity-check, a trace and a
    metrics snapshot."""
    out_dir = ROOT / "build" / "repro_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    common = ["--backend", "cuda", "--device", dev.type, "--gaussians", str(gaussians),
              "--resolutions", f"{width}x{height}", "--capacity", "8192",
              "--max-batch", "2", "--no-realtime", "--parity-check"]
    runs = {"stateless": ["--scenes", "train,truck", "--requests", "6",
                          "--device-budget-mb", str(budget_mb)],
            "stream": ["--scenes", "train", "--streams", "1", "--stream-frames", "18"]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, extra in runs.items():
        files = [out_dir / f"serve_{name}_trace.json", out_dir / f"serve_{name}_metrics.json"]
        for f in files:
            f.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.render_serve", *common, *extra,
               "--trace-json", str(files[0]), "--metrics-json", str(files[1])]
        procs[name] = (cmd, files, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    result = {}
    for name, (cmd, files, t, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        docs = [json.loads(f.read_text()) if f.exists() else None for f in files]
        result[name] = {"cmd": " ".join(cmd[1:]), "returncode": proc.returncode,
                        "wall_s": time.perf_counter() - t, "stdout_tail": stdout[-1500:],
                        "stderr_tail": stderr[-1500:], "trace": docs[0], "metrics": docs[1]}
    return result


def serve_phase(dev, on_card, check, smi, width: int, height: int, gaussians=None,
                cli_gaussians: int = SERVE_CLI_GAUSSIANS) -> dict:
    """The serving tier on the card at the paper's scene sizes (``gaussians``
    overrides them for a rehearsal on the host): a stateless RenderServer
    (realtime, then the same load closed-loop), residency paging over three
    scenes, one stream session, and the serve CLI. Returns each kernel's
    launches in the realtime stateless run."""
    import numpy as np
    import torch

    from repro_torch import engine
    from repro_torch.configs import PAPER_SCENES
    from repro_torch.core import RenderConfig, orbit_cameras, scene_like_paper
    from repro_torch.core.projection import projected_bytes_per_gaussian
    from repro_torch.kernels import build
    from repro_torch.utils import pytree_bytes
    from repro_torch.obs import (
        Tracer,
        get_registry,
        set_tracer,
        validate_chrome_trace,
        validate_residency_trace,
        validate_stream_trace,
    )
    from repro_torch.serving import RenderRequest, RenderServer, poisson_arrivals

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def mem_gb():
        return torch.cuda.memory_allocated() / 2**30 if on_card else None

    def counters():
        return dict(get_registry().snapshot()["counters"])

    def delta(before):
        return {k: v - before.get(k, 0) for k, v in counters().items()}

    t_phase = time.perf_counter()
    cfg = RenderConfig(backend="cuda", **CFG_KW)
    cfg_tile = dataclasses.replace(cfg, mode="tile_baseline")
    scenes = {name: scene_like_paper(name, gaussians or PAPER_SCENES[name].paper_gaussians,
                                     device=dev)
              for name in SERVE_SCENES}
    cams = {name: eval_cameras(PAPER_SCENES[name].extent, SERVE_AZIMUTHS_DEG, width, height)
            for name in SERVE_SCENES}
    refs, overflow = {}, {}

    def reference(sid, c, k):
        """Renderer.render of camera k on a handle of the request's config."""
        key = (sid, c.mode, k)
        if key not in refs:
            with engine.open(scenes[sid], c, device=dev) as h:
                out = h.render(cams[sid][k])
                refs[key] = out.image.cpu()
                overflow[f"{sid}/{c.mode}"] = out.stats.as_dict()["overflow"]
        return refs[key]

    # -- stateless: train and truck, four train requests in tile_baseline ----
    def stateless_load():
        offsets = poisson_arrivals(SERVE_REQUESTS, SERVE_RATE_HZ, seed=0)
        load = []
        for i, t in enumerate(offsets):
            sid = "truck" if i % 2 else "train"
            c = cfg_tile if i in SERVE_TILE_REQUESTS else cfg
            load.append((t, RenderRequest(i, sid, cams[sid][(i // 2) % len(SERVE_AZIMUTHS_DEG)],
                                          c)))
        return load

    stateless, launches = {}, {}
    for realtime in (True, False):
        name = "realtime" if realtime else "closed_loop"
        load = stateless_load()
        with RenderServer({k: scenes[k] for k in ("train", "truck")}, device=dev,
                          max_batch=SERVE_MAX_BATCH, max_wait=0.05) as server:
            for _, r in load:
                server.commit(r.scene_id, r.cfg)
            sync()
            build.reset_launches()
            results = server.run(load, realtime=realtime)
            launches[name] = dict(build.LAUNCHES)
            summary = server.stats.summary()
            buckets = {(sig[0], sig[1].mode): (b.requests, b.batches, b.padded, b.render_s)
                       for sig, b in server.stats.buckets.items()}
            shared = server.commit("train", cfg).committed_scene.means3d is \
                server.commit("train", cfg_tile).committed_scene.means3d
        bitwise = [bool(torch.equal(results[r.request_id].image,
                                    reference(r.scene_id, r.cfg, (r.request_id // 2) % 4)))
                   for _, r in load] if sorted(results) == list(range(len(load))) else []
        want_sig = {}
        for _, r in load:
            key = (r.scene_id, r.cfg.mode)
            want_sig[key] = want_sig.get(key, 0) + 1
        lanes = {key: b[1] * SERVE_MAX_BATCH for key, b in buckets.items()}
        gstg_lanes = sum(v for (sid, mode), v in lanes.items() if mode == "gstg")
        tile_lanes = sum(v for (sid, mode), v in lanes.items() if mode == "tile_baseline")
        stateless[name] = {
            "completed": summary["completed"], "batches": summary["batches"],
            "padded_lanes": summary["padded"], "p50_ms": summary["p50_ms"],
            "p99_ms": summary["p99_ms"], "req_per_s": summary["fps"],
            "wall_s": summary["wall_s"],
            "buckets": {f"{sid}/{mode}": {"requests": b[0], "dispatches": b[1], "padded": b[2],
                                          "render_s_per_dispatch": b[3] / b[1]}
                        for (sid, mode), b in buckets.items()},
            "bitwise_vs_render": bitwise, "launches": launches[name],
            "one_scene_copy_for_two_configs": shared}
        check(sorted(results) == list(range(len(load))),
              f"serve: {name} completed {sorted(results)}")
        check(bitwise and all(bitwise), f"serve: {name} images differ from render: {bitwise}")
        check(shared, f"serve: {name}: two configs over train hold two scene copies")
        check(all(b[2] == b[1] * SERVE_MAX_BATCH - b[0] for b in buckets.values())
              and summary["padded"] == SERVE_MAX_BATCH * summary["batches"] - len(load),
              f"serve: {name} padded lanes {buckets}")
        if not realtime:
            # Closed loop: each signature's n requests make ceil(n / 4)
            # dispatches and pad the last to 4.
            want = {k: (n, -(-n // SERVE_MAX_BATCH), -n % SERVE_MAX_BATCH)
                    for k, n in want_sig.items()}
            check({k: b[:3] for k, b in buckets.items()} == want,
                  f"serve: closed-loop buckets {buckets} != the scheduler's {want}")
        check(launches[name]["bitmask_gen"] == gstg_lanes
              and launches[name]["raster_group_fused"] == gstg_lanes
              and launches[name]["raster_tile"] == tile_lanes,
              f"serve: {name} launched {launches[name]} for {gstg_lanes} gstg and "
              f"{tile_lanes} tile_baseline lanes")

    # -- residency: three scenes, a budget that holds the two largest ----------
    def round_robin():
        return [(0.0, RenderRequest(i, SERVE_SCENES[i % 3], cams[SERVE_SCENES[i % 3]][0], cfg))
                for i in range(RESIDENCY_REQUESTS)]

    with RenderServer(scenes, device=dev, max_batch=1, max_wait=0.0) as plain:
        cost = {sid: (lambda st: st["scene_mb_per_device"] + st["feature_mb_per_device"])(
            plain.commit(sid, cfg).stats()) for sid in SERVE_SCENES}
        mem_all_resident = mem_gb()
        unbudgeted = plain.run(round_robin(), realtime=False)
    largest = sorted(cost.values())[1:]
    budget = sum(largest) + 0.5 * min(cost.values())
    sync()
    mem_none = mem_gb()
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    c0 = counters()
    try:
        with RenderServer(scenes, device=dev, max_batch=1, max_wait=0.0,
                          device_budget_mb=budget) as server:
            for sid in SERVE_SCENES:
                server.commit(sid, cfg)
            sync()
            mem_committed = mem_gb()
            paged = server.run(round_robin(), realtime=False)
            sync()
            mem_after = mem_gb()
            res_stats = server.residency.stats()
            resident = sorted(server.resident_scene_ids)
        res_counters = delta(c0)
        doc = tracer.chrome_trace()
    finally:
        set_tracer(prev)
    page_ins = [{"entry": e.args["entry"], "ms": e.duration_s * 1e3,
                 "gb_per_s": e.args["bytes"] / max(e.duration_s, 1e-12) / 1e9,
                 "bytes": e.args["bytes"]}
                for e in tracer.events() if e.name == "residency/page_in"]
    res_errors = validate_chrome_trace(doc) + validate_residency_trace(doc, res_counters)
    res_bitwise = [bool(torch.equal(paged[i].image, unbudgeted[i].image))
                   for i in range(RESIDENCY_REQUESTS)] if len(paged) == len(unbudgeted) else []
    emit({"phase": "serve", "nvidia_smi": smi, "width": width, "height": height,
          "scenes": {k: s.num_gaussians for k, s in scenes.items()}, "config": CFG_KW,
          "stateless": stateless, "overflow": overflow})
    check(sum(largest) < budget < sum(cost.values()),
          f"serve: residency budget {budget} does not hold two and refuse three {cost}")
    check(res_bitwise and all(res_bitwise),
          f"serve: residency images differ from the unbudgeted server's: {res_bitwise}")
    check(res_stats["evictions"] > 0, f"serve: no eviction under the budget: {res_stats}")
    check(not res_errors, f"serve: residency trace: {res_errors[:3]}")

    # -- streams: one stream over train, an orbit lapped, then a dolly ---------
    spec = PAPER_SCENES["train"]
    orbit = orbit_cameras(ORBIT_POSES, math.hypot(spec.extent * 0.35, spec.extent * 1.5),
                          width, height, fov_x_deg=62.0)
    base = cams["train"][0]
    t0_dolly = (np.round(np.asarray(base.t, np.float64) * 4) / 4).astype(np.float32)
    dolly = [dataclasses.replace(base, t=t0_dolly + np.float32(i) * np.array(
        [0.0, 0.0, DOLLY_STEP], np.float32)) for i in range(DOLLY_FRAMES)]
    path = [orbit[i % ORBIT_POSES] for i in range(ORBIT_FRAMES)] + dolly
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    c0 = counters()
    frames = []
    try:
        with engine.open(scenes["train"], cfg, device=dev) as h, h.open_stream() as stream:
            for i, c in enumerate(path):
                idle = stream.wait_spec_idle(timeout=120)
                before = stream.stats()
                bgm = build.LAUNCHES["bitmask_gen"]
                t = time.perf_counter()
                out = stream.render(c)
                sync()
                ms = (time.perf_counter() - t) * 1e3
                after = stream.stats()
                frames.append({"ms": ms, "hit": after["hits"] > before["hits"],
                               "spec_hit": after["spec_hits"] > before["spec_hits"],
                               "bgm_launches": build.LAUNCHES["bitmask_gen"] - bgm,
                               "idle_before": idle,
                               "bitwise": bool(torch.equal(out.image, h.render(c).image))})
                del out
            stream.wait_spec_idle(timeout=120)
            cache_mb = h.frontend_cache_mb()
            entry = h._res_entry
            cost_gap = entry.cost_mb() - (entry.static_mb + cache_mb)
            st = stream.stats()
            stream_counters = delta(c0)
            doc = tracer.chrome_trace()
            verifies = sum(1 for e in tracer.events() if e.name == "spec/verify")
            # Hit against miss without speculation: a synchronize after a
            # frame would also wait for the frontends the worker queues.
            quiet = h.open_stream(speculate=False)
            timed = []
            for c in orbit[:ORBIT_POSES // 2] * 2:
                t = time.perf_counter()
                quiet.render(c)
                sync()
                timed.append((time.perf_counter() - t) * 1e3)
            quiet.close()
    finally:
        set_tracer(prev)
    stream_errors = validate_chrome_trace(doc) + validate_stream_trace(doc, stream_counters)
    lap2_hits = sum(f["hit"] for f in frames[ORBIT_POSES:ORBIT_FRAMES])
    dolly_spec_hits = sum(f["spec_hit"] for f in frames[ORBIT_FRAMES:])
    miss_ms, hit_ms = timed[:ORBIT_POSES // 2], timed[ORBIT_POSES // 2:]
    del scenes, refs, unbudgeted, paged
    sync()

    # -- the serve CLI in subprocesses ------------------------------------------
    # A budget that holds one of the CLI's two scenes (parameters + features).
    per_gaussian = (pytree_bytes(scene_like_paper("train", 8, device="cpu")) / 8
                    + projected_bytes_per_gaussian())
    cli = run_serve_cli(dev, cli_gaussians, width, height,
                        budget_mb=1.5 * cli_gaussians * per_gaussian / 2**20)
    cli_checks = {}
    for name, r in cli.items():
        doc, snap = r.pop("trace"), r.pop("metrics")
        errs = (["no trace or metrics written"] if doc is None or snap is None else
                validate_chrome_trace(doc) + validate_residency_trace(doc, snap["counters"])
                + validate_stream_trace(doc, snap["counters"]))
        c = (snap or {}).get("counters", {})
        cli_checks[name] = {"errors": errs[:5], "completed": (doc or {}).get(
            "summary", {}).get("completed"), "evictions": c.get("residency.evictions_total", 0),
            "stream_hits": c.get("stream.hits_total", 0)}

    emit({"phase": "serve", "check": "residency", "nvidia_smi": smi,
          "entry_mb": cost, "budget_mb": budget, "stats": res_stats,
          "resident_after": resident, "bitwise_vs_unbudgeted": res_bitwise,
          "page_ins": page_ins, "trace_errors": res_errors[:5],
          "memory_allocated_gb": {"three_resident_unbudgeted": mem_all_resident,
                                  "none_committed": mem_none,
                                  "budgeted_after_commits": mem_committed,
                                  "budgeted_after_run": mem_after}})
    emit({"phase": "serve", "check": "stream", "nvidia_smi": smi, "frames": len(frames),
          "orbit_lap2_hits": lap2_hits, "dolly_spec_hits": dolly_spec_hits,
          "stats": {k: v for k, v in st.items() if k != "cache"},
          "spec_verify_spans": verifies, "frontend_cache_mb": cache_mb,
          "entry_cost_gap_mb": cost_gap,
          "hit_frame_ms_median": statistics.median(hit_ms),
          "miss_frame_ms_median": statistics.median(miss_ms),
          "hit_frame_ms": hit_ms, "miss_frame_ms": miss_ms,
          "frame_ms_with_speculation": [round(f["ms"], 3) for f in frames],
          "hits": [f["hit"] for f in frames], "trace_errors": stream_errors[:5]})
    emit({"phase": "serve", "check": "cli", "runs": cli, "cross_checks": cli_checks,
          "phase_s": time.perf_counter() - t_phase})
    check(all(f["bitwise"] for f in frames),
          f"serve: stream frames differ from render: {[f['bitwise'] for f in frames]}")
    check(lap2_hits >= 8, f"serve: {lap2_hits} exact hits on the orbit's second lap")
    check(dolly_spec_hits >= 1, "serve: no speculative hit on the dolly")
    check(all(f["idle_before"] for f in frames), "serve: the speculation worker never idled")
    check(verifies == st["frames"] == stream_counters.get("stream.frames_total"),
          f"serve: {verifies} spec/verify spans for {st['frames']} frames")
    check(all(f["bgm_launches"] == 1 for f in frames),
          f"serve: stream frames launched the BGM {[f['bgm_launches'] for f in frames]}")
    check(cache_mb > 0 and abs(cost_gap) < 1e-6,
          f"serve: frontend cache {cache_mb} MB, entry cost gap {cost_gap}")
    check(not stream_errors, f"serve: stream trace: {stream_errors[:3]}")
    for name, r in cli.items():
        check(r["returncode"] == 0, f"serve: the {name} CLI exited {r['returncode']}: "
                                    f"{r['stderr_tail'][-500:]}")
        check(not cli_checks[name]["errors"],
              f"serve: the {name} CLI trace: {cli_checks[name]['errors'][:3]}")
    check(cli_checks["stateless"]["evictions"] > 0, "serve: the CLI paged nothing")
    check(cli_checks["stream"]["stream_hits"] > 0, "serve: the CLI stream never hit")
    return launches["realtime"]


def autotune_phase(dev, on_card, check, smi, width: int, height: int,
                   gaussians: int = MAIN_GAUSSIANS, lossless_gaussians: int = LOSSLESS_GAUSSIANS,
                   spans=AUTOTUNE_SPANS, grid=AUTOTUNE_GRID,
                   group_capacity: int = AUTOTUNE_GROUP_CAPACITY) -> dict:
    """Tile-parameter autotune on the main frame (``gaussians``, ``spans``,
    ``grid`` and ``group_capacity`` shrink it for a rehearsal on the host),
    with the port's autotune cache in a temporary file. Returns each
    kernel's launches over the phase."""
    import tempfile

    import torch

    from repro_torch import engine
    from repro_torch.autotune import (
        Candidate,
        autotune,
        autotune_signature,
        config_for,
        stats_pass,
        sweep,
    )
    from repro_torch.autotune.cache import lookup
    from repro_torch.configs import PAPER_SCENES, scene_and_camera
    from repro_torch.core import (
        GridSpec,
        RenderConfig,
        make_camera,
        render_cache_clear,
        render_cache_info,
        render_frontend,
        scene_like_paper,
    )
    from repro_torch.core.stages import get_backend, mask_tile_lengths
    from repro_torch.kernels import build
    from repro_torch.serving import RenderRequest, RenderServer

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else None

    def wall(fn):
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    def memory_entries():
        return render_cache_info()["autotune"]["currsize"]

    def list_max(scene, cam, cfg):
        """The frame's longest group list and longest tile list (the BGM
        launches once)."""
        front = render_frontend(scene, cam, cfg)
        grid = GridSpec(width, height, cfg.tile, cfg.group, cfg.span)
        masks = get_backend("cuda").bitmasks(front.proj, front.table, grid,
                                              cfg.boundary_tile, chunk=cfg.chunk)
        return [int(front.table.lengths.max()),
                int(mask_tile_lengths(front.table, masks, grid).max())]

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory()
    cache_file = Path(tmp.name) / "autotune_cache_torch.json"
    prev_env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache_file)
    render_cache_clear()
    build.reset_launches()
    expect = {"frames": 0, "stats_passes": 0}   # what the launches must add up to
    try:
        # -- the frame: the smallest span at which the main triple cuts nothing
        scene, cam = scene_and_camera("train", gaussians, width, height, device=dev)
        frame, probes, span = "main", [], None
        for sp in spans:
            cfg = RenderConfig(backend="cuda", **{**CFG_KW, "span": sp,
                                                  "group_capacity": group_capacity})
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            try:
                s, secs = wall(lambda c=cfg: stats_pass(scene, cam, c))
            except torch.cuda.OutOfMemoryError as e:
                probes.append({"span": sp, "oom": str(e)[:200]})
                break
            expect["stats_passes"] += 1
            probes.append({"span": sp, "overflow": int(s.overflow),
                           "span_overflow": int(s.span_overflow),
                           "n_candidate_tests": int(s.n_candidate_tests),
                           "n_pairs_sort": int(s.n_pairs_sort), "s": secs,
                           "max_memory_allocated_gb": peak_gb()})
            if int(s.overflow) + int(s.span_overflow) == 0:
                span = sp
                break
        if span is None:
            # No span fits on the card: tune the lossless phase's frame.
            frame, span = "lossless", CFG_KW["span"]
            extent = PAPER_SCENES["train"].extent
            scene = scene_like_paper("train", lossless_gaussians, device=dev)
            cam = make_camera((0.0, extent * 0.7, extent * 3.0), (0, 0, 0), width, height,
                              fov_x_deg=62.0)
        base = RenderConfig(backend="cuda", **{**CFG_KW, "span": span,
                                               "group_capacity": group_capacity})
        main_triple = (base.tile, base.group, base.tile_capacity)
        emit({"phase": "autotune", "check": "span_probe", "nvidia_smi": smi,
              "frame": frame, "gaussians": scene.num_gaussians, "triple": main_triple,
              "group_capacity": group_capacity, "probes": probes, "span": span})

        # -- 1. sweep: every feasible point measured, no cache written ---------
        res, sweep_s = wall(lambda: sweep(scene, cam, base, device=dev, warmup=1,
                                          reps=AUTOTUNE_REPS, **grid))
        traj = res.trajectory
        feasible = [e for e in traj if e["feasible"]]
        statted = [e for e in traj if e["reason"] != "member_tiles"]
        expect["stats_passes"] += len(statted)
        expect["frames"] += len(feasible) * (1 + AUTOTUNE_REPS)
        after_sweep = dict(build.LAUNCHES)

        def knobs(e):
            return (e["tile"], e["group"], e["tile_capacity"])

        longest = {str(knobs(e)): list_max(scene, cam, config_for(base, Candidate(*knobs(e))))
                   for e in statted}
        expect["stats_passes"] += len(statted)      # one BGM launch each
        by_model = [knobs(e) for e in sorted(feasible, key=lambda e: e["est_total_s"])]
        by_card = [knobs(e) for e in sorted(feasible, key=lambda e: e["measured_ms"])]
        measured = {knobs(e): e["measured_ms"] for e in feasible}
        emit({"phase": "autotune", "check": "sweep", "grid": grid, "base_config": {
                  **CFG_KW, "span": span, "group_capacity": group_capacity},
              "trajectory": [{k: e[k] for k in (
                  "tile", "group", "tile_capacity", "feasible", "reason", "est_total_s",
                  "n_pairs_sort", "tile_entries", "overflow", "measured_ms")} for e in traj],
              "winner": list(res.candidate.as_dict().values()),
              "winner_frame_ms": res.measured_ms,
              "list_max": longest,
              "main_triple_frame_ms": measured.get(main_triple),
              "model_order": by_model, "card_order": by_card,
              "model_best_card_rank": by_card.index(by_model[0]) + 1 if by_model else None,
              "card_best_model_rank": by_model.index(by_card[0]) + 1 if by_card else None,
              "sweep_s": sweep_s})
        gf_over = [e for e in traj
                   if (e["group"] // e["tile"]) ** 2 > 32]
        check(any(knobs(e) == main_triple for e in feasible),
              f"autotune: the main triple {main_triple} is not a feasible grid point")
        check(any(e["tile"] != base.tile for e in feasible),
              "autotune: no feasible candidate at another tile")
        check(any(e["group"] != base.group for e in feasible),
              "autotune: no feasible candidate at another group")
        check(gf_over and all(not e["feasible"] and e["reason"] == "member_tiles"
                              and e["est"] is None for e in gf_over),
              f"autotune: a candidate past 32 member tiles was not refused: {gf_over}")
        check(res.measured_ms <= min(measured.values()),
              "autotune: the sweep's winner is not its measured minimum")
        check(memory_entries() == 0 and not cache_file.exists(),
              "autotune: the sweep wrote the cache")

        # -- 2./3. the search: top 3 by the model, measured, verified ----------
        tuned_res, search_s = wall(lambda: autotune(
            scene, cam, base, device=dev, top_k=AUTOTUNE_TOP_K, warmup=1,
            reps=AUTOTUNE_REPS, verify=True, **grid))
        survivors = [e for e in tuned_res.trajectory if e["measured_ms"] is not None]
        expect["stats_passes"] += len(statted)
        expect["frames"] += len(survivors) * (1 + AUTOTUNE_REPS) + 2   # + verify's two
        hit_res, hit_s = wall(lambda: autotune(scene, cam, base, device=dev, **grid))
        emit({"phase": "autotune", "check": "search", "source": tuned_res.source,
              "winner": list(tuned_res.candidate.as_dict().values()),
              "measured_ms": tuned_res.measured_ms,
              "survivors": {str(knobs(e)): e["measured_ms"] for e in survivors},
              "verified": True, "search_s": search_s, "cache_hit_s": hit_s,
              "cache_hit_source": hit_res.source})
        check(tuned_res.source == "search" and len(survivors) == min(AUTOTUNE_TOP_K,
                                                                     len(feasible)),
              f"autotune: the search measured {len(survivors)} survivors")
        check(tuned_res.measured_ms <= min(e["measured_ms"] for e in survivors),
              "autotune: the winner is not the fastest survivor it measured")
        check(hit_res.source == "cache" and hit_res.candidate == tuned_res.candidate,
              f"autotune: a second search did not hit the cache ({hit_res.source})")

        # -- 4./5. engine.open(tile_params='auto'), cold, cached, from the file --
        render_cache_clear()
        cache_file.unlink()
        opts = dict(grid, top_k=AUTOTUNE_TOP_K, warmup=1, reps=AUTOTUNE_REPS)
        sig = autotune_signature(scene, width, height, base, dev)
        with engine.open(scene, base, device=dev, tile_params="auto",
                         autotune_opts=opts) as ra:
            auto, cold_s = wall(lambda: ra.render(cam))
            tuned = ra.tile_params
            expect["stats_passes"] += len(statted)
            expect["frames"] += min(AUTOTUNE_TOP_K, len(feasible)) * (1 + AUTOTUNE_REPS) + 1
            with engine.open(scene, base, device=dev, tile_params=tuned) as rf:
                fixed = rf.render(cam)
                fixed_ms = [wall(lambda: rf.render(cam))[1] * 1e3 for _ in range(AUTOTUNE_REPS)]
            before = dict(build.LAUNCHES)
            with engine.open(scene, base, device=dev, tile_params="auto",
                             autotune_opts=opts) as rc:
                cached, cached_s = wall(lambda: rc.render(cam))
                cached_tuned = rc.tile_params
            cached_passes = (build.LAUNCHES["bitmask_gen"] - before["bitmask_gen"]
                             - build.LAUNCHES["raster_group_fused"]
                             + before["raster_group_fused"])
            expect["frames"] += 2 + AUTOTUNE_REPS
        memory_after_close = memory_entries()
        with engine.open(scene, base, device=dev, tile_params="auto",
                         autotune_opts=opts) as rd:
            reopened = rd.render(cam)
            reopen_source = (lookup(sig) or {}).get("source")
        expect["frames"] += 1
        bitwise = {
            "auto_vs_fixed": bool(torch.equal(auto.image, fixed.image))
            and auto.stats.as_dict() == fixed.stats.as_dict(),
            "cached_vs_fixed": bool(torch.equal(cached.image, fixed.image)),
            "reopened_vs_fixed": bool(torch.equal(reopened.image, fixed.image)),
        }
        emit({"phase": "autotune", "check": "auto", "tile_params": tuned,
              "bitwise": bitwise, "cold_first_render_s": cold_s,
              "cached_first_render_s": cached_s, "fixed_frame_ms": fixed_ms,
              "cached_stats_passes": cached_passes, "cached_tile_params": cached_tuned,
              "memory_entries_after_close": memory_after_close,
              "file_after_close": cache_file.exists(), "reopen_source": reopen_source})
        check(all(bitwise.values()), f"autotune: 'auto' differs from the fixed winner {bitwise}")
        check(cached_passes == 0 and cached_tuned == tuned,
              f"autotune: a second 'auto' open ran {cached_passes} stats passes")
        check(memory_after_close == 0 and cache_file.exists() and reopen_source == "disk",
              f"autotune: after close memory {memory_after_close}, file "
              f"{cache_file.exists()}, re-open source {reopen_source}")
        del auto, cached, reopened

        # -- 6. RenderServer(autotune=True): two requests, bitwise render ------
        cams = eval_cameras(PAPER_SCENES["train"].extent, BATCH_AZIMUTHS_DEG[:2], width,
                            height) if frame == "main" else [cam, cam]
        with RenderServer({"train": scene}, device=dev, autotune=True, autotune_opts=opts,
                          max_batch=2, max_wait=60.0) as server:
            served = server.run([(0.0, RenderRequest(i, "train", c, base))
                                 for i, c in enumerate(cams)], realtime=False)
            served_tuned = server.commit("train", base).tile_params
            summary = server.stats.summary()
        with engine.open(scene, base, device=dev, tile_params=served_tuned) as rf:
            served_bitwise = [bool(torch.equal(served[i].image, rf.render(c).image.cpu()))
                              for i, c in enumerate(cams)]
        expect["frames"] += summary["completed"] + summary["padded"] + len(cams)
        emit({"phase": "autotune", "check": "server", "tile_params": served_tuned,
              "bitwise_vs_render": served_bitwise})
        check(len(served) == len(cams) and all(served_bitwise),
              f"autotune: served images differ from render: {served_bitwise}")
        check(served_tuned == tuned, f"autotune: the server tuned {served_tuned}, not {tuned}")
        launches = dict(build.LAUNCHES)
        sync()
        del scene, fixed, served

        # -- 7. the one-shot CLI with --autotune, in a subprocess ---------------
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.render", "--autotune",
               "--backend", "cuda", "--device", dev.type, *AUTOTUNE_CLI]
        proc, cli_s = wall(lambda: subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                                  text=True, timeout=600))
        m = re.search(r"tile_params=\((\d+), (\d+), (\d+)\)", proc.stdout)
        emit({"phase": "autotune", "check": "cli", "cmd": " ".join(cmd[1:]),
              "returncode": proc.returncode, "tile_params": m.group(0) if m else None,
              "wall_s": cli_s, "stdout_tail": proc.stdout[-800:],
              "stderr_tail": proc.stderr[-800:]})
        check(proc.returncode == 0 and m is not None,
              f"autotune: the CLI exited {proc.returncode}: {proc.stderr[-500:]}")
    finally:
        if prev_env is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = prev_env
        render_cache_clear()
        tmp.cleanup()

    # -- 8. the BGM and the fused RM once a measured frame (the BGM also once a
    # stats pass); no other kernel
    want = {"bitmask_gen": expect["frames"] + expect["stats_passes"],
            "raster_group_fused": expect["frames"], "raster_tile": 0, "bitonic_sort": 0}
    # Frame times from the sweep, which measured every feasible point in one
    # pass: the tuned winner (top 3 by the model), the card's fastest, and
    # the main triple.
    emit({"phase": "autotune", "nvidia_smi": smi, "frame": frame, "span": span,
          "winner": tuned, "winner_frame_ms": measured.get(tuned),
          "sweep_winner": list(res.candidate.as_dict().values()),
          "sweep_winner_frame_ms": res.measured_ms,
          "main_triple_frame_ms": measured.get(main_triple),
          "search_wall_s": {"cold": search_s, "cold_through_handle": cold_s,
                            "cache_hit": hit_s, "cache_hit_through_handle": cached_s},
          "launches": launches, "expected_launches": want,
          "sweep_launches": after_sweep, "peak_mem_gb": peak_gb(),
          "phase_s": time.perf_counter() - t_phase})
    if on_card:
        check(launches == want, f"autotune: launches {launches}, expected {want}")
    return launches


def run_gateway_cli(dev, gaussians: int, width: int, height: int) -> dict:
    """The gateway CLI in a subprocess on the card: two subprocess workers
    over train and truck, w0 SIGKILLed once two requests completed, every
    result held bitwise to a parent render (--parity-check); its trace and
    metrics snapshot under build/repro_torch/."""
    out_dir = ROOT / "build" / "repro_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = [out_dir / "gateway_trace.json", out_dir / "gateway_metrics.json"]
    for f in files:
        f.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.render_gateway", "--backend", "cuda",
           "--device", dev.type, "--workers", "2", "--scenes", ",".join(GATEWAY_SCENES),
           "--gaussians", str(gaussians), "--resolutions", f"{width}x{height}",
           "--capacity", "8192", "--max-batch", "2", "--requests", str(GATEWAY_CLI_REQUESTS),
           "--kill-worker", "auto", "--kill-after", "2", "--parity-check", "--no-realtime",
           "--trace-json", str(files[0]), "--metrics-json", str(files[1])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    docs = [json.loads(f.read_text()) if f.exists() else None for f in files]
    return {"cmd": " ".join(cmd[1:]), "returncode": proc.returncode,
            "wall_s": time.perf_counter() - t, "stdout": stdout,
            "stderr_tail": stderr[-1500:], "trace": docs[0], "metrics": docs[1]}


def gateway_phase(dev, on_card, check, smi, width: int, height: int, gaussians=None,
                  cli_gaussians: int = MAIN_GAUSSIANS) -> dict:
    """The gateway tier on the card (``gaussians`` and ``cli_gaussians``
    shrink it for a rehearsal on the host): an in-process fleet of two
    workers with a deterministic failover, the gateway CLI over two
    subprocess workers with a real SIGKILL, and a checkpoint round trip of
    the train scene with an AdamW state. Returns each kernel's launches in
    the in-process run."""
    import shutil

    import torch

    from repro_torch import engine
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    from repro_torch.configs import PAPER_SCENES
    from repro_torch.core import RenderConfig, scene_like_paper
    from repro_torch.core.gaussians import GaussianScene
    from repro_torch.gateway import InprocWorker, RenderGateway
    from repro_torch.kernels import build
    from repro_torch.obs import Tracer, get_registry, set_tracer, validate_gateway_trace
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.serving import RenderRequest

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counters():
        return dict(get_registry().snapshot()["counters"])

    t_phase = time.perf_counter()
    cfg = RenderConfig(backend="cuda", **CFG_KW)
    scenes = {sid: scene_like_paper(sid, gaussians or PAPER_SCENES[sid].paper_gaussians,
                                    device=dev)
              for sid in GATEWAY_SCENES}
    cams = {sid: eval_cameras(PAPER_SCENES[sid].extent, SERVE_AZIMUTHS_DEG, width, height)
            for sid in GATEWAY_SCENES}

    # -- (a) two in-process workers, w0 killed as its first dispatch returns ---
    workers = [InprocWorker(f"w{i}", scenes, device=dev, max_batch=GATEWAY_MAX_BATCH)
               for i in range(2)]
    warm_id = -1
    for i, w in enumerate(workers):
        w.commit(GATEWAY_SCENES[i], cfg)
        for sid in GATEWAY_SCENES:
            w.dispatch([RenderRequest(warm_id, sid, cams[sid][0], cfg)])
            warm_id -= 1
    sync()
    gw = None

    class Held:
        """The worker, with every dispatch held until the gateway has routed
        the whole load: routing (load-balanced, in-flight counted) then
        cannot depend on a dispatch finishing first. ``die`` kills the
        worker as its first dispatch returns, so it still holds the rest of
        its share."""

        def __init__(self, worker, die):
            self.worker, self.die = worker, die

        def __getattr__(self, name):
            return getattr(self.worker, name)

        def dispatch(self, requests):
            deadline = time.monotonic() + 120
            while gw.counts["routed"] < GATEWAY_REQUESTS and time.monotonic() < deadline:
                time.sleep(0.001)
            out = self.worker.dispatch(requests)
            if self.die:
                self.worker.kill()
            return out

    load = [(0.0, RenderRequest(i, GATEWAY_SCENES[i % 2],
                                cams[GATEWAY_SCENES[i % 2]][(i // 2) % len(SERVE_AZIMUTHS_DEG)],
                                cfg))
            for i in range(GATEWAY_REQUESTS)]
    batches = [w.server.stats.summary()["batches"] for w in workers]
    render_s = [sum(b.render_s for b in w.server.stats.buckets.values()) for w in workers]
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    c0 = counters()
    try:
        build.reset_launches()
        gw = RenderGateway([Held(workers[0], True), Held(workers[1], False)],
                           retry_backoff_s=0.005)
        results = gw.run(load)
        launches = dict(build.LAUNCHES)
        gw_counters = {k: v - c0.get(k, 0) for k, v in counters().items()}
        doc = tracer.chrome_trace()
    finally:
        set_tracer(prev)
    summary = gw.summary()
    dispatch_s = [e.duration_s for e in tracer.events() if e.name == "gateway/dispatch"]
    server_dispatches = [w.server.stats.summary()["batches"] - b
                         for w, b in zip(workers, batches)]
    server_render_s = [sum(b.render_s for b in w.server.stats.buckets.values()) - r
                       for w, r in zip(workers, render_s)]
    gw.close()
    doc["summary"] = summary
    trace_errors = validate_gateway_trace(doc, gw_counters)
    lanes = GATEWAY_MAX_BATCH * sum(server_dispatches)
    direct = {}
    with engine.open(scenes["train"], cfg, device=dev) as h_train, \
            engine.open(scenes["truck"], cfg, device=dev) as h_truck:
        handles = {"train": h_train, "truck": h_truck}
        for _, r in load:
            key = (r.scene_id, id(r.camera))
            if key not in direct:
                direct[key] = handles[r.scene_id].render_batch(
                    [r.camera], pad_to=GATEWAY_MAX_BATCH).image[0].cpu()
    bitwise = [bool(torch.equal(results[r.request_id].image, direct[(r.scene_id, id(r.camera))]))
               for _, r in load if r.request_id in results]
    retried = sorted(rid for rid, r in results.items() if r.attempts > 1)
    emit({"phase": "gateway", "check": "inproc", "nvidia_smi": smi, "width": width,
          "height": height, "scenes": {k: s.num_gaussians for k, s in scenes.items()},
          "config": CFG_KW, "max_batch": GATEWAY_MAX_BATCH, "requests": len(load),
          "completed": summary["completed"], "failed": summary["failed"],
          "retries": summary["retries"], "failovers": summary["failovers"],
          "recommits": summary["recommits"], "retried": retried,
          "retried_on": sorted({results[rid].worker_id for rid in retried}),
          "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
          "req_per_s": summary["fps"], "wall_s": summary["wall_s"],
          "workers": summary["workers"],
          "gateway_dispatch_s": dispatch_s, "server_dispatches": server_dispatches,
          "server_render_s": server_render_s, "lanes_rendered": lanes,
          "launches": launches, "bitwise_vs_direct": bitwise,
          "trace_errors": trace_errors[:5]})
    check(sorted(results) == list(range(len(load))) and summary["failed"] == 0,
          f"gateway: completed {sorted(results)}, failed {summary['failed']}")
    check(summary["failovers"] >= 1 and summary["retries"] >= 1 and retried
          and all(results[rid].worker_id == "w1" for rid in retried),
          f"gateway: failovers {summary['failovers']}, retries {summary['retries']}, "
          f"retried {retried}")
    check(len(bitwise) == len(load) and all(bitwise),
          f"gateway: images differ from a direct handle's lane: {bitwise}")
    check(not trace_errors, f"gateway: trace {trace_errors[:3]}")
    if on_card:
        check(launches["bitmask_gen"] == lanes and launches["raster_group_fused"] == lanes
              and launches["raster_tile"] == 0,
              f"gateway: launched {launches} for {lanes} rendered lanes")
    for w in workers:
        w.shutdown()
    del workers, direct, results
    sync()

    # -- (b) the CLI: two subprocess workers on the card, a real SIGKILL --------
    cli = run_gateway_cli(dev, cli_gaussians, width, height)
    cli_doc, cli_snap = cli.pop("trace"), cli.pop("metrics")
    cli_errors = (["no trace or metrics written"] if cli_doc is None or cli_snap is None
                  else validate_gateway_trace(cli_doc, cli_snap["counters"]))
    cli_summary = (cli_doc or {}).get("summary", {})
    transport = cli_summary.get("transport", {})
    hist = (cli_snap or {}).get("histograms", {}).get("gateway.dispatch_s", {})
    wire = [d for t in transport.values() for d in t["dispatches"]]
    lines = cli.pop("stdout").splitlines()
    parity = [ln for ln in lines if ln.startswith("parity-check:")]
    verdict = [ln for ln in lines if ln.startswith("render_gateway:")]
    emit({"phase": "gateway", "check": "cli", "nvidia_smi": smi, **cli,
          "gaussians": cli_gaussians, "parity": parity, "verdict": verdict,
          "failovers": cli_summary.get("failovers"), "retries": cli_summary.get("retries"),
          "completed": cli_summary.get("completed"), "p50_ms": cli_summary.get("p50_ms"),
          "p99_ms": cli_summary.get("p99_ms"), "workers": cli_summary.get("workers"),
          "startup_s": {wid: t["startup_s"] for wid, t in transport.items()},
          "gateway_dispatch_s": {"count": hist.get("count"), "sum": hist.get("sum")},
          "wire_s_sum": {k: sum(d[k] for d in wire) for k in (
              "round_trip_s", "child_latency_s", "reply_wait_s", "transfer_s", "parse_s",
              "decode_s")},
          "largest_reply_bytes": max((d["line_bytes"] for d in wire), default=None),
          "wire": transport, "trace_errors": cli_errors[:5]})
    check(cli["returncode"] == 0, f"gateway: the CLI exited {cli['returncode']}: "
                                  f"{cli['stderr_tail'][-500:]}")
    n = GATEWAY_CLI_REQUESTS
    check(cli_summary.get("failovers", 0) >= 1 and len(parity) == 1
          and parity[0].startswith(f"parity-check: {n}/{n} bitwise-identical"),
          f"gateway: the CLI reported failovers {cli_summary.get('failovers')}, {parity}")
    check(not cli_errors, f"gateway: the CLI trace {cli_errors[:3]}")

    # -- (c) a checkpoint of the train scene and an AdamW state -----------------
    scene = scenes["train"]
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = GaussianScene(**{f.name: torch.randn(getattr(scene, f.name).shape, generator=gen,
                                                 device=dev)
                             for f in dataclasses.fields(GaussianScene)})
    stepped, opt = adamw_update(scene, grads, adamw_init(scene), 0, lr=1e-3)
    tree = {"scene": stepped, "opt": opt}
    ckpt_dir = ROOT / "build" / "repro_torch" / "gateway_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), async_write=False)
    sync()
    t = time.perf_counter()
    mgr.save(1, tree, extra={"scene": "train"})
    write_s = time.perf_counter() - t
    file_mb = os.path.getsize(mgr.latest().path) / 2**20
    t = time.perf_counter()
    leaves, manifest = mgr.restore(device=dev)
    sync()
    read_s = time.perf_counter() - t
    want, _ = tree_flatten(tree)
    leaf_equal = [bool(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b))
                  for a, b in zip(want, leaves)]
    restored = tree_unflatten(tree, leaves)
    with engine.open(stepped, cfg, device=dev) as h:
        img = h.render(cams["train"][0]).image
    with engine.open(restored["scene"], cfg, device=dev) as h:
        img_restored = h.render(cams["train"][0]).image
    render_equal = bool(torch.equal(img, img_restored))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "gateway", "check": "checkpoint", "nvidia_smi": smi,
          "gaussians": scene.num_gaussians, "leaves": len(leaves),
          "zstandard": ckpt_manager.zstandard is not None, "file_mb": file_mb,
          "write_s": write_s, "read_s": read_s, "leaf_bitwise": leaf_equal,
          "render_bitwise": render_equal, "manifest_treedef": manifest["treedef"],
          "phase_s": time.perf_counter() - t_phase})
    check(len(leaves) == len(want) == 15 and all(leaf_equal),
          f"gateway: checkpoint leaves differ {leaf_equal}")
    check(render_equal, "gateway: the restored scene renders differently")
    return launches


def mesh_phase(dev, on_card, check, smi, width: int, height: int, n_main: int,
               n_lossless: int) -> dict:
    """Rendering over several devices (``launch/mesh.py``), at the main
    frame and the lossless frame of this run's sizes.

    (a) Virtual meshes: ``[dev] * 4`` as (data, model) = (4, 1), (2, 2) and
    (1, 4). Each renders the batch phase's four cameras through
    ``render_batch``, bitwise (image and counters) the one-device handle's;
    a model axis commits 'psum' with ``physical_shards`` equal to it and the
    JAX formula's ``feature_mb_per_device``; the BGM and the fused RM launch
    once a lane. An ``'auto'`` open over the four virtual devices under a
    budget of 1.2 x half the full model escalates to a physical commit. A
    RenderServer over a (2, 1) mesh and a stream frame on a (2, 2) handle
    are bitwise their renders, and the lossless frame in tile_baseline on
    the (2, 2) mesh is bitwise one device's (the tile RM once). (b) A mixed
    (1, 2) mesh over ``[dev, cpu]`` on the lossless frame: shard 1's
    frontend runs on the host and the psum copies its contribution to the
    card; 'psum' and 'index' bitwise alike there, the image within 1e-4 of
    the one-card D = 2 render where the host projected shard 1 as the card
    does (counters and the differing projection elements printed: the
    host's projection may differ by ulps), and in any case bitwise the
    card's backend over the same features moved to the card. (c) With two cards or more, (a)'s meshes over distinct
    cards (not gated). Returns the launches of the (2, 2) mesh's batch and
    tile_baseline frame."""
    import torch

    from repro_torch import engine
    from repro_torch.configs import PAPER_SCENES, scene_and_camera
    from repro_torch.core import RenderConfig, make_camera, render, scene_like_paper
    from repro_torch.core.pipeline import render_backend
    from repro_torch.core.projection import ShardedProjected, projected_bytes_per_gaussian
    from repro_torch.core.stages import get_backend
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_render_mesh
    from repro_torch.serving import RenderRequest
    from repro_torch.serving.server import RenderServer
    from repro_torch.utils import pytree_bytes, tree_map

    def sync():
        if on_card:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def bitwise(out, want) -> bool:
        return bool(torch.equal(out.image.to(want.image.device), want.image)) and all(
            torch.equal(getattr(out.stats, f.name).to(want.image.device),
                        getattr(want.stats, f.name))
            for f in dataclasses.fields(out.stats))

    def batch_ms(handle, cams):
        """Median of 3 render_batch calls after a warm-up, host clock to
        synchronize every card."""
        handle.render_batch(cams)
        sync()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            handle.render_batch(cams)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    t_phase = time.perf_counter()
    spec = PAPER_SCENES["train"]
    cfg = RenderConfig(backend="cuda", **CFG_KW)
    scene, _ = scene_and_camera("train", n_main, width, height, device=dev)
    cams = eval_cameras(spec.extent, BATCH_AZIMUTHS_DEG, width, height)
    with engine.open(scene, cfg, device=dev) as one:
        want = one.render_batch(cams)
        one_ms = batch_ms(one, cams)
    n_pad = {m: -(-scene.num_gaussians // m) * m for m in (1, 2, 4)}

    def virtual_meshes(devices, shapes, gated):
        out = {}
        for data, model in shapes:
            mesh = make_render_mesh(devices[: data * model], scene_shards=model)
            name = f"{data}x{model}"
            with engine.open(scene, cfg, mesh=mesh, scene_shards=model) as h:
                build.reset_launches()
                got = h.render_batch(cams)
                sync()
                launches = dict(build.LAUNCHES)
                hs = h.stats()
                ms = batch_ms(h, cams)
            want_mb = n_pad[model] * projected_bytes_per_gaussian() / 2**20 / model
            row = {"bitwise_vs_one_device": bitwise(got, want), "batch_ms": ms,
                   "feature_gather": hs["feature_gather"],
                   "physical_shards": hs["physical_shards"],
                   "feature_mb_per_device": hs["feature_mb_per_device"],
                   "feature_mb_want": want_mb, "launches": launches}
            out[name] = row
            del got
            if not gated:
                continue
            check(row["bitwise_vs_one_device"], f"mesh: {name} batch is not bitwise one device's")
            check(row["physical_shards"] == model
                  and row["feature_gather"] == ("psum" if model > 1 else "flat"),
                  f"mesh: {name} committed {row['physical_shards']} shards, "
                  f"{row['feature_gather']}")
            check(abs(row["feature_mb_per_device"] - want_mb) <= 1e-9,
                  f"mesh: {name} feature_mb_per_device {row['feature_mb_per_device']} "
                  f"!= {want_mb}")
            check(launches["bitmask_gen"] == launches["raster_group_fused"] == len(cams),
                  f"mesh: {name} launched {launches}")
        return out

    # -- (a) virtual devices: the one card listed four times -----------------
    shapes = ((4, 1), (2, 2), (1, 4))
    virtual = virtual_meshes([dev] * 4, shapes, gated=True)
    full_mb = pytree_bytes(scene) / 2**20 + n_pad[1] * projected_bytes_per_gaussian() / 2**20
    budget = 1.2 * full_mb / 2
    with engine.open(scene, RenderConfig(backend="cuda", **CFG_KW), devices=[dev] * 4,
                     device_budget_mb=budget) as h:
        hs = h.stats()
        escalated = {"physical_shards": hs["physical_shards"],
                     "feature_gather": hs["feature_gather"], "mesh": hs["mesh"],
                     "budget_mb": budget, "frame_bitwise": bitwise(
                         h.render_batch(cams[:1]), want.map(lambda x: x[:1]))}
    check(escalated["physical_shards"] >= 2 and escalated["feature_gather"] == "psum"
          and escalated["frame_bitwise"], f"mesh: budget escalation {escalated}")
    mesh21 = make_render_mesh([dev] * 2)
    with RenderServer({"train": scene}, mesh=mesh21, max_batch=len(cams)) as server:
        served = server.run([(0.0, RenderRequest(i, "train", c, cfg))
                             for i, c in enumerate(cams)], realtime=False)
        served_summary = server.stats.summary()
    served_ok = [bool(torch.equal(served[i].image, want.image[i].cpu()))
                 for i in range(len(cams))]
    check(all(served_ok) and served_summary["batches"] == 1,
          f"mesh: RenderServer over (2, 1) {served_ok}, {served_summary['batches']} batches")
    mesh22 = make_render_mesh([dev] * 4, scene_shards=2)
    with engine.open(scene, cfg, mesh=mesh22, scene_shards=2) as h, \
            h.open_stream(speculate=False) as stream:
        frames = [stream.render(cams[0]), stream.render(cams[0])]
        stream_ok = [bitwise(f, want.map(lambda x: x[0])) for f in frames]
        stream_hits = stream.stats()["hits"]
    check(all(stream_ok) and stream_hits == 1, f"mesh: stream over (2, 2) {stream_ok}")
    del scene, frames, served

    # The lossless frame: tile_baseline over (2, 2), and the mixed mesh.
    eye_l = (0.0, spec.extent * 0.7, spec.extent * 3.0)
    cam_l = make_camera(eye_l, (0, 0, 0), width, height, fov_x_deg=62.0)
    scene_l = scene_like_paper("train", n_lossless, device=dev)
    tile_cfg = dataclasses.replace(cfg, mode="tile_baseline")
    tile_one = render(scene_l, cam_l, tile_cfg)
    with engine.open(scene_l, tile_cfg, mesh=mesh22, scene_shards=2) as h:
        build.reset_launches()
        tile_mesh = h.render(cam_l)
        sync()
        tile_launches = dict(build.LAUNCHES)
    tile_ok = bitwise(tile_mesh, tile_one)
    check(tile_ok and tile_launches["raster_tile"] == 1,
          f"mesh: tile_baseline over (2, 2) bitwise {tile_ok}, launches {tile_launches}")
    path = {k: virtual["2x2"]["launches"][k] + tile_launches[k] for k in build.LAUNCHES}

    # -- (b) a mixed mesh: the card and the host ---------------------------------
    host = torch.device("cpu")
    mixed = make_render_mesh([dev, host], scene_shards=2)
    two = dataclasses.replace(cfg, scene_shards=2)
    card_two = render(scene_l, cam_l, two)
    outs, error = {}, None
    try:
        for gather in ("psum", "index"):
            with engine.open(scene_l, dataclasses.replace(two, feature_gather=gather),
                             mesh=mixed) as h:
                t = time.perf_counter()
                outs[gather] = h.render(cam_l)
                sync()
                outs[gather + "_ms"] = (time.perf_counter() - t) * 1e3
                if gather != "psum":
                    continue
                placed = [str(h.committed_scene.shard(d).device) for d in range(2)]
                # The same features with both shards on the card: the host
                # part's gathers and copies must give the card's bits.
                front = h.render_frontend(cam_l)
                carded = dataclasses.replace(front, proj=ShardedProjected(
                    shards=tuple(tree_map(lambda x: x.to(dev), p) for p in front.proj.shards),
                    gather="psum"))
                outs["card_backend"] = render_backend(carded, cam_l, h.cfg)
                # Shard 1 projected on the card, against the host's bits.
                card_proj = get_backend("cuda").project(h.committed_scene.shard(1).to(dev),
                                                        cam_l)
                host_proj = front.proj.shards[1]
                drift = {}
                for f in dataclasses.fields(card_proj):
                    x, y = getattr(host_proj, f.name).to(dev), getattr(card_proj, f.name)
                    if x.dtype != torch.bool:
                        x, y = x.view(torch.int32), y.view(torch.int32)
                    drift[f.name] = int((x != y).sum())
                del front, carded, card_proj, host_proj
    except Exception as e:          # noqa: BLE001 — reported and gated below
        error = f"{type(e).__name__}: {e}"
    mixed_row = {"error": error}
    if error is None:
        psum, index = outs["psum"], outs["index"]
        mixed_row.update({
            "shard_devices": placed, "image_device": str(psum.image.device),
            "psum_bitwise_index": bitwise(psum, index),
            "bitwise_vs_card_backend_same_features": bitwise(psum, outs["card_backend"]),
            "host_vs_card_projection_differing_elements": drift,
            "max_abs_vs_one_card_d2": float((psum.image - card_two.image).abs().max()),
            "frame_ms": {"psum": outs["psum_ms"], "index": outs["index_ms"]},
            "counters_mixed": psum.stats.as_dict(),
            "counters_one_card_d2": card_two.stats.as_dict(),
        })
        mixed_row["counters_differ"] = sorted(
            k for k, v in mixed_row["counters_mixed"].items()
            if v != mixed_row["counters_one_card_d2"][k])
    check(error is None, f"mesh: mixed (1, 2) mesh raised {error}")
    if error is None:
        check(mixed_row["psum_bitwise_index"], "mesh: mixed mesh psum and index differ")
        check(mixed_row["bitwise_vs_card_backend_same_features"],
              "mesh: mixed mesh image is not the card's backend over the same features")
        # Against one card's D = 2 frame the host's projection drift (ulps,
        # ROADMAP queue 3) can move an alpha across 1/255; only where the
        # host projected shard 1 bit for bit as the card does must the image
        # hold 1e-4.
        drifted = sum(drift.values()) > 0
        check(drifted or mixed_row["max_abs_vs_one_card_d2"] <= IMAGE_TOL,
              f"mesh: mixed mesh image {mixed_row['max_abs_vs_one_card_d2']} from one card's "
              f"with no projection drift")

    # -- (c) several cards, where the machine has them ----------------------------
    n_cards = torch.cuda.device_count() if on_card else 0
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4))]
        multi_note = f"{len(cards)} cards"
        try:                    # reported, never gated
            scene, _ = scene_and_camera("train", n_main, width, height, device=dev)
            multi = virtual_meshes(cards, shapes if len(cards) == 4 else ((2, 1), (1, 2)),
                                   gated=False)
            del scene
        except Exception as e:  # noqa: BLE001
            multi = {"error": f"{type(e).__name__}: {e}"}
    else:
        multi, multi_note = None, (f"did not run: {n_cards} card(s) visible; "
                                   f"peer copies between cards are unverified")
    emit({"phase": "mesh", "nvidia_smi": smi, "gaussians": n_main,
          "lossless_gaussians": n_lossless, "width": width, "height": height,
          "note": "virtual devices share one card: their batch_ms are not multi-card numbers",
          "one_device_batch_ms": one_ms, "virtual": virtual, "escalation": escalated,
          "server_2x1": {"bitwise": served_ok, "batches": served_summary["batches"],
                         "padded": served_summary["padded"]},
          "stream_2x2": {"bitwise": stream_ok, "hits": stream_hits},
          "tile_baseline_2x2": {"bitwise": tile_ok, "launches": tile_launches},
          "mixed_1x2": mixed_row, "multi_card": multi, "multi_card_note": multi_note,
          "launches_2x2": path, "phase_s": time.perf_counter() - t_phase})
    return path


def submit_breakdown(events) -> dict:
    """The handle's request spans of one set of submits, in ms per request
    (request order): queue (enqueue to bucket), batch wait (bucket to
    dispatch: the scheduler's hold and the worker's 10 ms poll), device
    (dispatch to the results on the host: render_batch and the host copy
    of the stacked lanes) and resolve; and the worker's engine/dispatch."""
    phases = {"request/queue": "queue_ms", "request/batch_wait": "batch_wait_ms",
              "request/device": "device_and_copy_ms", "request/resolve": "resolve_ms",
              "request": "total_ms"}
    out = {v: {} for v in phases.values()}
    for e in events:
        if e.category == "request" and e.name in phases:
            out[phases[e.name]][e.args["request_id"]] = e.duration_s * 1e3
    out = {k: [v[r] for r in sorted(v, key=lambda r: int(r.split("#")[1]))]
           for k, v in out.items()}
    out["dispatch_ms"] = [e.duration_s * 1e3 for e in events if e.name == "engine/dispatch"]
    return out


def stage_breakdown(events) -> dict:
    """The tracer's stage spans frame by frame: each ``stage/render``
    umbrella and the stage spans on its lane inside it. Returns each stage
    name's median ms (its spans summed within a frame), the sum of those
    medians, the umbrella's median, the glue (umbrella minus the sum of its
    stages, median over frames) and each name's spans per frame."""
    stages = [e for e in events if e.category == "stage" and e.name != "stage/render"]
    per_name, umbrella, glue, counts = {}, [], [], {}
    for u in (e for e in events if e.name == "stage/render"):
        inside = [e for e in stages if e.tid == u.tid and u.t0 <= e.t0 and e.t1 <= u.t1]
        sums = {}
        for e in inside:
            sums[e.name] = sums.get(e.name, 0.0) + e.duration_s * 1e3
            counts.setdefault(e.name, set()).add(sum(x.name == e.name for x in inside))
        for name, ms in sums.items():
            per_name.setdefault(name, []).append(ms)
        umbrella.append(u.duration_s * 1e3)
        glue.append(u.duration_s * 1e3 - sum(sums.values()))
    medians = {k: statistics.median(v) for k, v in per_name.items()}
    return {"frames": len(umbrella), "stage_ms_median": medians,
            "stage_sum_ms": sum(medians.values()),
            "umbrella_ms_median": statistics.median(umbrella) if umbrella else None,
            "glue_ms_median": statistics.median(glue) if glue else None,
            "glue_ms": glue, "spans_per_frame": {k: sorted(v) for k, v in counts.items()}}


def busy_share(on_card, fn, frames: int = 3, trace: str = "frame_profile.json") -> dict:
    """``frames`` calls of ``fn`` (a frame, ending in a synchronize) under
    torch.profiler, each in its own range: per frame, the union of the
    device's kernel, copy and memset intervals inside the frame's host-clock
    span, over that span. Returns the median frame's numbers and each
    frame's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not on_card:
        return {"busy_share": None, "note": "not measured: no card"}
    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            with record_function(f"chip_smoke/frame{i}"):
                fn()
                torch.cuda.synchronize()
    path = ROOT / "build" / "repro_torch" / trace
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    rows = []
    for i in range(frames):
        (frame,) = [e for e in events if e.get("name") == f"chip_smoke/frame{i}"
                    and e.get("cat") == "user_annotation"]
        f0, f1 = float(frame["ts"]), float(frame["ts"]) + float(frame["dur"])
        spans = sorted((max(a, f0), min(b, f1)) for a, b in device if min(b, f1) > max(a, f0))
        busy, end = 0.0, f0
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        rows.append({"busy_share": busy / (f1 - f0), "busy_ms": busy / 1e3,
                     "frame_ms": (f1 - f0) / 1e3, "device_ops": len(spans)})
    rows.sort(key=lambda r: r["busy_share"])
    return {**rows[frames // 2], "busy_share_each": [r["busy_share"] for r in rows]}


def run_cli(dev, width: int, height: int) -> dict:
    """The one-shot render CLI in a subprocess (as a user runs it) at the
    main frame's size; its exit code, printed counters and trace."""
    trace = Path("build/repro_torch/render_trace.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.render", "--scene", "train",
           "--backend", "cuda", "--device", dev.type, "--width", str(width),
           "--height", str(height), "--capacity", str(CLI_CAPACITY), "--stats",
           "--trace-json", str(trace)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    printed = {}
    for line, key in (("visible gaussians", "n_visible"), ("sort keys", "n_pairs_sort"),
                      ("alpha ops", "alpha_ops"), ("overflow", "overflow")):
        m = re.search(rf"{line}\s*: (\d+)", proc.stdout)
        printed[key] = int(m.group(1)) if m else None
    doc = json.loads((ROOT / trace).read_text()) if (ROOT / trace).exists() else None
    return {"cmd": " ".join(cmd[1:]), "returncode": proc.returncode, "printed": printed,
            "stdout": proc.stdout, "stderr_tail": proc.stderr[-2000:], "trace": doc,
            "wall_s": time.perf_counter() - t}


def timed_phase(dev, on_card, check, smi, cfg, scene, cam, cams, main_one, d2_one, batch_one,
                scene_l, cam_l, lossless_base, width, height) -> None:
    """RenderConfig(timing=True) against this run's untimed frames: the main
    frame (``main_one``), the sharded phase's D = 2 frame (``d2_one``), the
    batch phase's lanes (``batch_one``) and the lossless tile_baseline frame
    (``lossless_base``); then the busy share and the CLI."""
    import torch

    from repro_torch import engine
    from repro_torch.configs import scene_and_camera
    from repro_torch.core import RenderConfig, render
    from repro_torch.kernels import build
    from repro_torch.obs import Tracer, set_tracer, validate_chrome_trace

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def bitwise(out, want) -> bool:
        return bool(torch.equal(out.image, want.image)) and all(
            torch.equal(getattr(out.stats, f.name), getattr(want.stats, f.name))
            for f in dataclasses.fields(out.stats))

    t_phase = time.perf_counter()
    timed = dataclasses.replace(cfg, timing=True)
    tracer = Tracer(enabled=False)       # stage spans are forced: timing is the opt-in
    prev = set_tracer(tracer)
    same = {}
    try:
        # The main frame: one warm render, then REPS measured.
        with engine.open(scene, timed, device=dev) as h:
            h.render(cam)
            tracer.clear()
            build.reset_launches()
            outs = [h.render(cam) for _ in range(REPS)]
            sync()
            launches = dict(build.LAUNCHES)
        same["main"] = all(bitwise(o, main_one) for o in outs)
        del outs
        main_events = tracer.events()
        main_errors = validate_chrome_trace(tracer.chrome_trace())
        names = {e.name for e in main_events}
        main = stage_breakdown(main_events)
        # The untimed frame, in this phase: host clock to synchronize.
        with engine.open(scene, cfg, device=dev) as h:
            h.render(cam)
            sync()
            untimed = []
            for _ in range(REPS):
                t = time.perf_counter()
                h.render(cam)
                sync()
                untimed.append((time.perf_counter() - t) * 1e3)
            busy = busy_share(on_card, lambda: (h.render(cam), sync()))

        # D = 2: REPS frames after a warm one.
        with engine.open(scene, timed, device=dev, scene_shards=2) as h:
            h.render(cam)
            tracer.clear()
            same["D2"] = all([bitwise(h.render(cam), d2_one) for _ in range(REPS)])
            d2 = stage_breakdown(tracer.events())
            d2_errors = validate_chrome_trace(tracer.chrome_trace())

        # render_batch of the batch phase's cameras.
        with engine.open(scene, timed, device=dev) as h:
            same["render_batch"] = bitwise(h.render_batch(cams, pad_to=len(cams)), batch_one)

        # The lossless tile_baseline frame: the tile RM under timing.
        base_cfg = dataclasses.replace(timed, mode="tile_baseline")
        render(scene_l, cam_l, base_cfg)
        tracer.clear()
        build.reset_launches()
        same["lossless_tile_baseline"] = bitwise(render(scene_l, cam_l, base_cfg),
                                                 lossless_base)
        sync()
        tile_launches = dict(build.LAUNCHES)
        tile_names = {e.name for e in tracer.events()}
    finally:
        set_tracer(prev)

    # The one-shot CLI, and the same render in process at its config.
    cli = run_cli(dev, width, height)
    cli_scene, cli_cam = scene_and_camera("train", None, width, height, device=dev)
    cli_cfg = RenderConfig(mode="gstg", tile=16, group=64, boundary_group="ellipse",
                           boundary_tile="ellipse", tile_capacity=CLI_CAPACITY,
                           group_capacity=CLI_CAPACITY, span=6, backend="cuda")
    with engine.open(cli_scene, cli_cfg, device=dev) as h:
        want = h.render(cli_cam).stats.as_dict()
    cli_want = {k: want[k] for k in cli["printed"]}
    cli_doc = cli.pop("trace")
    cli_errors = validate_chrome_trace(cli_doc) if cli_doc else ["no trace written"]
    cli_stages = sorted({e["name"] for e in (cli_doc or {}).get("traceEvents", [])
                         if e.get("cat") == "stage"})
    stdout = cli.pop("stdout")
    del cli_scene

    emit({"phase": "timed", "nvidia_smi": smi, "gaussians": scene.num_gaussians,
          "width": width, "height": height, "config": CFG_KW, "backend": cfg.backend,
          "bitwise_vs_untimed": same, "launches_per_frame": {
              k: launches[k] / REPS for k in ("bitmask_gen", "raster_group_fused")},
          "main": main, "untimed_frame_ms_median": statistics.median(untimed),
          "untimed_frame_ms": untimed, "trace_errors": main_errors[:5], "D2": d2,
          "D2_trace_errors": d2_errors[:5], "tile_baseline_launches": tile_launches,
          "device_busy": busy, "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "timed", "check": "cli", **cli, "in_process": cli_want,
          "trace_errors": cli_errors[:5], "stage_spans": cli_stages,
          "stdout_tail": stdout[-3000:]})
    for what, ok in same.items():
        check(ok, f"timed: {what} is not bitwise equal to the untimed render")
    check(set(STAGE_SPANS) <= names, f"timed: stage spans {sorted(names)}")
    check(not main_errors and not d2_errors,
          f"timed: the traces do not validate: {main_errors[:3]} {d2_errors[:3]}")
    check(main["frames"] == REPS, f"timed: {main['frames']} umbrellas for {REPS} frames")
    check(all(launches[k] == REPS for k in ("bitmask_gen", "raster_group_fused")),
          f"timed: {REPS} frames launched {launches}")
    check(d2["frames"] == REPS and d2["spans_per_frame"].get("stage/merge") == [1]
          and all(d2["spans_per_frame"].get(f"stage/{s}") == [2]
                  for s in ("project", "identify", "bin")),
          f"timed: D = 2 spans per frame {d2['spans_per_frame']}")
    check(tile_launches["raster_tile"] == 1 and "stage/rasterize" in tile_names,
          f"timed: the tile_baseline frame launched {tile_launches}")
    check(not on_card or (busy["device_ops"] > 0 and 0 < busy["busy_share"] <= 1),
          f"timed: no device activity in the profiled frame: {busy}")
    check(cli["returncode"] == 0, f"timed: the CLI exited {cli['returncode']}: "
                                  f"{cli['stderr_tail'][-500:]}")
    check(cli["printed"] == cli_want,
          f"timed: CLI counters {cli['printed']} != in-process {cli_want}")
    check(not cli_errors and len(cli_stages) >= 7,
          f"timed: CLI trace errors {cli_errors[:3]}, stage spans {cli_stages}")


# The lm phase: the LM serving path (models/*, launch/serve.py) at full width.
LM_SERVE = dict(arch="granite-3-2b", batch=8, prompt_len=64, gen_len=64)
LM_SMALL = (dict(arch="mamba2-370m", batch=4, prompt_len=16, gen_len=16),
            dict(arch="granite-moe-1b-a400m", batch=4, prompt_len=16, gen_len=16))
LM_F32_PROMPTS, LM_F32_POSITIONS = 2, 32
LM_SMOKE_STEPS = 8
LM_DECODE_VS_FORWARD = 2e-3   # the JAX package's own bound (test_models_attention.py)
LM_CARD_VS_HOST = 1e-4


def lm_teacher_forced(cfg, params, tokens):
    """Logits (B, T, V) of ``tokens`` (B, T) stepped through decode_step by
    the serve loop (``generate`` with nothing to generate)."""
    import torch

    from repro_torch.launch.serve import generate

    logits = []
    generate(cfg, params, tokens, 0, on_step=lambda phase, pos, lg, nxt: logits.append(lg))
    return torch.stack(logits, dim=1)


def lm_forward_batch(cfg, tokens):
    """forward's batch for text ``tokens``: a vision stub gets no patches,
    so that its positions are decode_step's."""
    import torch

    batch = {"tokens": tokens}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.zeros(tokens.shape[0], 0, cfg.d_model,
                                            device=tokens.device)
    return batch


def lm_serve_run(dev, on_card, check, smi, cfg, batch, prompt_len, gen_len, seed=0,
                 profile=False) -> dict:
    """``cfg`` served through the serve loop (launch/serve.py::generate) at
    ``batch`` x (``prompt_len`` + ``gen_len``), after a short warm-up run:
    each step's time (CUDA events between steps), tok/s, peak memory and
    the step's bound (the weights and the cache read once over the memory
    rate). Gates: finite logits, every token inside the vocab. With
    ``profile``, one more decode step under torch.profiler: its kernels,
    their device time and the device's busy share of the step."""
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.models import build_cache_spec, build_param_spec, decode_step, init_cache
    from repro_torch.models.spec import init_from_spec, spec_bytes

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_from_spec(build_param_spec(cfg), gen, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev)
    init_s = time.perf_counter() - t_phase
    generate(cfg, params, prompts[:, :2], 2)                     # warm-up

    marks, finite = [], []

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def on_step(phase, pos, logits, nxt):
        marks.append((phase, mark()))
        finite.append(torch.isfinite(logits).all())

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    start = mark()
    tokens = generate(cfg, params, prompts, gen_len, on_step=on_step)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = {"prefill": [], "decode": []}
    prev = start
    for phase, m in marks:
        step_ms[phase].append(prev.elapsed_time(m) if on_card else (m - prev) * 1e3)
        prev = m
    weight_bytes = spec_bytes(build_param_spec(cfg))
    cache_bytes = spec_bytes(build_cache_spec(cfg, batch, prompt_len + gen_len))
    decode_ms = statistics.median(step_ms["decode"])
    out = {
        "phase": "lm", "check": "serve", "arch": cfg.name, "nvidia_smi": smi,
        "dtype": cfg.param_dtype, "params": cfg.param_count(), "weight_gb": weight_bytes / 1e9,
        "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
        "tokens_shape": list(tokens.shape), "init_s": init_s,
        "prefill_step_ms_median": statistics.median(step_ms["prefill"]),
        "decode_step_ms_median": decode_ms,
        "decode_step_ms_min": min(step_ms["decode"]),
        "decode_step_ms_max": max(step_ms["decode"]),
        "wall_s": wall, "tok_s_incl_prefill": batch * tokens.shape[1] / wall,
        "decode_tok_s": batch / decode_ms * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "bound_ms": (weight_bytes + cache_bytes) / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "bound_weights_ms": weight_bytes / PEAK_BYTES * 1e3, "cache_gb": cache_bytes / 1e9,
    }
    if profile:
        cache = init_cache(cfg, batch, prompt_len + gen_len, dev)

        def step():
            decode_step(cfg, params, cache, prompts[:, 0], 0)

        out["decode_step_profile"] = profile_step(on_card, step, top=8)
        out["decode_step_busy"] = busy_share(on_card, step, trace="lm_decode_profile.json")
    emit(out)
    check(bool(torch.stack(finite).all()), f"lm: {cfg.name} served a non-finite logit")
    check(tuple(tokens.shape) == (batch, gen_len) and bool((tokens >= 0).all())
          and bool((tokens < cfg.vocab).all()),
          f"lm: {cfg.name} tokens of shape {tuple(tokens.shape)} or outside the vocab")
    return out


def lm_phase(dev, on_card, check, smi, full: bool = True) -> dict:
    """The LM serving path (models/*, launch/serve.py). (a) granite-3-2b at
    full width and depth in bf16 served at batch 8, prompt 64, gen 64; (b)
    the same model in float32, 32 teacher-forced positions of 2 prompts
    through decode_step against forward (2e-3); (c) mamba2-370m and
    granite-moe-1b-a400m at full width in bf16, batch 4, prompt 16, gen 16;
    (d) the smoke config of every decoder in float32 on the card and on the
    host from the same weights: 8 teacher-forced steps within 1e-4 of the
    host's logits and 2e-3 of the card's forward. ``full=False`` (a
    rehearsal on the host) serves the smoke configs in (a)-(c). Returns the
    kernels' launches over the phase (none of them is on this path)."""
    import torch

    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.models import build_param_spec, forward
    from repro_torch.models.spec import init_from_spec
    from repro_torch.utils import tree_map

    get = get_config if full else get_smoke_config
    t_phase = time.perf_counter()
    build.reset_launches()

    # (a) granite-3-2b, bf16, batch 8 x (64 + 64)
    run = dict(LM_SERVE)
    lm_serve_run(dev, on_card, check, smi, get(run.pop("arch")), **run, profile=True)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # (b) the same model in float32: decode_step against forward
    cfg32 = dataclasses.replace(get(LM_SERVE["arch"]), param_dtype="float32",
                                activation_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_from_spec(build_param_spec(cfg32), gen, dev)
    toks = torch.randint(0, cfg32.vocab, (LM_F32_PROMPTS, LM_F32_POSITIONS), generator=gen,
                         device=dev)
    dec = lm_teacher_forced(cfg32, params, toks)
    full_logits, _ = forward(cfg32, params, {"tokens": toks})
    err = float((dec - full_logits).abs().max())
    emit({"phase": "lm", "check": "f32_decode_vs_forward", "arch": cfg32.name,
          "nvidia_smi": smi, "params": cfg32.param_count(), "prompts": LM_F32_PROMPTS,
          "positions": LM_F32_POSITIONS, "max_abs_err": err,
          "max_abs_logit": float(full_logits.abs().max()), "tol": LM_DECODE_VS_FORWARD,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None})
    check(err <= LM_DECODE_VS_FORWARD,
          f"lm: {cfg32.name} float32 decode {err} from forward (> {LM_DECODE_VS_FORWARD})")
    del params, dec, full_logits
    if on_card:
        torch.cuda.empty_cache()

    # (c) mamba2-370m and granite-moe-1b-a400m, bf16, batch 4 x (16 + 16)
    for run in LM_SMALL:
        run = dict(run)
        lm_serve_run(dev, on_card, check, smi, get(run.pop("arch")), **run)
        if on_card:
            torch.cuda.empty_cache()

    # (d) every decoder's smoke config, float32, card against host
    host = torch.device("cpu")
    for arch in sorted(ARCHS):
        cfg = get_smoke_config(arch)
        if cfg.family == "encoder":
            continue
        params_h = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(2), host)
        toks_h = torch.randint(0, cfg.vocab, (2, LM_SMOKE_STEPS),
                               generator=torch.Generator().manual_seed(3))
        params_d = tree_map(lambda x: x.to(dev), params_h)
        toks_d = toks_h.to(dev)
        dec_d = lm_teacher_forced(cfg, params_d, toks_d)
        dec_h = lm_teacher_forced(cfg, params_h, toks_h)
        fwd_d, _ = forward(cfg, params_d, lm_forward_batch(cfg, toks_d))
        vs_host = float((dec_d.cpu() - dec_h).abs().max())
        vs_fwd = float((dec_d - fwd_d).abs().max())
        emit({"phase": "lm", "check": "smoke_card_vs_host", "arch": arch,
              "steps": LM_SMOKE_STEPS, "card_vs_host": vs_host, "decode_vs_forward": vs_fwd,
              "max_abs_logit": float(dec_h.abs().max())})
        check(vs_host <= LM_CARD_VS_HOST,
              f"lm: {arch} smoke decode on the card {vs_host} from the host's")
        check(vs_fwd <= LM_DECODE_VS_FORWARD,
              f"lm: {arch} smoke decode {vs_fwd} from the card's forward")

    launches = dict(build.LAUNCHES)
    emit({"phase": "lm", "check": "phase", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    check(not any(launches.values()), f"lm: a GS-TG kernel launched on the LM path: {launches}")
    return launches


# The lm_train phase: the LM training path (launch/steps.py, launch/train.py).
# Only granite-3-2b's step is profiled (its busy share); the profiler's
# processing of a 30,000-70,000-kernel step costs 20-50 s, so the other two
# count their step's aten operators instead (count_ops).
LM_TRAIN = dict(arch="granite-3-2b", batch=2, seq=4096, steps=4, profile=True)
LM_TRAIN_SMALL = (dict(arch="granite-moe-1b-a400m", batch=2, seq=4096, steps=3, profile=False),
                  dict(arch="mamba2-370m", batch=2, seq=4096, steps=3, profile=False))
LM_FLASH = dict(B=2, S=1024, H=8, hd=64, chunk=256)
LM_FLASH_TOL = 5e-5       # the JAX package's own bound (tests/test_models_attention.py)
# The MoE dispatch at granite-moe-1b-a400m's train shape: batch 2 x 4,096,
# d_model 1,024, 32 experts, top-8, capacity 4,096 * 8 / 32 * 1.25.
LM_DISPATCH = dict(B=2, S=4096, D=1024, E=32, k=8, capacity=1280)
# Gradients on the card against the host's, each leaf's max-abs difference
# over its largest magnitude: cuBLAS and the CPU's BLAS sum in other orders,
# and CUDA's scatter_add_/index_add_ in no fixed order. The CPU tests measure
# up to 8.7e-6 between the port and the JAX package (mamba2's SSD).
LM_GRAD_CARD_VS_HOST = 1e-4
LM_LOSS_CARD_VS_HOST = 1e-5   # relative, as the CPU tests hold values
LM_RESUME_RTOL = 1e-5         # a resumed run's losses against straight through
LM_CLI_ARCH, LM_CLI_STEPS = "granite-3-2b", (50, 52)   # the CLI checkpoints at 50
PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor-core peak (data sheet)


def lm_train_bound(cfg, batch: int, seq: int) -> dict:
    """The least time of one train step in ms, twice.

    The port's own work (``bound_ms``): the model's matmuls (6 N T, plus
    2 N T for the remat forward; N the active parameters) at the bf16
    tensor-core rate, and attention's score and value contractions (4 B S^2
    H hd a layer forward, the same again for the remat recompute, 10 B S^2
    H hd backward) at the float32 rate: the port widens their operands to
    float32. Every kv block is computed, causal or not, as the port does.

    The work the step needs (``needed_bound_ms``): 6 N T, no remat forward,
    and attention's causal pairs only (S (S + 1) / 2 of the S^2; a forward
    of 2 contractions, a backward of 4), all at the parameters' dtype's
    tensor-core rate.

    Both: the optimizer's bytes (AdamW reads p, g, m, v and writes p, m,
    v) over the memory rate, the larger of the two times. Mamba's SSD
    contractions are not counted."""
    from repro_torch.models.spec import torch_dtype

    tokens = batch * seq
    n = cfg.active_param_count()
    remat = 2 if cfg.remat else 0
    mm_flops = (6 + remat) * n * tokens
    n_attn = sum(1 for mixer, _ in cfg.pattern if mixer == "attn") * cfg.n_units
    attn_fwd = 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim * n_attn
    attn_flops = attn_fwd * (1 + (1 if cfg.remat else 0) + 2.5)
    causal_fwd = 4 * batch * (seq * (seq + 1) // 2) * cfg.n_heads * cfg.head_dim * n_attn
    needed_flops = 6 * n * tokens + 3 * causal_fwd
    width = torch_dtype(cfg.param_dtype).itemsize
    opt_bytes = cfg.param_count() * (3 * width + 2 * 4 + 2 * 4 + width)
    mm_rate = PEAK_BF16 if cfg.param_dtype == "bfloat16" else PEAK_FP32
    t_mm = mm_flops / mm_rate * 1e3
    t_attn = attn_flops / PEAK_FP32 * 1e3
    t_needed = needed_flops / mm_rate * 1e3
    t_bytes = opt_bytes / PEAK_BYTES * 1e3
    rate = "bf16 989 TFLOP/s" if mm_rate == PEAK_BF16 else "fp32 67 TFLOP/s"
    return {"bound_ms": max(t_mm + t_attn, t_bytes),
            "bound_by": "operations" if t_mm + t_attn >= t_bytes else "bytes",
            "matmul_tflop": mm_flops / 1e12, "matmul_ms": t_mm, "matmul_rate": rate,
            "attention_tflop": attn_flops / 1e12, "attention_ms": t_attn,
            "attention_rate": "fp32 67 TFLOP/s", "optimizer_gb": opt_bytes / 1e9,
            "optimizer_bytes_ms": t_bytes,
            "needed_bound_ms": max(t_needed, t_bytes),
            "needed_bound_by": "operations" if t_needed >= t_bytes else "bytes",
            "needed_tflop": needed_flops / 1e12,
            "needed_attention_tflop": 3 * causal_fwd / 1e12, "needed_rate": rate}


def count_ops(fn) -> int:
    """The aten operators one call of ``fn`` dispatches (its forward,
    autograd's backward and the optimizer), counted by a TorchDispatchMode:
    a cheap stand-in for the profiler's kernel count (an operator may
    launch no kernel, or several)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def lm_train_run(dev, on_card, check, smi, cfg, batch, seq, steps, profile) -> dict:
    """``cfg`` trained through make_train_step (pick_optimizer's choice,
    warmup 1: step 0 is a warm-up whose rate is 0) on one repeated
    TokenStream batch: ``steps`` measured steps after it, each ending in a
    synchronize; loss and grad_norm each step, the median step ms, tok/s,
    peak memory, the step's bounds; then one more step, under
    torch.profiler (top kernels and the device's busy share) if
    ``profile``, else counting its aten operators. Gates: every loss and
    norm finite, the last loss below the first."""
    import torch

    from repro_torch.data import TokenStream, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.models import build_param_spec
    from repro_torch.models.spec import init_from_spec, spec_bytes
    from repro_torch.optim import adafactor_init, adamw_init

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = init_from_spec(build_param_spec(cfg), torch.Generator(device=dev).manual_seed(0),
                            dev)
    step_fn, optname = make_train_step(cfg, warmup=1)
    opt = adamw_init(params) if optname == "adamw" else adafactor_init(params)
    data = device_batch(make_batch(TokenStream(cfg.vocab, batch, seq, seed=0), 0, cfg.frontend,
                                   cfg.n_frontend_tokens, cfg.d_model), dev)
    sync()
    init_s = time.perf_counter() - t_phase
    t = time.perf_counter()
    step_fn(params, opt, data, 0)
    sync()
    warmup_ms = (time.perf_counter() - t) * 1e3
    losses, norms, step_ms = [], [], []
    for i in range(1, steps + 1):
        t = time.perf_counter()
        _, _, m = step_fn(params, opt, data, i)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    extra = lambda: step_fn(params, opt, data, steps + 1)
    prof = (profile_step(on_card, extra, top=10) if profile
            else {"aten_ops": count_ops(extra)})
    median_ms = statistics.median(step_ms)
    out = {"phase": "lm_train", "check": "train", "arch": cfg.name, "nvidia_smi": smi,
           "dtype": cfg.param_dtype, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "optimizer": optname,
           "remat": cfg.remat, "batch": batch, "seq": seq, "steps": steps,
           "lr": 3e-4, "warmup_steps": 1,
           "losses": losses, "grad_norms": norms, "warmup_step_ms": warmup_ms,
           "step_ms_median": median_ms, "step_ms_each": step_ms,
           "tok_s": batch * seq / median_ms * 1e3, "peak_mem_gb": peak,
           "weight_gb": spec_bytes(build_param_spec(cfg)) / 1e9, "init_s": init_s,
           **lm_train_bound(cfg, batch, seq), "step_profile": prof,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(all(math.isfinite(x) for x in losses + norms),
          f"lm_train: {cfg.name} losses {losses} or norms {norms} not finite")
    check(losses[-1] < losses[0], f"lm_train: {cfg.name} losses not falling: {losses}")
    return out


def naive_attention(q, k, v, causal: bool):
    """Full-softmax attention, (B, S, H, hd) in and out: the plain version
    autograd differentiates."""
    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def lm_flash_check(dev, on_card, check, smi, time_ms) -> list:
    """models/attention.py's flash Function (forward and backward) against
    autograd through naive_attention, float32, causal and not; then the MoE
    dispatch Function against autograd through the plain gather and
    scatter, at granite-moe-1b-a400m's train shape."""
    import torch

    from repro_torch.models import attention, moe

    rows = []
    B, S, H, hd, chunk = (LM_FLASH[k] for k in ("B", "S", "H", "hd", "chunk"))
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, w = (torch.randn(B, S, H, hd, generator=gen, device=dev) for _ in range(4))
    for causal in (True, False):
        def run(fn):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*xs)
            grads = torch.autograd.grad((out * w).sum(), xs)
            return out.detach(), grads

        flash = lambda a, b, c: attention.chunked_attention(a, b, c, causal, chunk, 0)
        plain = lambda a, b, c: naive_attention(a, b, c, causal)
        (o1, g1), (o2, g2) = run(flash), run(plain)
        errs = {"out": float((o1 - o2).abs().max())}
        errs.update({f"d{n}": float((a - b).abs().max()) for n, a, b in zip("qkv", g1, g2)})
        row = {"phase": "lm_train", "check": "flash_vs_autograd", "causal": causal,
               "nvidia_smi": smi, **LM_FLASH, "max_abs_err": errs, "tol": LM_FLASH_TOL,
               "fwd_bwd_ms": time_ms(lambda: run(flash), reps=5),
               "plain_fwd_bwd_ms": time_ms(lambda: run(plain), reps=5)}
        emit(row)
        rows.append(row)
        check(max(errs.values()) <= LM_FLASH_TOL,
              f"lm_train: flash (causal={causal}) {errs} from autograd (> {LM_FLASH_TOL})")

    Bd, Sd, D, E, kk, cap = (LM_DISPATCH[x] for x in ("B", "S", "D", "E", "k", "capacity"))
    # Skewed routing (expert e drawn with weight 1 / (e + 1)): the popular
    # experts overflow their capacity, so dropped assignments are exercised.
    weights = 1.0 / torch.arange(1, E + 1, dtype=torch.float32, device=dev)
    eid = torch.multinomial(weights, Bd * Sd * kk, replacement=True,
                            generator=gen).view(Bd, Sd * kk)
    _, keep, slot = moe.expert_slots(eid, E, cap)
    x = torch.randn(Bd, Sd, D, generator=gen, device=dev)
    wd = torch.randn(Bd, E, cap, D, generator=gen, device=dev)
    tok = torch.arange(Sd, device=dev).repeat_interleave(kk)
    index = (eid * (cap + 1) + slot)[..., None].expand(-1, -1, D)

    def dispatch(fn):
        xx = x.clone().requires_grad_(True)
        xe = fn(xx).view(Bd, E, cap + 1, D)[:, :, :cap]
        return xe.detach(), torch.autograd.grad((xe * wd).sum(), xx)[0]

    func = lambda xx: moe._Dispatch.apply(xx, eid, slot, E, cap, kk)
    plain = lambda xx: torch.zeros(Bd, E * (cap + 1), D, device=dev).scatter(1, index, xx[:, tok])
    (xe1, dx1), (xe2, dx2) = dispatch(func), dispatch(plain)
    err = float((dx1 - dx2).abs().max())
    row = {"phase": "lm_train", "check": "dispatch_vs_autograd", "nvidia_smi": smi,
           **LM_DISPATCH, "dropped": int((~keep).sum()), "forward_equal": bool(torch.equal(xe1, xe2)),
           "max_abs_err": err, "tol": LM_FLASH_TOL,
           "fwd_bwd_ms": time_ms(lambda: dispatch(func), reps=5),
           "plain_fwd_bwd_ms": time_ms(lambda: dispatch(plain), reps=5)}
    emit(row)
    rows.append(row)
    check(row["dropped"] > 0 and row["forward_equal"] and err <= LM_FLASH_TOL,
          f"lm_train: the dispatch Function {err} from autograd, forward equal "
          f"{row['forward_equal']}")
    return rows


def lm_grads(cfg, params, batch):
    """(loss, per-leaf gradients) of loss_fn, zero for a leaf the loss does
    not reach."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.utils import tree_flatten, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
    with torch.enable_grad():
        loss, _ = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def lm_train_phase(dev, on_card, check, smi, time_ms, full: bool = True) -> dict:
    """The LM training path (launch/steps.py, launch/train.py, the flash and
    dispatch Functions). (a) granite-3-2b at full width and depth in bf16,
    AdamW, remat, batch 2 x seq 4,096: 4 steps after a warm-up, and a
    profiled one; (b) granite-moe-1b-a400m and mamba2-370m likewise, 3
    steps, and one counting its operators; (c) the flash
    and dispatch Functions against autograd (5e-5); (d) every smoke config
    in float32, its loss and gradients on the card against the host's; (e)
    the train CLI resuming a checkpoint on the card, against a run straight
    through. ``full=False`` (a rehearsal on the host) trains the smoke
    configs at seq 64 in (a)-(b). Runs outside inference mode. Returns the
    kernels' launches over the phase (none of them is on this path)."""
    import shutil

    import torch

    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.kernels import build
    from repro_torch.launch.train import device_batch, train
    from repro_torch.models import build_param_spec
    from repro_torch.models.spec import init_from_spec
    from repro_torch.utils import tree_map

    get = get_config if full else get_smoke_config
    t_phase = time.perf_counter()
    build.reset_launches()

    # (a), (b): full width, bf16, batch 2 x seq 4,096
    for run in (LM_TRAIN,) + LM_TRAIN_SMALL:
        run = dict(run)
        cfg = get(run.pop("arch"))
        if not full:
            run["seq"] = 64
        lm_train_run(dev, on_card, check, smi, cfg, **run)
        if on_card:
            torch.cuda.empty_cache()

    # (c) the two Functions against autograd
    lm_flash_check(dev, on_card, check, smi, time_ms)

    # (d) every smoke config in float32, card against host
    host = torch.device("cpu")
    for arch in sorted(ARCHS):
        cfg = get_smoke_config(arch)
        params_h = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(2), host)
        batch_h = device_batch(make_batch(TokenStream(cfg.vocab, 2, 32, seed=3), 0, cfg.frontend,
                                          cfg.n_frontend_tokens, cfg.d_model), host)
        loss_h, grads_h = lm_grads(cfg, params_h, batch_h)
        loss_d, grads_d = lm_grads(cfg, tree_map(lambda x: x.to(dev), params_h),
                                   tree_map(lambda x: x.to(dev), batch_h))
        loss_rel = abs(loss_d.item() - loss_h.item()) / abs(loss_h.item())
        gaps = [float((d.cpu() - h).abs().max() / h.abs().max()) if h.abs().max() > 0
                else float(d.abs().max()) for d, h in zip(grads_d, grads_h)]
        emit({"phase": "lm_train", "check": "smoke_grads_card_vs_host", "arch": arch,
              "loss_host": loss_h.item(), "loss_rel_diff": loss_rel, "leaves": len(gaps),
              "grad_max_abs_over_max": max(gaps), "tol": LM_GRAD_CARD_VS_HOST})
        check(loss_rel <= LM_LOSS_CARD_VS_HOST and max(gaps) <= LM_GRAD_CARD_VS_HOST,
              f"lm_train: {arch} smoke loss {loss_rel} or gradients {max(gaps)} from the host's")

    # (e) the train CLI: a checkpoint at step 50, the CLI resuming it for 2
    # steps, an in-process resume, against 52 steps straight through
    work = ROOT / "build" / "repro_torch" / "lm_train_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    first, last = LM_CLI_STEPS
    kw = dict(batch=2, seq=32, device=dev, ckpt_every=first, log_every=1)
    t_cli = time.perf_counter()
    quiet = contextlib.redirect_stdout(io.StringIO())   # train() prints each step
    with quiet:
        _, straight = train(LM_CLI_ARCH, steps=last, ckpt_dir=str(work / "straight"), **kw)
        train(LM_CLI_ARCH, steps=first, ckpt_dir=str(work / "resumed"), **kw)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_CLI_ARCH,
           "--steps", str(last), "--batch", "2", "--seq", "32", "--device", dev.type,
           "--ckpt-dir", str(work / "resumed")]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=600)
    printed = {int(m.group(1)): float(m.group(2))
               for m in re.finditer(r"step\s+(\d+) loss=([0-9.]+)", proc.stdout)}
    with quiet:
        _, resumed = train(LM_CLI_ARCH, steps=last, ckpt_dir=str(work / "resumed"), **kw)
    want = {h["step"]: h["loss"] for h in straight}
    rel = max(abs(h["loss"] - want[h["step"]]) / abs(want[h["step"]]) for h in resumed)
    cli_gap = max((abs(v - want[s]) for s, v in printed.items()), default=math.inf)
    emit({"phase": "lm_train", "check": "cli_resume", "arch": LM_CLI_ARCH, "nvidia_smi": smi,
          "cmd": " ".join(cmd[1:]), "returncode": proc.returncode,
          "cli_resumed": "resumed from step 50" in proc.stdout, "cli_losses": printed,
          "straight_losses": {s: want[s] for s in range(first, last)},
          "resumed_losses": {h["step"]: h["loss"] for h in resumed},
          "resumed_rel_diff": rel, "rtol": LM_RESUME_RTOL, "cli_abs_diff": cli_gap,
          "stderr_tail": proc.stderr[-1500:], "seconds": time.perf_counter() - t_cli})
    check(proc.returncode == 0 and f"resumed from step {first}" in proc.stdout
          and sorted(printed) == [first, last - 1],
          f"lm_train: the train CLI exit {proc.returncode}, printed {printed}")
    check([h["step"] for h in resumed] == [first, last - 1] and rel <= LM_RESUME_RTOL,
          f"lm_train: resumed losses {rel} from straight through")
    # The CLI prints 4 decimals: half the last digit, plus the resume bound.
    check(cli_gap <= 5e-5 + LM_RESUME_RTOL * max(want.values()),
          f"lm_train: the CLI's printed losses {cli_gap} from straight through")

    launches = dict(build.LAUNCHES)
    emit({"phase": "lm_train", "check": "phase", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    check(not any(launches.values()),
          f"lm_train: a GS-TG kernel launched on the LM training path: {launches}")
    return launches


# The lm_mesh phase: the LM steps over a (data, model) mesh of the card listed
# four times (launch/steps.py's mesh half, sharding/policies.py's placement).
LM_MESH = dict(arch="granite-3-2b", batch=2, seq=4096, data=2, model=2, timed_steps=2)
# The mesh step's first loss and gradient norm against the one-device step
# from the same bf16 parameters and batch, relative. Measured on the H100
# (700 W): 8.45e-8 and 1.58e-5. A control step that leaves data row 1 out of
# the loss (its CE sum and its mask count: the loss is then row 0's own
# mean, which at random init is close to the whole batch's) is read against
# the same one-device step in every run, and must break one of the bounds.
LM_MESH_LOSS_RTOL = 1e-5
LM_MESH_GNORM_RTOL = 1e-3
# Every smoke config in float32 over the card mesh against one device on the
# card, at the CPU tests' bounds (tests/test_torch_lm_train.py: TOL,
# GRAD_TOL, PARAM_TOL): metrics atol/rtol 1e-5, the gradient norm rtol 1e-4,
# the parameters after two steps (below), prefill logits within 1e-5 of the
# largest, decode tokens equal.
LM_MESH_TOL = 1e-5
LM_MESH_GRAD_TOL = 1e-4
# The parameters, element by element: within LM_MESH_TOL of the leaf's own
# largest magnitude, plus what Adam makes of rounding. The mesh sums each
# gradient element's batch terms in another order, which moves it by some
# noise n; Adam divides each element by its own scale, so the element's
# steps (sum of the rates, lr) move by about lr * n / |g|: an element whose
# gradient is small takes a step that rounding moves (a zero-initialized
# bias, whose own largest magnitude is itself about lr, shows it). The bound
# takes n = LM_MESH_GRAD_NOISE times the global gradient norm and the
# smaller |g| / norm of the two steps (one device's). Read on the H100 (700
# W): the elements that broke a bound of the leaf's own magnitude alone
# (qwen's bk, jamba's conv_bx and dt_bias) imply n up to 1.2e-9 of the norm.
LM_MESH_GRAD_NOISE = 1e-8
LM_MESH_SMOKE_LR = (1e-3, 1, 10)   # rate, warm-up steps, total steps


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a nested dict's leaves, in tree_flatten's order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]


def lm_mesh_smoke(dev, check, cfg, mesh, label: str) -> dict:
    """``cfg`` (a smoke config) over ``mesh`` against one device ``dev``:
    two train steps (metrics, then the parameters), the prefill logits and
    four decode steps (tokens, then the cache)."""
    import torch

    from repro_torch.data import TokenStream, make_batch
    from repro_torch.launch import steps
    from repro_torch.launch.train import device_batch
    from repro_torch.models import build_param_spec, init_cache
    from repro_torch.models.spec import init_from_spec
    from repro_torch.optim import adamw_init, linear_warmup_cosine
    from repro_torch.sharding.policies import gather
    from repro_torch.utils import tree_flatten

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    params = init_from_spec(build_param_spec(cfg), torch.Generator().manual_seed(0), dev)
    placed = steps.place_params(cfg, mesh, params)
    rate, warmup, total = LM_MESH_SMOKE_LR
    one, _ = steps.make_train_step(cfg, lr=rate, warmup=warmup, total_steps=total)
    over, _ = steps.make_train_step(cfg, mesh, lr=rate, warmup=warmup, total_steps=total)
    lr_sum = sum(float(linear_warmup_cosine(rate, warmup, total)(i)) for i in range(2))
    opt, mopt = adamw_init(params), steps.init_opt_state(placed, "adamw")
    stream = TokenStream(cfg.vocab, 4, 32, seed=3)
    metric_gap, norm_gap = 0.0, 0.0
    grad_ratio = []   # each leaf's least |g| / global norm of one device, element by element
    for i in range(2):
        b = device_batch(make_batch(stream, i, cfg.frontend, cfg.n_frontend_tokens, cfg.d_model),
                         dev)
        _, grads = lm_grads(cfg, params, b)
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        ratios = [g.abs() / gnorm for g in grads]
        grad_ratio = [torch.minimum(a, r) for a, r in zip(grad_ratio, ratios)] or ratios
        del grads, ratios
        _, _, m1 = one(params, opt, b, i)
        _, _, mm = over(placed, mopt, b, i)
        for key in ("loss", "ce", "aux"):
            a, w = mm[key].item(), m1[key].item()
            metric_gap = max(metric_gap, abs(a - w) / (LM_MESH_TOL + LM_MESH_TOL * abs(w)))
        norm_gap = max(norm_gap, abs(mm["grad_norm"].item() - m1["grad_norm"].item())
                       / abs(m1["grad_norm"].item()))
    over_bound, own, noise = {}, {}, 0.0   # by leaf name
    for a, b, r, n in zip(tree_flatten(gather(placed, dev))[0], tree_flatten(params)[0],
                          grad_ratio, leaf_names(params), strict=True):
        gap, base = (a - b).abs(), LM_MESH_TOL * float(b.abs().max())
        bound = base + lr_sum * LM_MESH_GRAD_NOISE / r.clamp(min=1e-30)
        over_bound[n], own[n] = float((gap / bound).max()), rel(a, b)
        # the rounding noise of the gradient that this leaf's gaps imply
        noise = max(noise, float(((gap - base).clamp(min=0) * r).max()) / max(lr_sum, 1e-30))
    param_gap, worst = max((g, n) for n, g in over_bound.items())
    with torch.inference_mode():
        b = device_batch(make_batch(TokenStream(cfg.vocab, 4, 16, seed=2), 0, cfg.frontend,
                                    cfg.n_frontend_tokens, cfg.d_model), dev)
        prefill_gap = rel(steps.make_prefill_step(cfg, mesh)(placed, b).gather(dev),
                          steps.make_prefill_step(cfg)(params, b))
        tokens_equal, cache_gap = None, None
        if cfg.family != "encoder":
            c1, cm = init_cache(cfg, 4, 6, dev), steps.mesh_cache(cfg, mesh, 4, 6)
            d1, dm = steps.make_decode_step(cfg), steps.make_decode_step(cfg, mesh)
            t1 = tm = b["tokens"][:, 0]
            tokens_equal = True
            for pos in range(4):
                t1, c1 = d1(params, c1, t1, pos)
                tm, cm = dm(placed, cm, tm, pos)
                tokens_equal &= bool(torch.equal(tm.gather(dev), t1))
            cache_gap = max(float((a.to(dev) - c).abs().max())
                            for a, c in zip(tree_flatten(gather(cm, dev))[0],
                                            tree_flatten(c1)[0]))
    devices = sorted({str(t.device) for m in tree_flatten(placed)[0] for _, _, t in m.distinct()})
    row = {"phase": "lm_mesh", "check": "smoke", "arch": cfg.name, "mesh": label,
           "fsdp": cfg.force_fsdp, "shard_devices": devices,
           "metric_gap_over_tol": metric_gap, "grad_norm_rel_diff": norm_gap,
           "param_gap_over_bound": param_gap, "param_gap_worst_leaf": worst,
           "param_gap_over_leaf_max": max(own.values()),
           "leaves_over_leaf_max_tol": {n: {"gap_over_leaf_max": g, "gap_over_bound": over_bound[n]}
                                        for n, g in own.items() if g > LM_MESH_TOL},
           "grad_noise_implied": noise, "grad_noise": LM_MESH_GRAD_NOISE,
           "prefill_gap_over_max": prefill_gap,
           "decode_tokens_equal": tokens_equal, "cache_max_abs_diff": cache_gap}
    emit(row)
    check(metric_gap <= 1.0 and norm_gap <= LM_MESH_GRAD_TOL and param_gap <= 1.0
          and prefill_gap <= LM_MESH_TOL and tokens_equal is not False
          and (cache_gap is None or cache_gap <= LM_MESH_TOL),
          f"lm_mesh: {cfg.name} over {label} from one device: {row}")
    return row


def lm_mesh_control(steps, step, placed, mopt, data) -> dict:
    """The control of the phase's loss and norm gates: the mesh ``step`` at
    step 0 (where the warm-up schedule's rate is 0, so the parameters stay
    as they are) with every data row but the first left out of the loss:
    their CE sums and mask counts are zeros and they compute nothing. The
    optimizer moments it wrote are zeroed after. Returns its metrics."""
    import torch

    from repro_torch.sharding.policies import map_mesh

    real, calls = steps.loss_parts, []

    def first_row_only(cfg, params, batch, *rest):
        calls.append(1)
        if len(calls) == 1:
            return real(cfg, params, batch, *rest)
        zero = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
        return zero, zero, None

    steps.loss_parts = first_row_only
    try:
        _, _, m = step(placed, mopt, data, 0)
    finally:
        steps.loss_parts = real
    map_mesh(lambda mt: [t.zero_() for _, _, t in mt.distinct()], mopt)
    return {k: v.item() for k, v in m.items()}


def lm_mesh_phase(dev, on_card, check, smi, full: bool = True) -> dict:
    """The LM steps over a mesh (launch/steps.py, sharding/policies.py).
    (a) granite-3-2b at full width and depth in bf16, AdamW, remat, on a
    (2, 2) mesh of ``dev`` listed four times: FSDP (use_fsdp's choice: 4.9
    GiB of weights over a model extent of 2) and ZeRO-1 state, batch 2 x
    4,096 (one sequence a data row); the one-device step from the same
    parameters and batch first, then over the mesh the control
    (:func:`lm_mesh_control`), a warm-up step (rate 0) and two timed steps.
    Gates: the first loss and gradient norm within LM_MESH_LOSS_RTOL and
    LM_MESH_GNORM_RTOL of the one-device step's, the control's outside one of
    them, every loss finite, the last below the first. Prints the step ms, the peak
    memory and the bytes of parameters, gradients and AdamW state each mesh
    position holds (what one card of such a mesh would hold) beside one
    device's. (b) Every smoke config in float32 over the (2, 2) card mesh,
    FSDP forced on and off, against the one-device steps on the card
    (:func:`lm_mesh_smoke`), and granite-moe-1b-a400m's over a (2, 1) mesh
    of [card, host] (replicas on distinct devices: the gradient all-reduce
    and the ZeRO-1 refresh). ``full=False`` (a rehearsal on the host) runs
    granite-3-2b's smoke config at seq 64 in (a). Runs outside inference
    mode. Returns the kernels' launches over the phase (none of them is on
    this path)."""
    import torch

    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import device_batch
    from repro_torch.models import build_param_spec
    from repro_torch.models.spec import init_from_spec, spec_bytes
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.policies import position_bytes

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    build.reset_launches()

    # (a) granite-3-2b at full width over a (2, 2) mesh of the card
    run = dict(LM_MESH)
    cfg = (get_config if full else get_smoke_config)(run["arch"])
    seq = run["seq"] if full else 64
    mesh = make_host_mesh(run["data"], run["model"], devices=[dev] * (run["data"] * run["model"]))
    fsdp = steps.use_fsdp(cfg, mesh)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = init_from_spec(build_param_spec(cfg), torch.Generator(device=dev).manual_seed(0), dev)
    data = device_batch(make_batch(TokenStream(cfg.vocab, run["batch"], seq, seed=0), 0,
                                   cfg.frontend, cfg.n_frontend_tokens, cfg.d_model), dev)
    placed = steps.place_params(cfg, mesh, params)
    one_step, _ = steps.make_train_step(cfg, warmup=1)
    t = time.perf_counter()
    want = {k: v.item() for k, v in one_step(params, adamw_init(params), data, 0)[2].items()}
    one_ms = (time.perf_counter() - t) * 1e3
    del params   # the one-device parameters and state go before the mesh steps
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step, optname = steps.make_train_step(cfg, mesh, warmup=1)
    mopt = steps.init_opt_state(placed, optname)
    control = lm_mesh_control(steps, step, placed, mopt, data)
    losses, norms, step_ms = [], [], []
    for i in range(1 + run["timed_steps"]):
        t = time.perf_counter()
        _, _, m = step(placed, mopt, data, i)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    p_bytes, s_bytes = position_bytes(placed), position_bytes(mopt)
    weight = spec_bytes(build_param_spec(cfg))
    per_position = {f"{r},{c}": {"params": p_bytes[(r, c)], "grads": p_bytes[(r, c)],
                                 "adamw_state": s_bytes[(r, c)]} for r, c in mesh.positions}
    def rel(got, key):
        return abs(got - want[key]) / abs(want[key])

    loss_rel, norm_rel = rel(losses[0], "loss"), rel(norms[0], "grad_norm")
    control_rel = {"loss": rel(control["loss"], "loss"),
                   "grad_norm": rel(control["grad_norm"], "grad_norm")}
    wq = placed["units"]["pos0"]["mixer"]["wq"]
    out = {"phase": "lm_mesh", "check": "train", "arch": cfg.name, "nvidia_smi": smi,
           "mesh": dict(mesh.shape), "devices": [str(d) for d in mesh.devices],
           "dtype": cfg.param_dtype, "remat": cfg.remat, "fsdp": fsdp, "zero1": True,
           "optimizer": optname, "batch": run["batch"], "seq": seq,
           "wq_spec": list(wq.spec), "losses": losses, "grad_norms": norms,
           "one_device": {"loss": want["loss"], "grad_norm": want["grad_norm"],
                          "step_ms": one_ms, "params": weight, "grads": weight,
                          "adamw_state": 2 * 4 * cfg.param_count()},
           "loss_rel_diff": loss_rel, "loss_rtol": LM_MESH_LOSS_RTOL,
           "grad_norm_rel_diff": norm_rel, "grad_norm_rtol": LM_MESH_GNORM_RTOL,
           "control_row1_left_out": {**control, "rel_diff": control_rel},
           "warmup_step_ms": step_ms[0], "step_ms_each": step_ms[1:],
           "step_ms_median": statistics.median(step_ms[1:]),
           "tok_s": run["batch"] * seq / statistics.median(step_ms[1:]) * 1e3,
           "peak_mem_gb": peak, "per_position_bytes": per_position,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(not full or fsdp, f"lm_mesh: use_fsdp is false for {cfg.name} over {dict(mesh.shape)}")
    check(loss_rel <= LM_MESH_LOSS_RTOL and norm_rel <= LM_MESH_GNORM_RTOL,
          f"lm_mesh: the mesh step's first loss {loss_rel} or norm {norm_rel} from one device")
    check(control_rel["loss"] > LM_MESH_LOSS_RTOL or control_rel["grad_norm"] > LM_MESH_GNORM_RTOL,
          f"lm_mesh: the control with row 1 left out passes the gates: {control_rel}")
    check(all(math.isfinite(x) for x in losses + norms) and losses[-1] < losses[0],
          f"lm_mesh: losses {losses} or norms {norms} not finite and falling")
    del placed, mopt, data
    if on_card:
        torch.cuda.empty_cache()

    # (b) every smoke config in float32 over the card mesh, against one device
    for arch in sorted(ARCHS):
        for fsdp in (False, True):
            cfg = dataclasses.replace(get_smoke_config(arch), force_fsdp=fsdp)
            lm_mesh_smoke(dev, check, cfg, mesh, "2x2 card")
    mixed = make_host_mesh(2, 1, devices=[dev, "cpu"])
    lm_mesh_smoke(dev, check, get_smoke_config("granite-moe-1b-a400m"), mixed,
                  f"2x1 [{dev}, cpu]")

    launches = dict(build.LAUNCHES)
    emit({"phase": "lm_mesh", "check": "phase", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    check(not any(launches.values()),
          f"lm_mesh: a GS-TG kernel launched on the LM mesh path: {launches}")
    return launches


DRYRUN_TRAIN = dict(arch="granite-3-2b", batch=2, seq=4096, data=2, model=2)
DRYRUN_CELLS = (("granite-3-2b", "train_4k", False), ("mamba2-370m", "long_500k", True),
                ("hubert-xlarge", "decode_32k", False))
DRYRUN_TIMEOUT_S = 600


def frame_for_oracles(feat, masks, origins, in_img, live_per_group, tfeat, torigins,
                      ttable, grid, chunk: int) -> dict:
    """Host copies of a few of the main frame's inputs for the dryrun
    phase's dense oracles: the groups with the most, the median and a
    quarter's live entries, cut to their last live entry (rounded up to the
    chunk), and the four compacted tiles with the most entries. The gsm
    section adds its sort table (``keys``, ``payload``)."""
    import torch

    from repro_torch.kernels.layout import F_VALID

    order = torch.argsort(live_per_group, descending=True)
    sel = order[[0, len(order) // 4, len(order) // 2]]
    f = feat[sel]
    live = (f[:, F_VALID] > 0.5).any(0).nonzero()
    kc = -(-(int(live.max()) + 1) // chunk) * chunk if live.numel() else chunk
    tsel = torch.argsort(ttable.entry_valid.sum(1), descending=True)[:4]
    return {"feat": f[:, :, :kc].cpu(), "masks": masks[sel][:, :kc].cpu(),
            "origins": origins[sel].cpu(), "in_img": in_img[sel].cpu(),
            "tfeat": tfeat[tsel].cpu(), "torigins": torigins[tsel].cpu(),
            "tile": grid.tile, "gf": grid.gf, "chunk": chunk}


def sort_disagreement(keys, payload, got_k, got_v) -> dict:
    """The sort kernel's rows against ref_sort's on the host: keys that
    differ in value (rows holding NaN excepted) and rows whose (key,
    payload) pairs differ as a multiset."""
    import torch

    from repro_torch.kernels.ref import ref_sort

    want_k, want_v = ref_sort(keys, payload)
    clean = ~keys.isnan().any(-1)
    key_off = int((got_k[clean] != want_k[clean]).sum())

    def pairs(k, v):
        kb = k.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        vb = v.contiguous().view(torch.int32).to(torch.int64)
        return torch.sort((vb << 32) | kb, dim=-1).values

    rows_off = int((pairs(got_k, got_v) != pairs(want_k, want_v)).any(-1).sum())
    return {"keys_off": key_off, "rows_pairs_off": rows_off}


def dryrun_oracles(dev, check, frame) -> dict:
    """(a) of the dryrun phase: each kernel on ``dev`` against its
    kernels/ref.py oracle on the host. Returns the worst gaps."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmask_gen import KERNEL_METHODS, bitmask_kernel, edge_case_block
    from repro_torch.kernels.bitonic_sort import bitonic_sort_kernel, edge_case_rows
    from repro_torch.kernels.raster_tile import (
        TILE_WINDOW,
        edge_case_lists,
        raster_group_fused_kernel,
        raster_tile_kernel,
    )

    out = {"bitmask_gen": {"cases": 0, "words": 0, "differing_words": 0},
           "raster_group_fused": {"cases": 0, "rgb_max_abs_err": 0.0, "t_max_abs_err": 0.0,
                                  "nan_off": 0},
           "raster_tile": {"cases": 0, "rgb_max_abs_err": 0.0, "t_max_abs_err": 0.0,
                           "nan_off": 0},
           "bitonic_sort": {"cases": 0, "keys_off": 0, "rows_pairs_off": 0}}

    def bgm(feat, origins, in_img, tile_px, gf, method):
        got = bitmask_kernel(feat.to(dev), origins.to(dev), in_img.to(dev), tile_px, gf,
                             method).cpu()
        want = ref.ref_bitmask(feat, origins, in_img, tile_px, gf, method)
        o = out["bitmask_gen"]
        o["cases"] += 1
        o["words"] += want.numel()
        o["differing_words"] += int((got != want).sum())

    def image(name, got, want):
        """rgb (rows 0-2) and T (row 3) apart: a kernel stops a tile whose
        pixels all fall below T = 1e-4 and keeps its T, where the oracle
        multiplies on, so T may differ by up to 1e-4 by design."""
        o = out[name]
        o["cases"] += 1
        o["nan_off"] += int((got.isnan() != want.isnan()).sum())
        if want.numel():
            gap = (got - want).abs().nan_to_num(0.0)
            o["rgb_max_abs_err"] = max(o["rgb_max_abs_err"], float(gap[..., :3, :].max()))
            o["t_max_abs_err"] = max(o["t_max_abs_err"], float(gap[..., 3, :].max()))

    def fused(feat, masks, origins, tile_px, gf, chunk):
        got, _ = raster_group_fused_kernel(feat.to(dev), masks.to(dev), origins.to(dev),
                                           tile_px, gf, chunk=chunk)
        image("raster_group_fused", got.cpu(),
              ref.ref_raster_group_fused(feat, masks, origins, tile_px, gf))

    def tile(feat, origins, tile_px, chunk):
        got, _ = raster_tile_kernel(feat.to(dev), origins.to(dev), tile_px, chunk=chunk)
        image("raster_tile", got.cpu(), ref.ref_raster_tiles(feat, origins, tile_px))

    def sort(keys, payload):
        got_k, got_v = bitonic_sort_kernel(keys.to(dev), payload.to(dev))
        gap = sort_disagreement(keys, payload, got_k.cpu(), got_v.cpu())
        o = out["bitonic_sort"]
        o["cases"] += 1
        for k, v in gap.items():
            o[k] += v

    tile_px, gf, chunk = frame["tile"], frame["gf"], frame["chunk"]
    for method in KERNEL_METHODS:
        bgm(frame["feat"], frame["origins"], frame["in_img"], tile_px, gf, method)
    fused(frame["feat"], frame["masks"], frame["origins"], tile_px, gf, chunk)
    tile(frame["tfeat"], frame["torigins"], tile_px, chunk)
    sort(frame["keys"], frame["payload"])
    for g in range(1, 6):
        for t in (8, 16):
            block = edge_case_block(g, t, torch.Generator().manual_seed(7))
            for method in KERNEL_METHODS:
                bgm(*block, t, g, method)
    for t in (4, 6, 8, 12, 16, 32, 48, 64):
        for c in (32, TILE_WINDOW, 2048):
            f_e, o_e = edge_case_lists(t, c, torch.Generator().manual_seed(3))
            tile(f_e, o_e, t, c)
            if t in (8, 16) and c != 2048:   # each list a group of one member tile
                fused(f_e, torch.ones(f_e.shape[0], f_e.shape[2], dtype=torch.int32), o_e,
                      t, 1, c)
    for p in range(GSM_EDGE_MAX_LOG2 + 1):
        sort(*edge_case_rows(2**p, torch.Generator().manual_seed(p)))

    o = out["bitmask_gen"]
    check(o["differing_words"] == 0,
          f"dryrun: the BGM leaves ref_bitmask in {o['differing_words']} words")
    for name in ("raster_group_fused", "raster_tile"):
        o = out[name]
        check(max(o["rgb_max_abs_err"], o["t_max_abs_err"]) <= IMAGE_TOL and o["nan_off"] == 0,
              f"dryrun: {name} from its oracle by rgb {o['rgb_max_abs_err']}, T "
              f"{o['t_max_abs_err']} (tol {IMAGE_TOL}), {o['nan_off']} NaN placements off")
    o = out["bitonic_sort"]
    check(o["keys_off"] == 0 and o["rows_pairs_off"] == 0, f"dryrun: the GSM leaves ref_sort: {o}")
    return out


def dryrun_counts(dev, on_card, check, full: bool = True) -> dict:
    """(b) of the dryrun phase: one train step under count_step on ``dev``
    and on meta, on one device and on a (2, 2) mesh."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.train import device_batch
    from repro_torch.models import build_param_spec
    from repro_torch.models.spec import abstract_from_spec, init_from_spec
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.policies import position_bytes
    from repro_torch.utils import pytree_bytes

    run = dict(DRYRUN_TRAIN)
    base = (get_config if full else get_smoke_config)(run["arch"])
    seq = run["seq"] if full else 64
    mesh = make_host_mesh(run["data"], run["model"], devices=[dev] * 4)
    meta_mesh = make_host_mesh(run["data"], run["model"], devices=["meta"] * 4)
    cfg = dataclasses.replace(base, n_layers=len(base.pattern),
                              force_fsdp=steps.use_fsdp(base, mesh))
    spec = build_param_spec(cfg)

    def counted(step, kw):
        gc.collect()   # a cycle of the last step's garbage, freed inside this one, would skew its peak
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() if on_card else 0
        got = count_step(step, kw)
        if on_card:
            torch.cuda.synchronize()
            got["card_peak"] = torch.cuda.max_memory_allocated() - before
        got.pop("table")
        return got

    params = init_from_spec(spec, torch.Generator(device=dev).manual_seed(0), dev)
    data = device_batch(make_batch(TokenStream(cfg.vocab, run["batch"], seq, seed=0), 0,
                                   cfg.frontend, cfg.n_frontend_tokens, cfg.d_model), dev)
    one, _ = steps.make_train_step(cfg)
    opt = adamw_init(params)
    held_one = pytree_bytes(params) + pytree_bytes(opt)
    card_one = counted(one, dict(params=params, opt_state=opt, batch=data, step=0))
    placed = steps.place_params(cfg, mesh, params)
    del params, opt
    mopt = steps.init_opt_state(placed, "adamw")
    p_b, s_b = position_bytes(placed), position_bytes(mopt)
    held_mesh = {pos: p_b[pos] + s_b[pos] for pos in mesh.positions}
    over, _ = steps.make_train_step(cfg, mesh)
    card_mesh = counted(over, dict(params=placed, opt_state=mopt, batch=data, step=0))
    del placed, mopt, data

    meta_params = abstract_from_spec(spec)
    meta_opt = adamw_init(meta_params)
    meta_batch = {k: torch.empty((run["batch"], seq), dtype=torch.int64, device="meta")
                  for k in ("tokens", "labels")}
    meta_one = counted(one, dict(params=meta_params, opt_state=meta_opt, batch=meta_batch,
                                 step=0))
    meta_held_one = pytree_bytes(meta_params) + pytree_bytes(meta_opt)
    meta_step, kw = steps.jit_for_cell(cfg, ShapeCell("dryrun", seq, run["batch"], "train"),
                                       meta_mesh)
    p_b, s_b = position_bytes(kw["params"]), position_bytes(kw["opt_state"])
    meta_held = {pos: p_b[pos] + s_b[pos] for pos in meta_mesh.positions}
    meta_mesh_counts = counted(meta_step, kw)

    def pair(card, meta):
        out = {k: {"card": card[k], "meta": meta[k]}
               for k in ("flops", "bytes", "temp", "all-gather", "all-reduce",
                         "reduce-scatter", "seconds")}
        if "card_peak" in card:
            out["card_max_memory_allocated"] = card["card_peak"]
            out["peak_ratio_meta_over_card"] = meta["temp"] / card["card_peak"]
        return out

    result = {"arch": cfg.name, "units": cfg.n_units, "fsdp": cfg.force_fsdp,
              "batch": run["batch"], "seq": seq,
              "one_device": {**pair(card_one, meta_one),
                             "held_bytes": {"card": held_one, "meta": meta_held_one}},
              "mesh_2x2": {**pair(card_mesh, meta_mesh_counts),
                           "held_bytes": {"card": {f"{r},{c}": v for (r, c), v in held_mesh.items()},
                                          "meta": {f"{r},{c}": v for (r, c), v in meta_held.items()}}}}
    check(card_one["flops"] == meta_one["flops"] and card_mesh["flops"] == meta_mesh_counts["flops"],
          f"dryrun: FLOPs differ card vs meta: one device {card_one['flops']} vs "
          f"{meta_one['flops']}, mesh {card_mesh['flops']} vs {meta_mesh_counts['flops']}")
    check(held_one == meta_held_one and held_mesh == meta_held,
          "dryrun: the bytes a position holds differ card vs meta")
    check(card_one["flops"] > 0 and card_mesh["flops"] > 0, "dryrun: no FLOPs counted")
    return result


def dryrun_cli_start(cell, out_dir: Path):
    arch, shape, multi_pod = cell
    report = out_dir / f"{arch}_{shape}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--report", str(report)] + (["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, report, time.perf_counter()


def dryrun_phase(dev, on_card, check, smi, frame, full: bool = True) -> dict:
    """The dry-run tools and the kernels' dense oracles (module docstring,
    phase 10). ``frame`` holds :func:`frame_for_oracles`'s inputs.
    ``full=False`` (a rehearsal on the host) counts granite-3-2b's smoke
    config in (b) and runs the CLI cells all the same. Returns the kernels'
    launches over (b), none of them on that path (the count is this
    process's: the CLI cells of (c) run on meta in child processes)."""
    import tempfile

    import torch

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        out_dir = Path(tmp)
        procs = [dryrun_cli_start(cell, out_dir) for cell in DRYRUN_CELLS]
        try:
            oracles = dryrun_oracles(dev, check, frame)
            emit({"phase": "dryrun", "check": "oracles", "nvidia_smi": smi, **oracles,
                  "image_tol": IMAGE_TOL})
            build.reset_launches()
            with torch.inference_mode(False):
                counts = dryrun_counts(dev, on_card, check, full)
            emit({"phase": "dryrun", "check": "meta_vs_card", "nvidia_smi": smi, **counts})
            cells = []
            for cell, (proc, report, t0) in zip(DRYRUN_CELLS, procs):
                text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
                rec = json.loads(report.read_text())[0] if report.exists() else None
                row = {"cell": list(cell), "exit": proc.returncode,
                       "seconds": time.perf_counter() - t0,
                       "printed": [ln for ln in text.splitlines()
                                   if ln.startswith(("OK", "SKIP", "summary"))]}
                if rec and rec["status"] == "ok":
                    r, m = rec["roofline"], rec["memory_analysis"]
                    row.update(status="ok", compile_s=rec["compile_s"], chips=r["chips"],
                               flops_per_device=r["flops_per_device"],
                               bytes_per_device=r["bytes_per_device"],
                               collective_by_kind=r["collective_by_kind"],
                               argument_bytes_per_device=m["argument_bytes_per_device"],
                               temp_bytes_per_device=m["temp_bytes_per_device"],
                               compute_s=r["compute_s"], memory_s=r["memory_s"],
                               collective_s=r["collective_s"], dominant=r["dominant"],
                               useful_flops_ratio=r["useful_flops_ratio"])
                elif rec:
                    row.update(status=rec["status"], reason=rec.get("reason"))
                cells.append(row)
                emit({"phase": "dryrun", "check": "cli", **row})
                check(proc.returncode == 0 and rec is not None and row["printed"],
                      f"dryrun: the CLI on {cell} exited {proc.returncode} or printed no record:\n"
                      f"{text[-2000:]}")
            check(cells[-1].get("status") == "skip", f"dryrun: {DRYRUN_CELLS[-1]} is not a skip")
        finally:
            for proc, _, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    launches = dict(build.LAUNCHES)
    emit({"phase": "dryrun", "check": "phase", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    check(not any(launches.values()),
          f"dryrun: a GS-TG kernel launched on the dry-run path: {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        return run(torch.device("cuda"), smi, WIDTH, HEIGHT, MAIN_GAUSSIANS,
                   LOSSLESS_GAUSSIANS)


def run(dev, smi: str, width: int, height: int, n_main: int, n_lossless: int) -> int:
    """All phases on ``dev``. On a CPU device (a rehearsal at a small size)
    the kernel wrappers run their plain versions and times are host times."""
    import torch

    from repro_torch import engine
    from repro_torch.kernels import build
    from repro_torch.configs import PAPER_SCENES, scene_and_camera
    from repro_torch.core import GridSpec, RenderConfig, make_camera, render, scene_like_paper
    from repro_torch.core.gaussians import random_scene
    from repro_torch.core.bitmask import GroupBitmasks, compact_tiles
    from repro_torch.core.cost_model import GSTG_ASIC, estimate
    from repro_torch.core.pipeline import render_frontend
    from repro_torch.core.stages import get_backend
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, get_tracer, set_tracer
    from repro_torch.kernels.bitmask_gen import (
        KERNEL_METHODS,
        bitmask_kernel,
        bitmask_plain,
        edge_case_block,
    )
    from repro_torch.kernels.bitonic_sort import (
        bitonic_sort_kernel,
        bitonic_sort_plain,
        block_shape,
        edge_case_rows,
    )
    from repro_torch.kernels.layout import LANE, pack_features
    from repro_torch.kernels.raster_tile import (
        TILE_WINDOW,
        edge_case_lists,
        raster_group_fused_kernel,
        raster_group_fused_plain,
        raster_tile_kernel,
        raster_tile_plain,
        raster_tile_walk,
        tile_kernel_shape,
    )

    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    count = torch.cuda.device_count() if on_card else 0
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"FAIL: {what}", file=sys.stderr, flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def bits(x):
        return x.contiguous().view(torch.int32)

    def time_ms(fn, reps=REPS):
        """Median of ``reps`` calls after a warm-up: CUDA events on the card."""
        fn()
        sync()
        times = []
        for _ in range(reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    # -- 1. device + build ---------------------------------------------------
    t0 = time.perf_counter()
    build_s = build.build() if on_card else {}
    build_wall = time.perf_counter() - t0
    ptxas = {}
    for name in build.SOURCES:
        log = Path(f"{build.library_path(name)}.log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    tile_report = tile_build_report(build, tile_kernel_shape) if on_card else None
    gsm_report = bitonic_build_report(build, block_shape) if on_card else None
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": count, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_wall_s": round(build_wall, 3), "ptxas": ptxas,
          "raster_group_fused": fused_build_report(build),
          "raster_tile": tile_report,
          "bitmask_gen": bgm_build_report(build, KERNEL_METHODS),
          "bitonic_sort": gsm_report})
    if gsm_report:
        spilled = {k: v["spill_bytes"] for k, v in gsm_report["instances"].items()
                   if v["spill_bytes"]}
        check(gsm_report["instances"] and not spilled,
              f"bitonic_sort instances spill (bytes): {spilled}" if spilled
              else "no ptxas report for the bitonic_sort instances")
    if tile_report:  # edge_case_lists places its seams by the kernel's window
        check(tile_report["window_entries"] == TILE_WINDOW,
              f"the tile kernel stages {tile_report['window_entries']} entries a window, "
              f"edge_case_lists assumes {TILE_WINDOW}")

    # -- main-path inputs ------------------------------------------------------
    spec = PAPER_SCENES["train"]
    scene, cam = scene_and_camera("train", n_main, width, height, device=dev)
    cfg = RenderConfig(backend="cuda", **CFG_KW)
    front = render_frontend(scene, cam, cfg)
    grid = GridSpec(width, height, cfg.tile, cfg.group, cfg.span)
    gtable = front.table
    lengths = gtable.lengths.to(torch.float32)
    pad = math.lcm(LANE, cfg.chunk)
    feat = pack_features(front.proj, gtable.gauss_idx, gtable.entry_valid, multiple=pad)
    origins = ops.group_origins(grid, dev)
    in_img = ops.tiles_in_image(grid, dev)
    G, _, Kp = feat.shape
    live_per_group = gtable.entry_valid.sum(1)
    live = int(live_per_group.sum())
    valid_tests = int((live_per_group * in_img.sum(1)).sum())

    kernels = {}

    # -- 2. kernels against their plain versions -----------------------------
    masks_main = None
    for method in KERNEL_METHODS:
        got = bitmask_kernel(feat, origins, in_img, grid.tile, grid.gf, method)
        want = bitmask_plain(feat, origins, in_img, grid.tile, grid.gf, method)
        sync()
        bad = int((got != want).sum())
        ms = time_ms(lambda: bitmask_kernel(feat, origins, in_img, grid.tile, grid.gf, method))
        plain_ms = time_ms(lambda: bitmask_plain(feat, origins, in_img, grid.tile, grid.gf, method))
        nbytes = ((G * Kp + ENTRY_ROWS[method] * live + G * Kp) * 4
                  + origins.numel() * 4 + in_img.numel() * in_img.element_size())
        ops_n = bgm_ops(method, live_per_group, in_img, grid.gf)
        ops_tile = valid_tests * OPS_PER_TEST[method]
        emit({"phase": "kernel", "kernel": "bitmask_gen", "method": method,
              "shape": list(feat.shape), "live_entries": live, "differing_words": bad, "ms": ms,
              "plain_ms": plain_ms, "bytes": nbytes, "ops": ops_n,
              "bound_ms": bound(nbytes, ops_n)[0], "ops_per_tile_form": ops_tile,
              "bound_ms_per_tile_form": bound(nbytes, ops_tile)[0]})
        check(bad == 0, f"bitmask_gen[{method}] differs from its plain version in {bad} words")
        if method == cfg.boundary_tile:
            masks_main = got
            kernels["bitmask_gen"] = dict(
                max_abs_err=float(bad), ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops_n)

    # The package's edge-case block: every compiled instance, bit for bit.
    edge = {"cases": 0, "words": 0, "differing_words": 0, "differing_cases": []}
    for gf in range(1, 6):
        for tile_px in (8, 16):
            block = edge_case_block(gf, tile_px, torch.Generator().manual_seed(7))
            f_e, o_e, i_e = (x.to(dev) for x in block)
            for method in KERNEL_METHODS:
                got = bitmask_kernel(f_e, o_e, i_e, tile_px, gf, method)
                want = bitmask_plain(f_e, o_e, i_e, tile_px, gf, method)
                bad = int((got != want).sum())
                edge["cases"] += 1
                edge["words"] += got.numel()
                edge["differing_words"] += bad
                if bad:
                    edge["differing_cases"].append(f"gf={gf},tile={tile_px},{method}: {bad}")
    emit({"phase": "kernel", "kernel": "bitmask_gen", "check": "bgm_edge_cases", **edge})
    check(edge["differing_words"] == 0, f"bgm_edge_cases: {edge['differing_cases']}")

    def agreement(out_k, cnt_k, out_p, cnt_p):
        """Kernel against plain: max-abs error, counter totals and their
        relative difference, tiles whose counters differ, and T values off
        by more than 1e-4 relative (1e-30 absolute)."""
        err = float((out_k - out_p).abs().max())
        ck = cnt_k.to(torch.int64).reshape(-1, 2)
        cp = cnt_p.to(torch.int64).reshape(-1, 2)
        tot_k, tot_p = ck.sum(0).tolist(), cp.sum(0).tolist()
        rel = [abs(a - b) / max(b, 1) for a, b in zip(tot_k, tot_p)]
        flips = int((ck != cp).any(1).sum())
        t_k, t_p = out_k[..., 3, :], out_p[..., 3, :]
        t_off = int(((t_k - t_p).abs() > 1e-30 + 1e-4 * t_p.abs()).sum())
        return err, tot_k, tot_p, rel, flips, t_off

    def edge_disagreement(out_k, cnt_k, out_p, cnt_p):
        """Pixels and tiles where the kernel leaves its plain version: rgb
        off by more than 1e-5, T by more than 1e-4 relative (1e-30
        absolute), NaN in one and not the other, counters not equal."""
        nan_k, nan_p = out_k.isnan(), out_p.isnan()
        diff = (out_k - out_p).abs().nan_to_num(0.0)
        rgb = (diff[:, :3] > 1e-5) | (nan_k[:, :3] != nan_p[:, :3])
        t_off = ((diff[:, 3] > 1e-30 + 1e-4 * out_p[:, 3].abs().nan_to_num(0.0))
                 | (nan_k[:, 3] != nan_p[:, 3]))
        return {"rgb_off": int(rgb.sum()), "t_off": int(t_off.sum()),
                "tiles_with_counters_off": int((cnt_k != cnt_p).any(1).sum())}

    def raster_compare(name, run_k, run_p, n_outputs_bytes, in_bytes):
        out_k, cnt_k = run_k()
        out_p, cnt_p = run_p()
        sync()
        err, tot_k, tot_p, rel, flips, _ = agreement(out_k, cnt_k, out_p, cnt_p)
        ms = time_ms(run_k)
        plain_ms = time_ms(run_p, reps=3)
        alpha_ops, blend_ops = tot_k
        ops_n = OPS_PER_ALPHA * alpha_ops + OPS_PER_BLEND * blend_ops
        emit({"phase": "kernel", "kernel": name, "max_abs_err": err,
              "alpha_ops": tot_k[0], "blend_ops": tot_k[1],
              "plain_alpha_ops": tot_p[0], "plain_blend_ops": tot_p[1],
              "counter_rel_diff": rel, "tiles_with_counter_flips": flips,
              "ms": ms, "plain_ms": plain_ms, "bytes": in_bytes + n_outputs_bytes,
              "ops": ops_n})
        check(err <= IMAGE_TOL, f"{name}: max abs {err} > {IMAGE_TOL}")
        check(max(rel) <= COUNTER_RTOL, f"{name}: counters differ by {rel} > {COUNTER_RTOL}")
        kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             nbytes=in_bytes + n_outputs_bytes, ops=ops_n)

    tpg, P = grid.tiles_per_group, grid.tile * grid.tile
    raster_compare(
        "raster_group_fused",
        lambda: raster_group_fused_kernel(feat, masks_main, origins, grid.tile, grid.gf,
                                          chunk=cfg.chunk, tile_capacity=cfg.tile_capacity),
        lambda: raster_group_fused_plain(feat, masks_main, origins, grid.tile, grid.gf,
                                         chunk=cfg.chunk, tile_capacity=cfg.tile_capacity),
        G * tpg * (4 * P + 2) * 4,
        (G * Kp + (RASTER_ROWS + 1) * live) * 4 + origins.numel() * 4,  # + mask word
    )
    # The tile kernel on the main path's compacted per-tile lists.
    ttable = compact_tiles(gtable, GroupBitmasks(masks_main[:, :gtable.capacity], None),
                           grid, cfg.tile_capacity)
    tfeat = pack_features(front.proj, ttable.gauss_idx, ttable.entry_valid, multiple=pad)
    torigins = ops.tile_origins(grid, dev)
    NT, _, KT = tfeat.shape
    # Bytes the tile RM needs on this data: the nine rows of each tile's
    # entries up to the chunk boundary where early exit stops it (or its
    # last live entry), the opacity of the padding it walks before that
    # boundary, the origins and every output.
    walk_full, walk_opacity = (int(x.sum()) for x in
                               raster_tile_walk(tfeat, torigins, grid.tile, cfg.chunk))
    raster_compare(
        "raster_tile",
        lambda: raster_tile_kernel(tfeat, torigins, grid.tile, chunk=cfg.chunk),
        lambda: raster_tile_plain(tfeat, torigins, grid.tile, chunk=cfg.chunk),
        NT * (4 * P + 2) * 4,
        (RASTER_ROWS * walk_full + walk_opacity) * 4 + torigins.numel() * 4,
    )
    # Every live entry walked: the blend's cost per (tile, entry).
    emit({"phase": "kernel", "kernel": "raster_tile", "check": "no_early_exit",
          "entries_walked_with_early_exit": walk_full, "opacity_only": walk_opacity,
          "live_entries": int(ttable.entry_valid.sum()),
          "ms": time_ms(lambda: raster_tile_kernel(tfeat, torigins, grid.tile,
                                                   chunk=cfg.chunk, early_exit=False))})

    # The package's edge-case lists: the tile kernel against its plain
    # version, run on the host as the cuda tests run it (there its cumprod
    # multiplies a chunk in list order, as the kernel does), at tile sizes
    # that fill their blocks and ones that leave pixel slots idle (4, 6, 12,
    # 48), and at chunks below, at and past a window.
    edge = {"cases": 0, "failures": []}
    for tile_px in (4, 6, 8, 12, 16, 32, 48, 64):
        for chunk in (32, TILE_WINDOW, 2048):
            f_e, o_e = edge_case_lists(tile_px, chunk, torch.Generator().manual_seed(3))
            for early_exit in (True, False):
                out_k, cnt_k = raster_tile_kernel(f_e.to(dev), o_e.to(dev), tile_px, chunk,
                                                  early_exit)
                out_p, cnt_p = raster_tile_plain(f_e, o_e, tile_px, chunk, early_exit)
                edge["cases"] += 1
                bad = edge_disagreement(out_k.cpu(), cnt_k.cpu(), out_p, cnt_p)
                if any(bad.values()):
                    edge["failures"].append(
                        {"tile": tile_px, "chunk": chunk, "early_exit": early_exit, **bad})
    emit({"phase": "kernel", "kernel": "raster_tile", "check": "tile_edge_cases", **edge})
    check(not edge["failures"], f"tile_edge_cases: {edge['failures']}")

    def fused_vs_tile(feat, masks, origins, tfeat, torigins, grid, chunk, tile_capacity,
                      what="fused_vs_tile"):
        """The tile kernel over the compacted lists is the fused kernel's
        oracle on the card: rgb and counters bit for bit, and the
        transmittance too without early exit (with it, each stops at a chunk
        boundary of its own list). Member tiles outside the image stream
        nothing."""
        gtile, in_image = ops.member_tiles(grid, dev)
        gidx = gtile[in_image].long()
        result = {}
        for early_exit in (True, False):
            out_f, cnt_f = raster_group_fused_kernel(
                feat, masks, origins, grid.tile, grid.gf, chunk=chunk,
                early_exit=early_exit, tile_capacity=tile_capacity)
            out_t, cnt_t = raster_tile_kernel(tfeat, torigins, grid.tile, chunk=chunk,
                                              early_exit=early_exit)
            sync()
            rows = 3 if early_exit else 4
            differ = ((bits(out_f[in_image][:, :rows]) != bits(out_t[gidx][:, :rows]))
                      .flatten(1).any(1) | (cnt_f[in_image] != cnt_t[gidx]).any(1))
            outside = out_f[~in_image]
            not_empty = ((outside[:, :3] != 0).flatten(1).any(1) | (outside[:, 3] != 1).any(1)
                         | (cnt_f[~in_image] != 0).any(1))
            key = "early_exit" if early_exit else "no_early_exit"
            result[key] = {"rows": rows, "tiles_compared": int(in_image.sum()),
                           "tiles_differing": int(differ.sum()),
                           "outside_tiles": int((~in_image).sum()),
                           "outside_not_empty": int(not_empty.sum())}
            check(int(differ.sum()) == 0 and int(not_empty.sum()) == 0,
                  f"{what}[{key}]: {result[key]}")
        return result

    emit({"phase": "kernel", "kernel": "raster_group_fused", "check": "fused_vs_tile",
          **fused_vs_tile(feat, masks_main, origins, tfeat, torigins, grid, cfg.chunk,
                          cfg.tile_capacity)})
    oracle_frame = frame_for_oracles(feat, masks_main, origins, in_img, live_per_group, tfeat,
                                     torigins, ttable, grid, cfg.chunk)
    del tfeat, ttable, feat

    # -- wide_chunk: chunk 2048, past the 1,024 entries the tile kernel
    # stages at once, on a small frame whose group lists pass 1,024. --------
    w_w, w_h = WIDE_SIZE
    w_cfg = RenderConfig(backend="cuda", **{**CFG_KW, "group_capacity": 4096,
                                            "tile_capacity": 4096, "chunk": WIDE_CHUNK})
    w_scene = random_scene(WIDE_GAUSSIANS, extent=3.0,
                           generator=torch.Generator().manual_seed(4)).to(dev)
    w_front = render_frontend(w_scene, make_camera((0.0, 1.2, 5.0), (0, 0, 0), w_w, w_h),
                              w_cfg)
    w_grid = GridSpec(w_w, w_h, w_cfg.tile, w_cfg.group, w_cfg.span)
    w_table, w_pad = w_front.table, math.lcm(LANE, WIDE_CHUNK)
    w_feat = pack_features(w_front.proj, w_table.gauss_idx, w_table.entry_valid, multiple=w_pad)
    w_origins = ops.group_origins(w_grid, dev)
    w_masks = bitmask_kernel(w_feat, w_origins, ops.tiles_in_image(w_grid, dev), w_grid.tile,
                             w_grid.gf, w_cfg.boundary_tile)
    w_ttable = compact_tiles(w_table, GroupBitmasks(w_masks[:, :w_table.capacity], None),
                             w_grid, w_cfg.tile_capacity)
    w_tfeat = pack_features(w_front.proj, w_ttable.gauss_idx, w_ttable.entry_valid,
                            multiple=w_pad)
    w_torigins = ops.tile_origins(w_grid, dev)
    w_kw = dict(chunk=WIDE_CHUNK)
    wide = {"shape": list(w_feat.shape), "max_group_len": int(w_table.lengths.max()),
            "max_tile_len": int(w_ttable.lengths.max())}
    runs = {
        "raster_group_fused": lambda **kw: (
            raster_group_fused_kernel(w_feat, w_masks, w_origins, w_grid.tile, w_grid.gf, **kw),
            raster_group_fused_plain(w_feat, w_masks, w_origins, w_grid.tile, w_grid.gf, **kw)),
        "raster_tile": lambda **kw: (
            raster_tile_kernel(w_tfeat, w_torigins, w_grid.tile, **kw),
            raster_tile_plain(w_tfeat, w_torigins, w_grid.tile, **kw)),
        "raster_tile_64px_group_lists": lambda **kw: (
            raster_tile_kernel(w_feat, w_origins, w_grid.group, **kw),
            raster_tile_plain(w_feat, w_origins, w_grid.group, **kw)),
    }
    for name, run_both in runs.items():
        for early_exit in (True, False):
            (out_k, cnt_k), (out_p, cnt_p) = run_both(early_exit=early_exit, **w_kw)
            sync()
            err, tot_k, _, rel, _, t_off = agreement(out_k, cnt_k, out_p, cnt_p)
            key = f"{name}[{'early_exit' if early_exit else 'no_early_exit'}]"
            wide[key] = {"max_abs_err": err, "counter_rel_diff": rel, "t_off": t_off,
                         "blend_ops": tot_k[1]}
            check(err <= IMAGE_TOL and max(rel) <= COUNTER_RTOL and t_off == 0
                  and tot_k[1] > 0, f"wide_chunk {key}: {wide[key]}")
    wide["fused_vs_tile"] = fused_vs_tile(w_feat, w_masks, w_origins, w_tfeat, w_torigins,
                                          w_grid, WIDE_CHUNK, w_cfg.tile_capacity,
                                          "wide_chunk fused_vs_tile")
    emit({"phase": "kernel", "check": "wide_chunk", "chunk": WIDE_CHUNK, **wide})
    check(wide["max_group_len"] > 1024, f"wide_chunk: lists reach only {wide['max_group_len']}")
    del w_scene, w_front, w_table, w_feat, w_masks, w_ttable, w_tfeat

    # -- gsm: the bitonic sort on the main frame's group lists -----------------
    gvalid = gtable.entry_valid
    table_keys = torch.where(gvalid, front.proj.depth[gtable.gauss_idx.long()],
                             torch.full((), float("inf"), device=dev))
    gen = torch.Generator(device=dev).manual_seed(12)
    perm = torch.rand(table_keys.shape, generator=gen, device=dev).argsort(dim=1)
    keys = table_keys.gather(1, perm)
    payload = gtable.gauss_idx.to(torch.int32).gather(1, perm)
    build.reset_launches()
    sk, sv = ops.sort_groups_bitonic(keys, payload)
    sync()
    gsm_launches = dict(build.LAUNCHES)
    payload_f = payload.to(torch.float32)
    pk, pv = bitonic_sort_plain(keys, payload_f)
    lib = torch.sort(keys, dim=-1)
    sync()

    same_plain = bool(torch.equal(bits(sk), bits(pk)) and torch.equal(sv, pv.to(torch.int32)))
    same_lib = bool(torch.equal(bits(sk), bits(lib.values)))
    live_order = bool(torch.equal(sk[gvalid], table_keys[gvalid]))
    carried = bool(torch.equal(front.proj.depth[sv[gvalid].long()], sk[gvalid]))
    Gs, Ks = keys.shape
    ms = time_ms(lambda: bitonic_sort_kernel(keys, payload_f))
    plain_ms = time_ms(lambda: bitonic_sort_plain(keys, payload_f))
    library_ms = time_ms(lambda: torch.gather(payload_f, -1, torch.sort(keys, dim=-1).indices))
    stages_n = Ks.bit_length() * (Ks.bit_length() - 1) // 2
    wide, wide_ms = {}, {}
    for kw in GSM_WIDE_K:
        rows = max(1, min(4, Gs * Ks // kw))
        wk = keys.reshape(-1)[: rows * kw].reshape(rows, kw)
        wv = payload_f.reshape(-1)[: rows * kw].reshape(rows, kw)
        got = bitonic_sort_kernel(wk, wv)
        want = bitonic_sort_plain(wk, wv)
        sync()
        wide[kw] = bool(torch.equal(bits(got[0]), bits(want[0]))
                        and torch.equal(bits(got[1]), bits(want[1]))
                        and torch.equal(bits(got[0]), bits(torch.sort(wk, dim=-1).values)))
        # Timed on the table cut into as many whole rows of kw as it holds.
        cut = Gs * Ks // kw * kw
        tk, tv = keys.reshape(-1)[:cut].view(-1, kw), payload_f.reshape(-1)[:cut].view(-1, kw)
        wide_ms[kw] = time_ms(lambda: bitonic_sort_kernel(tk, tv))
    emit({"phase": "gsm", "shape": [Gs, Ks], "live_entries": live, "launches": gsm_launches,
          "bitwise_vs_plain": same_plain, "keys_bitwise_vs_torch_sort": same_lib,
          "live_keys_in_table_order": live_order, "payload_carries_its_key": carried,
          "wide_rows_bitwise_vs_plain": {str(k): v for k, v in wide.items()},
          "wide_ms": {str(k): v for k, v in wide_ms.items()},
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "compare_exchanges": stages_n * (Ks // 2) * Gs})
    check(same_plain, "gsm: bitonic kernel differs from its plain version")
    check(same_lib, "gsm: bitonic keys differ from torch.sort")
    check(live_order and carried, "gsm: sorted keys leave the bin table's depth order")
    for kw, ok in wide.items():
        check(ok, f"gsm: bitonic kernel differs from its plain version at K = {kw}")
    check(gsm_launches["bitonic_sort"] > 0, "gsm: bitonic_sort was not launched")

    # The package's edge-case rows, K = 1 .. 65536: bit for bit.
    edge = {"cases": 0, "words": 0, "differing_words": 0, "differing_cases": []}
    for p in range(GSM_EDGE_MAX_LOG2 + 1):
        k_e, v_e = edge_case_rows(2**p, torch.Generator().manual_seed(p))
        want = bitonic_sort_plain(k_e, v_e)
        got = bitonic_sort_kernel(k_e.to(dev), v_e.to(dev))
        bad = sum(int((bits(g).cpu() != bits(w)).sum()) for g, w in zip(got, want))
        edge["cases"] += 1
        edge["words"] += 2 * k_e.numel()
        edge["differing_words"] += bad
        if bad:
            edge["differing_cases"].append(f"K={2**p}: {bad}")
    emit({"phase": "gsm", "check": "gsm_edge_cases", **edge})
    check(edge["differing_words"] == 0, f"gsm_edge_cases: {edge['differing_cases']}")
    kernels["bitonic_sort"] = dict(
        max_abs_err=float((sk - pk).abs().nan_to_num().max()), ms=ms, plain_ms=plain_ms,
        nbytes=4 * Gs * Ks * 4, ops=stages_n * (Ks // 2) * Gs, library_ms=library_ms)
    oracle_frame.update(keys=keys.cpu(), payload=payload_f.cpu())
    del keys, payload, payload_f, sk, sv, pk, pv, lib, table_keys, perm

    # -- 3. the main path ----------------------------------------------------
    with engine.open(scene, cfg, device=dev) as renderer:
        build.reset_launches()
        out = renderer.render(cam)
        sync()
        main_launches = dict(build.LAUNCHES)
        stats = out.stats.as_dict()
        img = out.image

        def frame():
            renderer.render(cam)
            sync()

        frame()
        frame_times = []
        for _ in range(REPS):
            t = time.perf_counter()
            frame()
            frame_times.append((time.perf_counter() - t) * 1e3)
    finite = bool(torch.isfinite(img).all())
    emit({"phase": "render", "gaussians": n_main, "width": width, "height": height,
          "config": CFG_KW, "backend": "cuda", "image_shape": list(img.shape),
          "image_finite": finite, "image_mean": float(img.mean()),
          "frame_ms_median": statistics.median(frame_times), "frame_ms": frame_times,
          "stats": stats, "launches": main_launches,
          "groups": G, "max_group_len": int(lengths.max()),
          "p99_group_len": float(torch.quantile(lengths, 0.99)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if on_card else None})
    check(tuple(img.shape) == (height, width, 3) and finite, "render: bad image")
    check(stats["overflow"] == 0, f"render: overflow {stats['overflow']}")
    for k in ("bitmask_gen", "raster_group_fused"):
        check(main_launches[k] > 0, f"render: kernel {k} was not launched")

    # -- where the frame's time goes: each stage on its own ------------------
    backend = get_backend("cuda")
    stage_ms = {}

    def stage(name, fn):
        stage_ms[name] = time_ms(fn, reps=5)
        return fn()

    proj = stage("project", lambda: backend.project(scene, cam))
    pairs = stage("identify", lambda: backend.identify(proj, grid, "group", cfg.boundary_group))
    table = stage("bin", lambda: backend.bin(pairs, grid.num_groups, cfg.group_capacity))
    masks = stage("bitmask", lambda: backend.bitmasks(proj, table, grid, cfg.boundary_tile,
                                                      chunk=cfg.chunk))
    comp = stage("compact", lambda: backend.compact(table, masks, grid, cfg.tile_capacity))
    stage("rasterize", lambda: backend.rasterize_groups(
        proj, table, masks, comp, grid, background=None, chunk=cfg.chunk,
        early_exit=cfg.early_exit, tile_capacity=cfg.tile_capacity))
    emit({"phase": "stages", "device_ms": stage_ms, "sum_ms": sum(stage_ms.values()),
          "frame_ms_median": statistics.median(frame_times),
          "candidate_pairs": int(pairs.bin_id.numel())})
    del proj, pairs, table, masks, comp

    # -- batch: render_batch and submit on four cameras near the main one ----
    # The main camera, then three beside it.
    cams = eval_cameras(spec.extent, BATCH_AZIMUTHS_DEG, width, height)
    with engine.open(scene, cfg, device=dev, max_batch=len(cams), max_wait=60.0) as handle:
        singles = [handle.render(c) for c in cams]
        sync()
        build.reset_launches()
        t = time.perf_counter()
        batch = handle.render_batch(cams, pad_to=len(cams))
        sync()
        batch_ms = (time.perf_counter() - t) * 1e3
        batch_launches = dict(build.LAUNCHES)
        misses = handle.cache_info()["misses"]
        # The host copy the submit worker makes of the stacked lanes, alone.
        t = time.perf_counter()
        batch.map(torch.Tensor.cpu)
        host_copy_ms = (time.perf_counter() - t) * 1e3
        build.reset_launches()
        # The submits' own request spans (queue, batch wait, device + host
        # copy, resolve), on a tracer of their own.
        prev_tracer = set_tracer(Tracer(enabled=True))
        try:
            t = time.perf_counter()
            futs = [handle.submit(cams[0])]
            first_submit_ms = (time.perf_counter() - t) * 1e3   # starts the worker
            futs += [handle.submit(c) for c in cams[1:]]
            results = [f.result(timeout=300) for f in futs]
            submit_ms = (time.perf_counter() - t) * 1e3
            submit_spans = submit_breakdown(get_tracer().events())
        finally:
            set_tracer(prev_tracer)
        submit_launches = dict(build.LAUNCHES)
        hstats = handle.stats()
        misses_after = handle.cache_info()["misses"]
    names = list(singles[0].stats.as_dict())
    lane_equal, submit_equal = [], []
    for i, one in enumerate(singles):
        lane_stats = {k: int(getattr(batch.stats, k)[i]) for k in names}
        lane_equal.append(bool(torch.equal(batch.image[i], one.image))
                          and lane_stats == one.stats.as_dict())
        sub_stats = {k: int(getattr(results[i].stats, k)) for k in names}
        submit_equal.append(bool(torch.equal(results[i].image, batch.image[i].cpu()))
                            and sub_stats == lane_stats
                            and results[i].image.device.type == "cpu")
    counters = {k: hstats[k] for k in ("submitted", "completed", "batches", "padded_lanes")}
    emit({"phase": "batch", "gaussians": n_main, "width": width, "height": height,
          "azimuths_deg": BATCH_AZIMUTHS_DEG,
          "lane_overflow": [int(v) for v in batch.stats.overflow.tolist()],
          "lanes_bitwise_vs_render": lane_equal, "submits_bitwise_vs_lanes": submit_equal,
          "handle_counters": counters, "cache_misses_before_after_submits": [misses, misses_after],
          "batch_ms": batch_ms, "submit_to_result_ms": submit_ms,
          "submit_breakdown": {"first_submit_call_ms": first_submit_ms,
                               "host_copy_ms": host_copy_ms, **submit_spans},
          "batch_launches": batch_launches, "submit_launches": submit_launches})
    check(all(lane_equal), f"batch: render_batch lanes differ from render: {lane_equal}")
    check(all(submit_equal), f"batch: submit results differ from the lanes: {submit_equal}")
    check(counters == {"submitted": 4, "completed": 4, "batches": 1, "padded_lanes": 0},
          f"batch: handle counters {counters}")
    check(misses_after == misses, "batch: the submits built a new renderer")
    for k in ("bitmask_gen", "raster_group_fused"):
        check(batch_launches[k] == len(cams) and submit_launches[k] == len(cams),
              f"batch: kernel {k} launched {batch_launches[k]}/{submit_launches[k]} times")
    del singles, results

    # -- 4. cuda backend against the reference backend, on the card ----------
    ref = render(scene, cam, RenderConfig(backend="reference", **CFG_KW))
    ref_stats = ref.stats.as_dict()
    err = float((ref.image - img).abs().max())
    exact = ("n_visible", "n_candidate_tests", "n_pairs_sort", "sort_ops", "span_overflow",
             "n_bit_tests", "fifo_ops", "tile_entries", "overflow")
    mismatched = {k: (stats[k], ref_stats[k]) for k in exact if stats[k] != ref_stats[k]}
    rel = {k: abs(stats[k] - ref_stats[k]) / max(ref_stats[k], 1)
           for k in ("alpha_ops", "blend_ops")}
    emit({"phase": "parity", "image_max_abs": err, "frontend_mismatches": mismatched,
          "raster_counter_rel_diff": rel, "reference_stats": ref_stats})
    check(not mismatched, f"parity: counters differ {mismatched}")
    check(err <= IMAGE_TOL, f"parity: image max abs {err} > {IMAGE_TOL}")
    check(max(rel.values()) <= COUNTER_RTOL, f"parity: raster counters differ {rel}")
    main_image = img
    main_one = out                       # the D = 1 frame the sharded phase matches
    del ref, out, img, front, gtable

    # -- 5. losslessness on the card -------------------------------------------
    # gstg == tile_baseline holds when no list is cut. At the main camera a
    # few near-camera gaussians outgrow the static span window, which drops
    # group-aligned bins in gstg and tile-aligned bins in the baseline, so
    # the two lose different entries. From twice as far away no gaussian's
    # 3-sigma box exceeds the window (checked: span_overflow == 0 on both).
    eye_l = (0.0, spec.extent * 0.7, spec.extent * 3.0)
    cam_l = make_camera(eye_l, (0, 0, 0), width, height, fov_x_deg=62.0)
    scene_l = scene_like_paper("train", n_lossless, device=dev)
    cfg_base = RenderConfig(**{**CFG_KW, "mode": "tile_baseline"}, backend="cuda")
    ours = render(scene_l, cam_l, cfg)
    build.reset_launches()
    base = render(scene_l, cam_l, cfg_base)
    sync()
    tile_launches = dict(build.LAUNCHES)
    same = bool(torch.equal(ours.image, base.image))
    s_ours, s_base = ours.stats.as_dict(), base.stats.as_dict()
    frame_ms = {name: time_ms(lambda c=c: render(scene_l, cam_l, c))
                for name, c in (("gstg", cfg), ("tile_baseline", cfg_base))}
    emit({"phase": "lossless", "gaussians": n_lossless, "eye": eye_l,
          "bitwise_equal": same, "max_abs": float((ours.image - base.image).abs().max()),
          "frame_ms_median": frame_ms,
          "gstg_over_tile_baseline": frame_ms["gstg"] / frame_ms["tile_baseline"],
          "gstg_stats": s_ours, "tile_baseline_stats": s_base,
          "tile_baseline_launches": tile_launches})
    check(same, "lossless: gstg and tile_baseline images differ")
    for s in (s_ours, s_base):
        check(s["overflow"] == 0 and s["span_overflow"] == 0,
              f"lossless: a list was cut (overflow {s['overflow']}, "
              f"span_overflow {s['span_overflow']})")
    check(s_ours["tile_entries"] == s_base["tile_entries"], "lossless: tile lists differ")
    check(tile_launches["raster_tile"] > 0, "lossless: raster_tile was not launched")

    # The cost model on both frames' counters (core/cost_model.py).
    costs = {"gstg": estimate(ours.stats, GSTG_ASIC, mode="gstg").as_dict(),
             "tile_baseline": estimate(base.stats, GSTG_ASIC, mode="tile_baseline").as_dict()}
    emit({"phase": "cost_model", "hardware": GSTG_ASIC.name,
          "note": "the model's estimates for the paper's ASIC from this run's counters, "
                  "not times measured on this card", **costs})
    check(all(math.isfinite(v) and v >= 0 for c in costs.values() for v in c.values())
          and all(c["total_s"] > 0 and c["energy_j"] > 0 for c in costs.values()),
          f"cost_model: an estimate is not finite, or a total not positive: {costs}")
    check(costs["gstg"]["total_s"] < costs["tile_baseline"]["total_s"],
          "cost_model: gstg's modelled total is not below tile_baseline's")

    # -- sharded: logical shards of the gaussian axis, against D = 1 ---------
    sharded_launches, d2_frame = sharded_phase(dev, on_card, check, cfg, scene, cam, cams,
                                               main_one, batch, scene_l, cam_l, ours)
    del ours

    # -- timed: fenced per-stage spans, bitwise against this run's frames ----
    timed_phase(dev, on_card, check, smi, cfg, scene, cam, cams, main_one, d2_frame, batch,
                scene_l, cam_l, base, width, height)
    del scene_l, scene, batch, main_one, d2_frame, base

    # -- serve: the serving tier at the paper's scene sizes -------------------
    served_launches = serve_phase(dev, on_card, check, smi, width, height)

    # -- autotune: tile parameters tuned for the main frame --------------------
    autotune_launches = autotune_phase(dev, on_card, check, smi, width, height)

    # -- gateway: a worker fleet with failover, the gateway CLI, a checkpoint ---
    gateway_launches = gateway_phase(dev, on_card, check, smi, width, height)

    # -- mesh: rendering over several devices (virtual, mixed, several cards) ---
    mesh_launches = mesh_phase(dev, on_card, check, smi, width, height, n_main, n_lossless)

    # -- 6. scene training at the main path's size, outside inference mode ----
    with torch.inference_mode(False):
        train_phase(dev, on_card, check, cam, main_image.clone(), n_main, width, height)
    del main_image

    # -- 7. the LM serving path at full width (no GS-TG kernel on it) ------------
    lm_launches = lm_phase(dev, on_card, check, smi)

    # -- 8. LM training at full width (no GS-TG kernel on it), outside inference
    # mode: autograd saves no inference tensor --------------------------------
    with torch.inference_mode(False):
        lm_train_launches = lm_train_phase(dev, on_card, check, smi, time_ms)

    # -- 9. the LM steps over a mesh of the card (no GS-TG kernel on it),
    # outside inference mode ---------------------------------------------------
    with torch.inference_mode(False):
        lm_mesh_launches = lm_mesh_phase(dev, on_card, check, smi)

    # -- 10. the dry-run tools and the kernels' dense oracles ---------------------
    dryrun_launches = dryrun_phase(dev, on_card, check, smi, oracle_frame)
    del oracle_frame

    # -- 11. every ported kernel -------------------------------------------------
    replaces = {
        "bitmask_gen": ("src/repro/kernels/bitmask_gen.py:74", "gstg"),
        "raster_group_fused": ("src/repro/kernels/raster_tile.py:229", "gstg"),
        "raster_tile": ("src/repro/kernels/raster_tile.py:175", "tile_baseline"),
        "bitonic_sort": ("src/repro/kernels/bitonic_sort.py:57", "gsm"),
    }
    source = {"bitmask_gen": "src/repro_torch/csrc/bitmask_gen.cu",
              "raster_group_fused": "src/repro_torch/csrc/raster_tile.cu",
              "raster_tile": "src/repro_torch/csrc/raster_tile.cu",
              "bitonic_sort": "src/repro_torch/csrc/bitonic_sort.cu"}
    path_launches = {"gstg": main_launches, "tile_baseline": tile_launches,
                     "gsm": gsm_launches}
    rows = []
    for name, k in kernels.items():
        bound_ms, bound_by = bound(k["nbytes"], k["ops"])
        path = replaces[name][1]
        launches = path_launches[path][name]
        rows.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name][0], "path": path, "launches": launches,
            "launches_sharded": sharded_launches[name],
            "launches_served": served_launches[name],
            "launches_autotune": autotune_launches[name],
            "launches_gateway": gateway_launches[name],
            "launches_mesh": mesh_launches[name],
            "launches_lm": lm_launches[name],
            "launches_lm_train": lm_train_launches[name],
            "launches_lm_mesh": lm_mesh_launches[name],
            "launches_dryrun": dryrun_launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": k.get("library_ms"),
        })
    print(smi, flush=True)
    emit({"kernels": rows})

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
