#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the GS-TG renderer on one GPU.

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
  7. kernels  — every ported kernel: launches on its path, on the sharded
                path, in the serve phase's realtime run, over the
                autotune phase, in the gateway's in-process run and on the
                mesh phase's (2, 2) mesh (its batch and tile_baseline
                frame), error, times,
                bound, library time (torch.sort + gather for the bitonic
                sort). The train phase launches none of them.

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it. Without CUDA, or without the repository beside this
file, it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
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
    """One call of ``fn`` under torch.profiler: its wall time, the device
    time of all its kernels, and the ``top`` kernels by device time (ms and
    launches). Operator rows are left out: they repeat their kernels'
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows),
            "top_kernels_ms": [{"kernel": k[:120], "ms": ms, "launches": n}
                               for k, ms, n in rows[:top]]}


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


def busy_share(on_card, fn, frames: int = 3) -> dict:
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
    path = ROOT / "build" / "repro_torch" / "frame_profile.json"
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

    # -- 7. every ported kernel --------------------------------------------------
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
