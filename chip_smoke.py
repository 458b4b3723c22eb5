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
                dispatch at max_batch=4) bitwise equal to render(cam_i).
  4. parity   — the same camera on the reference backend on the card:
                frontend counters equal, image within 1e-4.
  5. lossless — gstg against tile_baseline on the cuda backend (120,000
                gaussians, 1952x1088, camera twice as far so that no list
                is cut): bitwise-equal images; both frames' times (CUDA
                events, median of 10 after a warm-up) and their ratio.
  6. kernels  — every ported kernel: launches, error, times, bound,
                library time (torch.sort + gather for the bitonic sort).

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it. Without CUDA, or without the repository beside this
file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
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
    from repro_torch.configs import PAPER_SCENES
    from repro_torch.core import GridSpec, RenderConfig, make_camera, render, scene_like_paper
    from repro_torch.core.gaussians import random_scene
    from repro_torch.core.bitmask import GroupBitmasks, compact_tiles
    from repro_torch.core.pipeline import render_frontend
    from repro_torch.core.stages import get_backend
    from repro_torch.kernels import ops
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
    cam = make_camera((0.0, spec.extent * 0.35, spec.extent * 1.5), (0, 0, 0),
                      width, height, fov_x_deg=62.0)
    cfg = RenderConfig(backend="cuda", **CFG_KW)
    scene = scene_like_paper("train", n_main, device=dev)
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
    radius = math.hypot(spec.extent * 0.35, spec.extent * 1.5)
    elev = math.atan2(spec.extent * 0.35, spec.extent * 1.5)
    cams = [cam]                             # the main camera, then three beside it
    for deg in BATCH_AZIMUTHS_DEG[1:]:
        az = math.radians(deg)
        eye = (radius * math.cos(elev) * math.sin(az), radius * math.sin(elev),
               radius * math.cos(elev) * math.cos(az))
        cams.append(make_camera(eye, (0, 0, 0), width, height, fov_x_deg=62.0))
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
        build.reset_launches()
        t = time.perf_counter()
        futs = [handle.submit(c) for c in cams]
        results = [f.result(timeout=300) for f in futs]
        submit_ms = (time.perf_counter() - t) * 1e3
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
          "batch_launches": batch_launches, "submit_launches": submit_launches})
    check(all(lane_equal), f"batch: render_batch lanes differ from render: {lane_equal}")
    check(all(submit_equal), f"batch: submit results differ from the lanes: {submit_equal}")
    check(counters == {"submitted": 4, "completed": 4, "batches": 1, "padded_lanes": 0},
          f"batch: handle counters {counters}")
    check(misses_after == misses, "batch: the submits built a new renderer")
    for k in ("bitmask_gen", "raster_group_fused"):
        check(batch_launches[k] == len(cams) and submit_launches[k] == len(cams),
              f"batch: kernel {k} launched {batch_launches[k]}/{submit_launches[k]} times")
    del singles, batch, results

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
    del ref, out, img, front, gtable, scene

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

    # -- 6. every ported kernel --------------------------------------------------
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
