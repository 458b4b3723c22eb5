#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the GS-TG renderer on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (sm_90a). It
imports nothing of JAX or of the JAX package ``repro``. Phases, one JSON
line each:

  1. device   — the card (nvidia-smi name and power limit) and the kernels'
                build times (one nvcc per source, started together).
  2. kernel   — each CUDA kernel against its plain PyTorch version on the
                main path's inputs (bitmask: 3 methods, bit-exact; raster:
                max-abs <= 1e-4, counters within 1e-5 relative), with
                CUDA-event times (median of 10 after a warm-up).
     gsm      — the GSM entry point ops.sort_groups_bitonic on the main
                frame's group lists (527 x 8192, rows permuted): keys and
                payload bitwise equal to the plain network, keys bitwise
                equal to torch.sort, live keys in the bin table's depth
                order; then K = 16384 and 65536 (global-memory passes)
                against the plain network. Kernel, plain and torch.sort +
                gather times.
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
                is cut): bitwise-equal images.
  6. kernels  — every ported kernel: launches, error, times, bound,
                library time (torch.sort + gather for the bitonic sort).

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it. Without CUDA, or without the repository beside this
file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
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
# float32 operations of one test, counted from the CUDA sources: a boundary
# test per (entry, member tile), an alpha test per (pixel, entry) and a blend
# per contributing (pixel, entry). expf counts as one.
OPS_PER_TEST = {"aabb": 8, "obb": 54, "ellipse": 75}
# Bytes the kernels need from these inputs: the valid row over the whole
# padded list (it says which entries are live), the other rows a kernel reads
# over the live entries only, and every output in full.
ENTRY_ROWS = {"aabb": 3, "obb": 6, "ellipse": 5}  # mean x/y + the method's rows
RASTER_ROWS = 9   # mean x/y, conic a/b/c, opacity, rgb
OPS_PER_ALPHA = 17
OPS_PER_BLEND = 9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    from repro_torch.core.bitmask import GroupBitmasks, compact_tiles
    from repro_torch.core.pipeline import render_frontend
    from repro_torch.core.stages import get_backend
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmask_gen import KERNEL_METHODS, bitmask_kernel, bitmask_plain
    from repro_torch.kernels.bitonic_sort import bitonic_sort_kernel, bitonic_sort_plain
    from repro_torch.kernels.layout import LANE, pack_features
    from repro_torch.kernels.raster_tile import (
        raster_group_fused_kernel,
        raster_group_fused_plain,
        raster_tile_kernel,
        raster_tile_plain,
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
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": count, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_wall_s": round(build_wall, 3), "ptxas": ptxas})

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
    live = int(gtable.entry_valid.sum())
    valid_tests = int((gtable.entry_valid.sum(1) * in_img.sum(1)).sum())

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
        ops_n = valid_tests * OPS_PER_TEST[method]
        emit({"phase": "kernel", "kernel": "bitmask_gen", "method": method,
              "shape": list(feat.shape), "live_entries": live, "differing_words": bad, "ms": ms,
              "plain_ms": plain_ms, "bytes": nbytes, "ops": ops_n})
        check(bad == 0, f"bitmask_gen[{method}] differs from its plain version in {bad} words")
        if method == cfg.boundary_tile:
            masks_main = got
            kernels["bitmask_gen"] = dict(
                max_abs_err=float(bad), ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops_n)

    def raster_compare(name, run_k, run_p, n_outputs_bytes, in_bytes):
        out_k, cnt_k = run_k()
        out_p, cnt_p = run_p()
        sync()
        err = float((out_k - out_p).abs().max())
        ck = cnt_k.to(torch.int64).reshape(-1, 2)
        cp = cnt_p.to(torch.int64).reshape(-1, 2)
        tot_k, tot_p = ck.sum(0).tolist(), cp.sum(0).tolist()
        rel = [abs(a - b) / max(b, 1) for a, b in zip(tot_k, tot_p)]
        flips = int((ck != cp).any(1).sum())
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
    tile_live = int(ttable.entry_valid.sum())
    raster_compare(
        "raster_tile",
        lambda: raster_tile_kernel(tfeat, torigins, grid.tile, chunk=cfg.chunk),
        lambda: raster_tile_plain(tfeat, torigins, grid.tile, chunk=cfg.chunk),
        NT * (4 * P + 2) * 4,
        (NT * KT + RASTER_ROWS * tile_live) * 4 + torigins.numel() * 4,
    )
    del tfeat, ttable, feat

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

    def bits(x):
        return x.contiguous().view(torch.int32)

    same_plain = bool(torch.equal(bits(sk), bits(pk)) and torch.equal(sv, pv.to(torch.int32)))
    same_lib = bool(torch.equal(bits(sk), bits(lib.values)))
    live_order = bool(torch.equal(sk[gvalid], table_keys[gvalid]))
    carried = bool(torch.equal(front.proj.depth[sv[gvalid].long()], sk[gvalid]))
    Gs, Ks = keys.shape
    ms = time_ms(lambda: bitonic_sort_kernel(keys, payload_f))
    plain_ms = time_ms(lambda: bitonic_sort_plain(keys, payload_f))
    library_ms = time_ms(lambda: torch.gather(payload_f, -1, torch.sort(keys, dim=-1).indices))
    stages_n = Ks.bit_length() * (Ks.bit_length() - 1) // 2
    wide = {}
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
    emit({"phase": "gsm", "shape": [Gs, Ks], "live_entries": live, "launches": gsm_launches,
          "bitwise_vs_plain": same_plain, "keys_bitwise_vs_torch_sort": same_lib,
          "live_keys_in_table_order": live_order, "payload_carries_its_key": carried,
          "wide_rows_bitwise_vs_plain": {str(k): v for k, v in wide.items()},
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "compare_exchanges": stages_n * (Ks // 2) * Gs})
    check(same_plain, "gsm: bitonic kernel differs from its plain version")
    check(same_lib, "gsm: bitonic keys differ from torch.sort")
    check(live_order and carried, "gsm: sorted keys leave the bin table's depth order")
    for kw, ok in wide.items():
        check(ok, f"gsm: bitonic kernel differs from its plain version at K = {kw}")
    check(gsm_launches["bitonic_sort"] > 0, "gsm: bitonic_sort was not launched")
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
    ours = render(scene_l, cam_l, cfg)
    build.reset_launches()
    base = render(scene_l, cam_l, RenderConfig(**{**CFG_KW, "mode": "tile_baseline"},
                                                backend="cuda"))
    sync()
    tile_launches = dict(build.LAUNCHES)
    same = bool(torch.equal(ours.image, base.image))
    s_ours, s_base = ours.stats.as_dict(), base.stats.as_dict()
    emit({"phase": "lossless", "gaussians": n_lossless, "eye": eye_l,
          "bitwise_equal": same, "max_abs": float((ours.image - base.image).abs().max()),
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
        t_bytes = k["nbytes"] / PEAK_BYTES * 1e3
        t_ops = k["ops"] / PEAK_FP32 * 1e3
        path = replaces[name][1]
        launches = path_launches[path][name]
        rows.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name][0], "path": path, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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
