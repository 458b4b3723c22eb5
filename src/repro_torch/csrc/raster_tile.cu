// Rasterization Module (RM, paper Fig 10) for Hopper: both raster kernels.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/raster_tile.py:
//   * raster_group_fused_kernel (the fused GS-TG RM, stages 5 + 6): each
//     member tile of a group streams the GROUP's depth-sorted list and keeps
//     an entry only if its mask bit for the tile and its valid flag are set,
//     clamping the tile's virtual FIFO at tile_capacity;
//   * raster_tile_kernel: one block per tile over a compacted per-tile list,
//     no mask filter (tile_baseline, and group_baseline with groups as tiles).
// Both blend with one __device__ step (blend_step), so they compile the same
// arithmetic. They blend SEQUENTIALLY per pixel, like the original 3D-GS
// CUDA rasterizer: t_before = T; ...; T *= (1 - alpha). A masked-out entry
// never reaches the step, so the fused kernel gives the tile kernel's rgb
// and counters bit for bit on the compacted lists (and its transmittance
// too without early exit): the paper's losslessness holds on the card. (The
// TPU kernel's per-chunk exclusive cumprod reassociates against this; the
// plain PyTorch versions follow the cumprod, and the two agree to float32
// rounding.)
//
// Early exit as on the TPU: each entry's weight is gated on its own
// T_before > T_EPS, and a tile stops at the first multiple of `chunk` in ITS
// list (the group list for the fused kernel) at which none of its pixels is
// alive. Stopping changes no rgb value and no counter, only the final T.
//
// The tile kernel: one block per tile, of as many warps as keep a thread at
// TILE_PIX pixels: two warps at 4 pixels a thread for a 16x16 tile (one warp
// at 2 for 8x8, 8 warps at 32x32, 16 warps at 8 pixels for 64x64). A tile
// whose pixels are not a whole number of warps x pixels a thread (4, 6, 12,
// 48 px, ...) leaves the last slots idle (the FULL = false instances).
//   * The list is staged in windows of TILE_WIN entries (the nine rows the
//     blend reads) with cp.async into a double buffer: the next window loads
//     while this one blends, behind one barrier of the block (the tile's
//     own warps) per window.
//   * The first window's copy goes out before the opacity scan that finds
//     the walk's end (one past the last entry with opacity > 0, or NaN), so
//     the scan's loads overlap it.
//   * The early-exit test is made lazily, as in the fused kernel: T changes
//     only at an entry with opacity > 0 (or NaN), so the test at a chunk
//     boundary is the test just before the first such entry past it. The
//     tile's warps vote with one __syncthreads_or, a barrier of two warps
//     for a 16x16 tile. Windows are a staging unit, never a vote point, so
//     any chunk that divides K (32, the window, 2,048) stops where the
//     plain version stops.
//   * Each entry's nine shared words are read once for all of a thread's
//     pixels.
// It shares only blend_step, load_entry, the constants and the copy helpers
// with the fused kernel, and none of its walk: no mask ballots, no FIFO
// clamp. On the main frame's compacted lists (8,296 tiles, K = 2,048, chunk
// 32) it takes 0.46-0.50 ms on an H100 80GB HBM3 at 700 W (PERF.md). It is
// bound by instruction issue: about 46 instructions per (pixel, entry), and
// a tile walks every pixel up to the chunk boundary where its last pixel
// dies (T has to be exact there).
//
// The fused kernel. The first design ran one block per (group, member tile).
// On the main frame (527 groups of up to 8,192 slots, 16 member tiles) each
// of the 8,432 blocks re-scanned its group's whole opacity row for the last
// live entry, re-staged every 32-entry chunk of the group list behind two
// block-wide barriers with 32 of its 256 threads loading, and tested every
// staged entry's mask bit, so a group's 16 tiles walked 16x the entries and
// the staging they blend. It took 0.999 ms for a 0.064 ms operation bound,
// 1.45x the tile kernel on the same frame's compacted lists (PERF.md).
//
// This design: one 1,024-thread block per group, two warps per 16x16
// member tile at 4 pixels a thread (in general as many warps as keep a
// thread at 4 pixels or fewer; a group whose tiles need more warps than a
// block has is split across blocks along grid.y).
//   * The group's entries are staged ONCE for all member tiles, in windows
//     of WIN entries (the nine rows the blend reads), with cp.async into a
//     double buffer: the next window loads while this one blends, behind
//     one block-wide barrier per window.
//   * For each 32 entries of the next window, a warp ballots each member
//     tile's stream word (mask bit && valid) and one opacity word
//     (opacity > 0, or NaN). A tile's warps apply its FIFO clamp to the
//     word with __popc, clearing the set bits past its remaining capacity
//     (every streamed entry takes a FIFO slot, opacity <= 0 too), and walk
//     only the bits left, in list order, with __ffs.
//   * The early-exit test is made lazily: T changes only at an entry the
//     tile blends, so the test at a chunk boundary is the test just before
//     the tile's first blended entry past it. A warp reduces its pixels
//     with __any_sync; the warps of a tile vote through shared memory and
//     one mbarrier per tile, so no block-wide barrier waits on one tile. A
//     tile also retires at a window's end when it is dead at a boundary it
//     has passed or has no mask bit left in the list; the block ends when
//     all its tiles have retired.
//   * Each tile's last mask bit is found once per group, from the mask row.
// One warp per tile at 8 pixels a thread (512 threads, no votes) and
// windows of 128 or 512 entries were measured too (PERF.md); none was
// faster. One warp a tile leaves 16 warps an SM instead of 32 to hide the
// expf and blend latency, and puts a tile's whole walk on one warp.
// Bound: the alpha and blend arithmetic (about 15 float32 operations and an
// expf per (pixel, entry)); each entry's rows are read from memory once per
// group. What is left above the bound is the walk of dead pixels up to the
// chunk boundary where a tile stops, warps idle in a window while their
// tile is dead or has few entries (the block moves window by window at its
// slowest tile's pace), and the per-entry loop overhead.
//
// Built with --fmad=false so alpha rounds operation by operation exactly as
// the plain PyTorch version computes it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5, F_RGB_R = 6, F_RGB_G = 7,
              F_RGB_B = 8, F_VALID = 15, NUM_FEATURES = 16;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float QMAX = 9.0f;
// Staged words per entry: the feature rows F_MEAN_X .. F_RGB_B.
constexpr int ROWS = 9;
// Tile sizes both kernels take: 1, 4 or 16 pixels a thread of at most
// MAX_THREADS (pixels_per_thread), so a tile has at most 64x64 pixels.
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE_PIXELS = 16 * MAX_THREADS;

constexpr int TILE_PIX = 4;         // tile kernel: pixels a thread it aims at
constexpr int TILE_MAX_WARPS = 16;  // tile kernel: warps a tile, at most
constexpr int TILE_WIN = 64;        // tile kernel: entries staged per window
constexpr int TILE_MAX_THREADS = 32 * TILE_MAX_WARPS;
static_assert(TILE_PIX <= 8 && TILE_MAX_THREADS * 8 >= MAX_TILE_PIXELS,
              "the launch picks 1, 2, 4 or 8 pixels a thread");
static_assert(TILE_WIN % 4 == 0, "a window row holds whole 16-byte vectors");

constexpr int FUSED_WARPS = 32;  // a fused block: 1,024 threads
constexpr int FUSED_THREADS = 32 * FUSED_WARPS;
constexpr int MAX_PIX_PER_THREAD = 4;
constexpr int WIN = 256;         // entries staged per window
constexpr int WORDS = WIN / 32;  // 32-entry stream words per window
static_assert(FUSED_WARPS >= WORDS, "one warp ballots each word of a window");
static_assert(FUSED_THREADS * MAX_PIX_PER_THREAD >= 16 * MAX_THREADS,
              "the largest tile the tile kernel takes fits one fused block");

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Entry {
  float mx, my, ca, cb, cc, op, r, g, b;
};

// Entry i of staged feature rows F_MEAN_X .. F_RGB_B, `stride` words apart.
__device__ __forceinline__ Entry load_entry(const float* rows, int stride, int i) {
  return {rows[F_MEAN_X * stride + i],  rows[F_MEAN_Y * stride + i],
          rows[F_CONIC_A * stride + i], rows[F_CONIC_B * stride + i],
          rows[F_CONIC_C * stride + i], rows[F_OPACITY * stride + i],
          rows[F_RGB_R * stride + i],   rows[F_RGB_G * stride + i],
          rows[F_RGB_B * stride + i]};
}

// One (pixel, entry) step of the front-to-back blend. `counted` is false
// only for a padding pixel slot past the tile (either kernel, at a tile
// size that is not a whole number of warps x pixels a thread).
__device__ __forceinline__ void blend_step(const Entry& e, float px, float py, bool counted,
                                           bool early_exit, float& T, float& cr, float& cg,
                                           float& cb, int& a_ops, int& b_ops) {
  const float dx = px - e.mx, dy = py - e.my;
  const float q = e.ca * dx * dx + 2.0f * e.cb * dx * dy + e.cc * dy * dy;
  float a = nan_min(e.op * expf(-0.5f * q), ALPHA_MAX);
  if (q > QMAX || a < ALPHA_MIN) a = 0.0f;
  const float t_before = T;
  const bool live = counted && (!early_exit || t_before > T_EPS);
  const float w = live ? a * t_before : 0.0f;
  cr = cr + w * e.r;
  cg = cg + w * e.g;
  cb = cb + w * e.b;
  T = T * (1.0f - a);
  a_ops += live && e.op > 0.0f;
  b_ops += w > 0.0f;
}

// ---------------------------------------------------------------------------
// Copy and mbarrier helpers.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy rows F_MEAN_X .. F_RGB_B of entries [w0, w0 + n) of the list f (16, K)
// into a window buffer of W entries a row, asynchronously (one commit group).
template <int W>
__device__ __forceinline__ void stage_window(float (*dst)[W], const float* f, int K, int w0,
                                             int n, bool vec) {
  if (vec) {  // K % 4 == 0 and f 16-byte aligned: whole vectors stay inside the row
    const int nv = (n + 3) / 4;
    for (int i = threadIdx.x; i < ROWS * nv; i += blockDim.x) {
      const int r = i / nv, v = i - r * nv;
      cp_async16(&dst[r][4 * v], f + (size_t)r * K + w0 + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * n; i += blockDim.x) {
      const int r = i / n, e = i - r * n;
      cp_async4(&dst[r][e], f + (size_t)r * K + w0 + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Tile kernel: one block per tile, TILE_PIX pixels a thread (two warps for a
// 16x16 tile), staging its list in windows of TILE_WIN entries.

// Thread u owns pixels j * blockDim.x + u, j < NPIX (FULL: all of them lie in
// the tile). Every thread walks every entry in list order; the walk's
// control flow is uniform across the block.
template <int NPIX, bool FULL>
__global__ void __launch_bounds__(TILE_MAX_THREADS)
raster_tile(const float* __restrict__ feat, const float* __restrict__ origin,
            float* __restrict__ out, int32_t* __restrict__ counts, int K,
            int tile_px, int chunk, int early_exit) {
  __shared__ __align__(16) float s_win[2][ROWS][TILE_WIN];
  __shared__ int s_last[TILE_MAX_THREADS / 32];
  __shared__ int s_counts[TILE_MAX_THREADS / 32][2];

  const int t = blockIdx.x, P = tile_px * tile_px;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const bool exit_on = early_exit != 0;
  const float* f = feat + (size_t)t * NUM_FEATURES * K;
  const bool vec = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(f) & 15) == 0);

  // The first window's copy goes out before the walk's length is known, and
  // the opacity scan runs while it is in flight.
  stage_window(s_win[0], f, K, 0, min(TILE_WIN, K), vec);

  // The walk ends one past the last entry with opacity > 0 (or NaN): the
  // rest are no-ops for every output and counter.
  const float* op = f + (size_t)F_OPACITY * K;
  int last = 0;
  if (vec) {
    const float4* op4 = reinterpret_cast<const float4*>(op);
#pragma unroll 4
    for (int v = tid; v < K / 4; v += nthreads) {
      const float4 o = op4[v];
      if (!(o.w <= 0.0f)) {
        last = 4 * v + 4;
      } else if (!(o.z <= 0.0f)) {
        last = 4 * v + 3;
      } else if (!(o.y <= 0.0f)) {
        last = 4 * v + 2;
      } else if (!(o.x <= 0.0f)) {
        last = 4 * v + 1;
      }
    }
  } else {
    for (int k = tid; k < K; k += nthreads) {
      if (!(op[k] <= 0.0f)) last = k + 1;
    }
  }
  last = __reduce_max_sync(~0u, last);
  if (lane == 0) s_last[warp] = last;
  cp_async_wait_all();
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) last = max(last, s_last[w]);
  const int n_walk = last;

  const float ox = origin[2 * t], oy = origin[2 * t + 1];
  float px[NPIX], py[NPIX], T[NPIX], cr[NPIX], cg[NPIX], cb[NPIX];
  bool in_tile[NPIX];
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int p = j * nthreads + tid;
    in_tile[j] = FULL || p < P;
    px[j] = ox + ((float)(p % tile_px) + 0.5f);
    py[j] = oy + ((float)(p / tile_px) + 0.5f);
    T[j] = 1.0f;
    cr[j] = 0.0f;
    cg[j] = 0.0f;
    cb[j] = 0.0f;
  }
  int a_ops = 0, b_ops = 0, next_check = 0;
  bool stopped = false;

  // Windows are a staging unit only. The early-exit test belongs to chunk
  // boundaries, and is made lazily: T changes only at an entry with opacity
  // > 0 (or NaN), so the test at a boundary is the test just before the
  // first such entry past it.
  for (int w0 = 0, buf = 0; w0 < n_walk; w0 += TILE_WIN, buf ^= 1) {
    const int nx = w0 + TILE_WIN;
    if (nx < n_walk) stage_window(s_win[buf ^ 1], f, K, nx, min(TILE_WIN, n_walk - nx), vec);
    const int n = min(TILE_WIN, n_walk - w0);
    for (int i = 0; i < n; ++i) {
      if (s_win[buf][F_OPACITY][i] <= 0.0f) continue;  // alpha 0 and not counted
      const int k = w0 + i;
      if (exit_on && k >= next_check) {
        bool alive = false;
#pragma unroll
        for (int j = 0; j < NPIX; ++j) alive |= in_tile[j] && T[j] > T_EPS;
        if (!__syncthreads_or(alive)) {
          stopped = true;
          break;
        }
        next_check = (k / chunk + 1) * chunk;
      }
      const Entry e = load_entry(&s_win[buf][0][0], TILE_WIN, i);
#pragma unroll
      for (int j = 0; j < NPIX; ++j) {
        blend_step(e, px[j], py[j], in_tile[j], exit_on, T[j], cr[j], cg[j], cb[j], a_ops,
                   b_ops);
      }
    }
    if (stopped) break;
    cp_async_wait_all();
    __syncthreads();
  }
  cp_async_wait_all();  // a stop leaves the next window's copy in flight

  float* o = out + (size_t)t * 4 * P;
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int p = j * nthreads + tid;
    if (in_tile[j]) {
      o[0 * P + p] = cr[j];
      o[1 * P + p] = cg[j];
      o[2 * P + p] = cb[j];
      o[3 * P + p] = T[j];
    }
  }
  const int a = __reduce_add_sync(~0u, a_ops), b = __reduce_add_sync(~0u, b_ops);
  if (lane == 0) {
    s_counts[warp][0] = a;
    s_counts[warp][1] = b;
  }
  __syncthreads();
  if (tid == 0) {
    int sa = 0, sb = 0;
    for (int w = 0; w < nwarps; ++w) {
      sa += s_counts[w][0];
      sb += s_counts[w][1];
    }
    counts[2 * (size_t)t] = sa;
    counts[2 * (size_t)t + 1] = sb;
  }
}

// ---------------------------------------------------------------------------
// Fused kernel helpers.

// A word warp's inputs for one 32-entry word: loaded before the walk and
// balloted after it, so the loads' latency hides behind the blend.
struct WordInputs {
  uint32_t mask = 0;
  float valid = 0.0f, op = 0.0f;
};

__device__ __forceinline__ WordInputs load_word(const float* f, const uint32_t* m, int K,
                                                int k, int n_walk) {
  WordInputs in;
  if (k < n_walk) {
    in.mask = m[k];
    in.valid = f[(size_t)F_VALID * K + k];
    in.op = f[(size_t)F_OPACITY * K + k];
  }
  return in;
}

// Lane t of the calling warp writes the stream word of member tile first + t;
// lane 0 writes the opacity word.
__device__ __forceinline__ void store_word(const WordInputs& in, int first, int n_tiles,
                                           uint32_t* stream, uint32_t* opaque) {
  const int lane = threadIdx.x & 31;
  const bool valid = in.valid > 0.5f;
  uint32_t mine = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t b = __ballot_sync(~0u, valid && ((in.mask >> (first + t)) & 1u));
    if (lane == t) mine = b;
  }
  stream[lane] = mine;
  const uint32_t ob = __ballot_sync(~0u, !(in.op <= 0.0f));
  if (lane == 0) *opaque = ob;
}

// The set bits of `word` after its first `room` (0 < room < popc(word)).
__device__ __forceinline__ uint32_t bits_past(uint32_t word, int room) {
  for (int i = 0; i < room; ++i) word &= word - 1;
  return word;
}

// Whether any pixel of a member tile is alive. Every warp of the tile calls
// it at the same points; a tile of several warps votes through shared
// memory and waits on its mbarrier (phase parity = checks made so far).
template <int NPIX>
__device__ __forceinline__ bool tile_alive(const float (&T)[NPIX], const bool (&in_tile)[NPIX],
                                           int wpt, int warp, int tip, unsigned& checks,
                                           int (*vote)[FUSED_WARPS], uint64_t* bar) {
  bool mine = false;
#pragma unroll
  for (int j = 0; j < NPIX; ++j) mine |= in_tile[j] && T[j] > T_EPS;
  bool alive = __any_sync(~0u, mine);
  if (wpt > 1) {
    const unsigned par = checks & 1u;
    if ((threadIdx.x & 31) == 0) vote[par][warp] = alive;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&bar[tip]);
    mbar_wait(&bar[tip], par);
    alive = false;
    for (int w = 0; w < wpt; ++w) alive |= vote[par][tip * wpt + w] != 0;
    ++checks;
  }
  return alive;
}

// One block per (group, run of member tiles): warps [tip * wpt, (tip + 1) *
// wpt) rasterize member tile blockIdx.y * tiles_per_block + tip. A group's
// member tiles share one block unless they need more than its 32 warps
// (tiles over 16x16, or more than 16 member tiles). Thread u of a tile owns
// pixels j * 32 * wpt + u, j < NPIX (FULL: all of them lie in the tile).
template <int NPIX, bool FULL>
__global__ void __launch_bounds__(FUSED_THREADS)
raster_group_fused(const float* __restrict__ feat, const uint32_t* __restrict__ masks,
                   const float* __restrict__ origin, float* __restrict__ out,
                   int32_t* __restrict__ counts, int K, int tile_px, int gf, int chunk,
                   int tile_capacity, int early_exit, int wpt) {
  __shared__ __align__(16) float s_win[2][ROWS][WIN];
  __shared__ uint32_t s_stream[2][WORDS][32];  // (word, tile of the block): mask bit && valid
  __shared__ uint32_t s_opaque[2][WORDS];      // word: opacity > 0 (or NaN)
  __shared__ int s_end[32];                    // tile of the block: 1 + its last mask bit
  __shared__ int s_counts[32][2];
  __shared__ int s_vote[2][FUSED_WARPS];       // multi-warp tiles: alive votes
  __shared__ uint64_t s_bar[FUSED_WARPS];      // multi-warp tiles: one mbarrier each

  const int g = blockIdx.x, tpg = gf * gf, P = tile_px * tile_px;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_per_block = FUSED_WARPS / wpt;
  const int first = blockIdx.y * tiles_per_block;
  const int n_tiles = min(tiles_per_block, tpg - first);
  const int tip = warp / wpt, u = (warp % wpt) * 32 + lane, tpt = 32 * wpt;
  const int slot = first + tip;
  const bool has_tile = tip < n_tiles;
  const float* f = feat + (size_t)g * NUM_FEATURES * K;
  const uint32_t* m = masks + (size_t)g * K;
  const bool vec = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(f) & 15) == 0);
  const bool exit_on = early_exit != 0;

  if (threadIdx.x < 32) {
    s_end[threadIdx.x] = 0;
    s_counts[threadIdx.x][0] = 0;
    s_counts[threadIdx.x][1] = 0;
  }
  if (wpt > 1 && threadIdx.x < n_tiles) mbar_init(&s_bar[threadIdx.x], wpt);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Each member tile's end, once per group: one past its last entry whose
  // mask bit is set. No entry from there on streams to the tile.
  {
    const int nwords = (K + 31) / 32;
    int end = 0;  // lane t: tile t of the block
    for (int c0 = warp; c0 < nwords; c0 += 4 * FUSED_WARPS) {
      uint32_t mw[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = (c0 + v * FUSED_WARPS) * 32 + lane;
        mw[v] = k < K ? m[k] : 0u;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        for (int t = 0; t < n_tiles; ++t) {
          const uint32_t b = __ballot_sync(~0u, (mw[v] >> (first + t)) & 1u);
          if (lane == t && b) end = (c0 + v * FUSED_WARPS) * 32 + 32 - __clz(b);
        }
      }
    }
    if (lane < n_tiles && end > 0) atomicMax(&s_end[lane], end);
  }
  __syncthreads();

  const int tile_end = has_tile ? s_end[tip] : 0;
  int n_walk = 0;
  for (int t = 0; t < n_tiles; ++t) n_walk = max(n_walk, s_end[t]);

  const float ox = origin[2 * g] + (float)((slot % gf) * tile_px);
  const float oy = origin[2 * g + 1] + (float)((slot / gf) * tile_px);
  float px[NPIX], py[NPIX], T[NPIX], cr[NPIX], cg[NPIX], cb[NPIX];
  bool in_tile[NPIX];
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int p = j * tpt + u;
    in_tile[j] = FULL || p < P;
    px[j] = ox + ((float)(p % tile_px) + 0.5f);
    py[j] = oy + ((float)(p / tile_px) + 0.5f);
    T[j] = 1.0f;
    cr[j] = 0.0f;
    cg[j] = 0.0f;
    cb[j] = 0.0f;
  }
  int a_ops = 0, b_ops = 0, kept = 0, next_check = 0;
  unsigned checks = 0;  // tile mbarrier phases used (multi-warp tiles)
  bool retired = tile_end == 0;

  if (n_walk > 0) {
    stage_window(s_win[0], f, K, 0, min(WIN, n_walk), vec);
    if (warp < WORDS) {
      const WordInputs in = load_word(f, m, K, warp * 32 + lane, n_walk);
      store_word(in, first, n_tiles, s_stream[0][warp], &s_opaque[0][warp]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int w0 = 0, buf = 0; w0 < n_walk; w0 += WIN, buf ^= 1) {
    const int nx = w0 + WIN;
    const bool more = nx < n_walk;
    WordInputs next;
    if (more) {
      stage_window(s_win[buf ^ 1], f, K, nx, min(WIN, n_walk - nx), vec);
      if (warp < WORDS) next = load_word(f, m, K, nx + warp * 32 + lane, n_walk);
    }

    if (has_tile && !retired) {
      const int n_words = min(WORDS, (min(WIN, n_walk - w0) + 31) / 32);
      for (int c = 0; c < n_words; ++c) {
        const uint32_t raw = s_stream[buf][c][tip];
        uint32_t bits = raw;
        if (tile_capacity >= 0) {  // virtual FIFO clamp
          const int n = __popc(raw), room = tile_capacity - kept;
          if (n > room) bits = room > 0 ? raw & ~bits_past(raw, room) : 0u;
          kept += n;
        }
        bits &= s_opaque[buf][c];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int k = w0 + c * 32 + b;
          if (exit_on && k >= next_check) {  // the test at every boundary passed
            if (!tile_alive(T, in_tile, wpt, warp, tip, checks, s_vote, s_bar)) {
              retired = true;
              break;
            }
            next_check = (k / chunk + 1) * chunk;
          }
          const Entry e = load_entry(&s_win[buf][0][0], WIN, c * 32 + b);
#pragma unroll
          for (int j = 0; j < NPIX; ++j) {
            blend_step(e, px[j], py[j], in_tile[j], exit_on, T[j], cr[j], cg[j], cb[j], a_ops,
                       b_ops);
          }
        }
        if (retired) break;
      }
      // Retire at the window's end: no mask bit left, or dead at a
      // boundary already passed (T cannot change before the next one).
      if (!retired && (nx >= tile_end ||
                       (exit_on && next_check <= nx &&
                        !tile_alive(T, in_tile, wpt, warp, tip, checks, s_vote, s_bar)))) {
        retired = true;
      }
    }

    if (more && warp < WORDS) {
      store_word(next, first, n_tiles, s_stream[buf ^ 1][warp], &s_opaque[buf ^ 1][warp]);
    }
    cp_async_wait_all();
    if (!__syncthreads_or(has_tile && !retired)) break;
  }

  if (has_tile) {
    float* o = out + ((size_t)g * tpg + slot) * 4 * P;
#pragma unroll
    for (int j = 0; j < NPIX; ++j) {
      const int p = j * tpt + u;
      if (in_tile[j]) {
        o[0 * P + p] = cr[j];
        o[1 * P + p] = cg[j];
        o[2 * P + p] = cb[j];
        o[3 * P + p] = T[j];
      }
    }
    const int a = __reduce_add_sync(~0u, a_ops), b = __reduce_add_sync(~0u, b_ops);
    if (lane == 0) {
      atomicAdd(&s_counts[tip][0], a);
      atomicAdd(&s_counts[tip][1], b);
    }
  }
  __syncthreads();
  if (threadIdx.x < n_tiles) {
    int32_t* c = counts + ((size_t)g * tpg + first + threadIdx.x) * 2;
    c[0] = s_counts[threadIdx.x][0];
    c[1] = s_counts[threadIdx.x][1];
  }
}

// Pixels per thread for a P-pixel tile in the tile kernel: 1, 4 or 16, with
// at most 256 threads a block; 0 if the tile does not split evenly.
int pixels_per_thread(int P) {
  const int options[3] = {1, 4, 16};
  for (int npix : options) {
    if (P % npix == 0 && P / npix <= MAX_THREADS) return npix;
  }
  return 0;
}

bool bad_args(int B, int K, int tile_px, int chunk) {
  return B <= 0 || K <= 0 || chunk <= 0 || K % chunk != 0 ||
         pixels_per_thread(tile_px * tile_px) == 0;
}

template <int NPIX, bool FULL>
void launch_fused(const float* feat, const uint32_t* masks, const float* origin, float* out,
                  int32_t* counts, int G, int K, int tile_px, int gf, int chunk,
                  int tile_capacity, int early_exit, int wpt, cudaStream_t s) {
  const int tiles_per_block = FUSED_WARPS / wpt;
  const dim3 grid(G, (gf * gf + tiles_per_block - 1) / tiles_per_block);
  raster_group_fused<NPIX, FULL><<<grid, FUSED_THREADS, 0, s>>>(
      feat, masks, origin, out, counts, K, tile_px, gf, chunk, tile_capacity, early_exit, wpt);
}

template <int NPIX>
void launch_fused(bool full, const float* feat, const uint32_t* masks, const float* origin,
                  float* out, int32_t* counts, int G, int K, int tile_px, int gf, int chunk,
                  int tile_capacity, int early_exit, int wpt, cudaStream_t s) {
  if (full) {
    launch_fused<NPIX, true>(feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
                             tile_capacity, early_exit, wpt, s);
  } else {
    launch_fused<NPIX, false>(feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
                              tile_capacity, early_exit, wpt, s);
  }
}

// The tile kernel's block: warps enough for TILE_PIX pixels a thread, at
// most TILE_MAX_WARPS (two warps for a 16x16 tile), and the pixels a thread
// that then cover the tile.
struct TileShape {
  int warps, npix;
  bool full;
};

TileShape tile_shape(int tile_px) {
  const int P = tile_px * tile_px, per_warp = 32 * TILE_PIX;
  const int warps = min(TILE_MAX_WARPS, (P + per_warp - 1) / per_warp);
  const int need = (P + 32 * warps - 1) / (32 * warps);
  const int npix = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  return {warps, npix, npix * 32 * warps == P};
}

template <int NPIX>
void launch_tile(bool full, const float* feat, const float* origin, float* out,
                 int32_t* counts, int N, int K, int tile_px, int chunk, int early_exit,
                 int warps, cudaStream_t s) {
  if (full) {
    raster_tile<NPIX, true><<<N, 32 * warps, 0, s>>>(feat, origin, out, counts, K, tile_px,
                                                      chunk, early_exit);
  } else {
    raster_tile<NPIX, false><<<N, 32 * warps, 0, s>>>(feat, origin, out, counts, K, tile_px,
                                                       chunk, early_exit);
  }
}

}  // namespace

extern "C" {

const char* gstg_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat (G, 16, K) f32, masks (G, K) u32, origin (G, 2) f32,
// out (G, gf*gf, 4, tile_px^2) f32, counts (G, gf*gf, 2) i32 = (alpha_ops,
// blend_ops). tile_capacity < 0: no FIFO clamp.
int raster_group_fused_launch(const float* feat, const uint32_t* masks,
                              const float* origin, float* out, int32_t* counts,
                              int G, int K, int tile_px, int gf, int chunk,
                              int tile_capacity, int early_exit, void* stream) {
  if (bad_args(G, K, tile_px, chunk) || gf < 1 || gf * gf > 32) {
    return (int)cudaErrorInvalidValue;
  }
  // Warps per member tile: enough for at most 4 pixels a thread (2 warps
  // for a 16x16 tile).
  const int P = tile_px * tile_px, per_warp = 32 * MAX_PIX_PER_THREAD;
  const int wpt = (P + per_warp - 1) / per_warp;
  const int need = (P + 32 * wpt - 1) / (32 * wpt);
  const int npix = need <= 1 ? 1 : need <= 2 ? 2 : 4;
  const bool full = npix * 32 * wpt == P;
  cudaStream_t s = (cudaStream_t)stream;
  if (npix == 1) {
    launch_fused<1>(full, feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
                    tile_capacity, early_exit, wpt, s);
  } else if (npix == 2) {
    launch_fused<2>(full, feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
                    tile_capacity, early_exit, wpt, s);
  } else {
    launch_fused<4>(full, feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
                    tile_capacity, early_exit, wpt, s);
  }
  return (int)cudaGetLastError();
}

// feat (N, 16, K) f32, origin (N, 2) f32, out (N, 4, tile_px^2) f32,
// counts (N, 2) i32 = (alpha_ops, blend_ops).
int raster_tile_launch(const float* feat, const float* origin, float* out,
                       int32_t* counts, int N, int K, int tile_px, int chunk,
                       int early_exit, void* stream) {
  if (bad_args(N, K, tile_px, chunk)) return (int)cudaErrorInvalidValue;
  const TileShape sh = tile_shape(tile_px);
  cudaStream_t s = (cudaStream_t)stream;
  if (sh.npix == 1) {
    launch_tile<1>(sh.full, feat, origin, out, counts, N, K, tile_px, chunk, early_exit,
                   sh.warps, s);
  } else if (sh.npix == 2) {
    launch_tile<2>(sh.full, feat, origin, out, counts, N, K, tile_px, chunk, early_exit,
                   sh.warps, s);
  } else if (sh.npix == 4) {
    launch_tile<4>(sh.full, feat, origin, out, counts, N, K, tile_px, chunk, early_exit,
                   sh.warps, s);
  } else {
    launch_tile<8>(sh.full, feat, origin, out, counts, N, K, tile_px, chunk, early_exit,
                   sh.warps, s);
  }
  return (int)cudaGetLastError();
}

// The tile kernel's launch for a tile of tile_px: shape = (threads a block,
// pixels a thread, 1 if every pixel slot lies in the tile, entries a window).
int raster_tile_shape(int tile_px, int32_t* shape) {
  if (tile_px <= 0 || pixels_per_thread(tile_px * tile_px) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const TileShape sh = tile_shape(tile_px);
  shape[0] = 32 * sh.warps;
  shape[1] = sh.npix;
  shape[2] = sh.full ? 1 : 0;
  shape[3] = TILE_WIN;
  return 0;
}

}  // extern "C"
