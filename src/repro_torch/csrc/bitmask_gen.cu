// Bitmask Generation Module (BGM, paper Fig 10) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitmask_gen.py::bitmask_kernel.
// For every entry of a group's depth-sorted list it runs the chosen boundary
// test (aabb, obb or ellipse) against each of the gf^2 member-tile rects and
// packs the hits, ANDed with entry-valid and tile-in-image, into one 32-bit
// word: bit `slot` == the entry covers member tile `slot` (slot = row * gf +
// column).
//
// The work is bound by float32 issue (under --fmad=false every multiply and
// add issues alone), not by the bytes read, so the design is about doing
// each operation once. One thread per (group, entry), one coalesced word out:
//   * gf (1..5) and the method are template parameters, dispatched once on
//     the host: the tile loops unroll, with no runtime division by gf and
//     no branch on the method.
//   * Warp 0 ballots the group's tile-in-image flags into one word in shared
//     memory; each thread ANDs its mask with it once.
//   * Work on a tile line is done once per entry and shared by the member
//     tiles on that line (a per-tile test would evaluate every interior
//     line, with its clamps, once for each of its two tiles). A gf x gf
//     group has gf + 1 vertical lines x_i = ox + i * tile_px and gf + 1
//     horizontal lines y_j. For the ellipse: per entry C_s, A_s, B / C_s,
//     B / A_s and 2B; per vertical line dx, the unclamped
//     y* = my - (B / C_s) dx, (A dx) dx and (2B) dx; per (vertical line,
//     tile row) the clamp of y* into the row and q there,
//     which the tiles left and right of the line both use; per horizontal
//     line dy, the unclamped x* = mx - (B / A_s) dy and (C dy) dy; per
//     (horizontal line, tile column) the clamp and q. A gf x gf group clamps
//     and evaluates q at 2 gf (gf + 1) points an entry instead of 4 gf^2
//     (40 instead of 64 at gf 4). Rows go top to bottom and a row's bottom
//     edge values become the next row's top, so few are live at once and
//     the gf 5 instance does not spill. aabb shares mx +- r and my +- r and
//     its column and row tests; obb its per-column and per-row centre,
//     half-size, offset, sep_x / sep_y and the projected terms of sep_u /
//     sep_v.
//
// Exactness. Built with --fmad=false and without --use_fast_math: each
// operation rounds on its own; divisions and sqrtf are IEEE. Every shared
// value is the very operation, on the very operands, that the per-tile test
// of core/boundary.py performs (the JAX package's order: q = (A dx) dx +
// ((2B) dx) dy + (C dy) dy; clamps as nan_min(nan_max(v, lo), hi); qmin =
// min(min(q(x0), q(x1)), min(q(y0), q(y1))), NaN-propagating), so every word
// is bitwise that of the plain version. The one identity it relies on: the
// per-tile test takes tile i's right edge as x0 + tile_px with x0 = ox +
// i * tile_px, and the shared form takes it as line x_{i+1} = ox + (i + 1) *
// tile_px (and likewise for rows). The two are the same float whenever the
// tile lines are integers of magnitude at most 2^24, since every sum is then
// exact. That is the kernel's precondition on `origin`, and every group of
// the pipeline meets it: ops.group_origins gives integer multiples of the
// group size.
//
// The clamp is one compare a side: !(v <= lo) ? v : lo is nan_max(v, lo)
// whenever lo is not NaN (v > lo, or v is NaN), and likewise for hi. Tile
// lines are integers by the precondition, so never NaN.
//
// Launch shape: blocks of THREADS entries of one group and no register cap,
// by measurement: 64 or 256 threads, and caps of 40 or 32 registers (which
// spill), were no faster for the ellipse (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_RADIUS = 9, F_EIGVEC_X = 10, F_EIGVEC_Y = 11,
              F_EIGVAL_1 = 12, F_EIGVAL_2 = 13, F_VALID = 15, NUM_FEATURES = 16;
constexpr float QMAX = 9.0f;
constexpr float SIGMA_CUT = 3.0f;
constexpr int METHOD_AABB = 0, METHOD_OBB = 1, METHOD_ELLIPSE = 2;
constexpr int THREADS = 128;
constexpr int MAX_GF = 5;  // 25 member tiles; 6 x 6 would outgrow the word

// min/max that propagate NaN like jnp.minimum / torch.minimum (fminf would
// return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// nan_min(nan_max(v, lo), hi) for bounds that are not NaN.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  const float a = !(v <= lo) ? v : lo;
  return !(a >= hi) ? a : hi;
}

// ---------------------------------------------------------------------------
// The shared forms: one entry's coverage word from the group's GF + 1
// vertical lines `xs` and horizontal lines `ys`.

template <int GF>
__device__ __forceinline__ uint32_t aabb_word(const float* f, int K, float mx, float my,
                                              const float (&xs)[GF + 1],
                                              const float (&ys)[GF + 1]) {
  const float r = f[(size_t)F_RADIUS * K];
  const float xp = mx + r, xm = mx - r, yp = my + r, ym = my - r;
  uint32_t cols = 0u;
#pragma unroll
  for (int i = 0; i < GF; ++i) cols |= (uint32_t)((xp >= xs[i]) & (xm <= xs[i + 1])) << i;
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < GF; ++j) {
    if ((yp >= ys[j]) & (ym <= ys[j + 1])) mask |= cols << (j * GF);
  }
  return mask;
}

template <int GF>
__device__ __forceinline__ uint32_t obb_word(const float* f, int K, float mx, float my,
                                             const float (&xs)[GF + 1],
                                             const float (&ys)[GF + 1]) {
  const float ux = f[(size_t)F_EIGVEC_X * K], uy = f[(size_t)F_EIGVEC_Y * K];
  const float l1 = f[(size_t)F_EIGVAL_1 * K], l2 = f[(size_t)F_EIGVAL_2 * K];
  const float vx = -uy, vy = ux;
  const float e1 = SIGMA_CUT * sqrtf(nan_max(l1, 0.0f));
  const float e2 = SIGMA_CUT * sqrtf(nan_max(l2, 0.0f));
  const float aux = fabsf(ux), auy = fabsf(uy), avx = fabsf(vx), avy = fabsf(vy);
  // Per column: the sep_x test, dx * ux and dx * vx, and e + hx * |.| of
  // sep_u and sep_v.
  bool sep_x[GF];
  float dxu[GF], dxv[GF], ru[GF], rv[GF];
#pragma unroll
  for (int i = 0; i < GF; ++i) {
    const float cx = 0.5f * (xs[i] + xs[i + 1]), hx = 0.5f * (xs[i + 1] - xs[i]);
    const float dx = mx - cx;
    sep_x[i] = fabsf(dx) > hx + aux * e1 + avx * e2;
    dxu[i] = dx * ux;
    dxv[i] = dx * vx;
    ru[i] = e1 + hx * aux;
    rv[i] = e2 + hx * avx;
  }
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < GF; ++j) {
    const float cy = 0.5f * (ys[j] + ys[j + 1]), hy = 0.5f * (ys[j + 1] - ys[j]);
    const float dy = my - cy;
    const bool sep_y = fabsf(dy) > hy + auy * e1 + avy * e2;
    const float dyu = dy * uy, dyv = dy * vy, su = hy * auy, sv = hy * avy;
#pragma unroll
    for (int i = 0; i < GF; ++i) {
      const bool sep_u = fabsf(dxu[i] + dyu) > ru[i] + su;
      const bool sep_v = fabsf(dxv[i] + dyv) > rv[i] + sv;
      mask |= (uint32_t)!(sep_x[i] | sep_y | sep_u | sep_v) << (j * GF + i);
    }
  }
  return mask;
}

template <int GF>
__device__ __forceinline__ uint32_t ellipse_word(const float* f, int K, float mx, float my,
                                                 const float (&xs)[GF + 1],
                                                 const float (&ys)[GF + 1]) {
  const float A = f[(size_t)F_CONIC_A * K], B = f[(size_t)F_CONIC_B * K],
              C = f[(size_t)F_CONIC_C * K];
  const float C_s = fabsf(C) > 1e-12f ? C : 1e-12f;
  const float A_s = fabsf(A) > 1e-12f ? A : 1e-12f;
  const float bc = B / C_s, ba = B / A_s, B2 = 2.0f * B;
  // Vertical line i: the unclamped y*, (A dx) dx and (2B) dx.
  float v_ys[GF + 1], v_adx[GF + 1], v_bdx[GF + 1];
#pragma unroll
  for (int i = 0; i <= GF; ++i) {
    const float dx = xs[i] - mx;
    v_ys[i] = my - bc * dx;
    v_adx[i] = A * dx * dx;
    v_bdx[i] = B2 * dx;
  }
  bool in_x[GF];
#pragma unroll
  for (int i = 0; i < GF; ++i) in_x[i] = (mx >= xs[i]) & (mx <= xs[i + 1]);
  // q on horizontal line y, at x* clamped into each column.
  auto h_row = [&](float y, float (&q)[GF]) {
    const float dy = y - my;
    const float x_s = mx - ba * dy, cdy = C * dy * dy;
#pragma unroll
    for (int i = 0; i < GF; ++i) {
      const float dx = clip(x_s, xs[i], xs[i + 1]) - mx;
      q[i] = A * dx * dx + B2 * dx * dy + cdy;
    }
  };
  float q_top[GF], q_bot[GF];
  h_row(ys[0], q_top);
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < GF; ++j) {
    h_row(ys[j + 1], q_bot);
    const bool in_y = (my >= ys[j]) & (my <= ys[j + 1]);
    // q on each vertical line, at y* clamped into this row.
    float q_v[GF + 1];
#pragma unroll
    for (int i = 0; i <= GF; ++i) {
      const float dy = clip(v_ys[i], ys[j], ys[j + 1]) - my;
      q_v[i] = v_adx[i] + v_bdx[i] * dy + C * dy * dy;
    }
#pragma unroll
    for (int i = 0; i < GF; ++i) {
      const float qmin = nan_min(nan_min(q_v[i], q_v[i + 1]), nan_min(q_top[i], q_bot[i]));
      mask |= (uint32_t)(((in_x[i] & in_y) ? 0.0f : qmin) <= QMAX) << (j * GF + i);
    }
#pragma unroll
    for (int i = 0; i < GF; ++i) q_top[i] = q_bot[i];
  }
  return mask;
}

template <int GF, int METHOD>
__global__ void __launch_bounds__(THREADS)
bitmask_gen_kernel(const float* __restrict__ feat, const float* __restrict__ origin,
                   const int32_t* __restrict__ tile_in_image, uint32_t* __restrict__ out,
                   int K, int tile_px) {
  constexpr int TPG = GF * GF;
  __shared__ uint32_t s_in_image;
  const int g = blockIdx.y;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool in = lane < TPG && tile_in_image[g * TPG + lane] != 0;
    const uint32_t word = __ballot_sync(~0u, in);
    if (lane == 0) s_in_image = word;
  }
  __syncthreads();
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const float* f = feat + (size_t)g * NUM_FEATURES * K + k;
  uint32_t mask = 0u;
  if (f[(size_t)F_VALID * K] > 0.5f) {
    const float mx = f[(size_t)F_MEAN_X * K];
    const float my = f[(size_t)F_MEAN_Y * K];
    const float ox = origin[2 * g], oy = origin[2 * g + 1];
    float xs[GF + 1], ys[GF + 1];
#pragma unroll
    for (int i = 0; i <= GF; ++i) {
      xs[i] = ox + (float)(i * tile_px);
      ys[i] = oy + (float)(i * tile_px);
    }
    if (METHOD == METHOD_AABB) {
      mask = aabb_word<GF>(f, K, mx, my, xs, ys);
    } else if (METHOD == METHOD_OBB) {
      mask = obb_word<GF>(f, K, mx, my, xs, ys);
    } else {
      mask = ellipse_word<GF>(f, K, mx, my, xs, ys);
    }
    mask &= s_in_image;
  }
  out[(size_t)g * K + k] = mask;
}

template <int GF>
void launch(int method, dim3 grid, cudaStream_t s, const float* feat, const float* origin,
            const int32_t* tile_in_image, uint32_t* out, int K, int tile_px) {
  if (method == METHOD_AABB) {
    bitmask_gen_kernel<GF, METHOD_AABB><<<grid, THREADS, 0, s>>>(feat, origin, tile_in_image,
                                                                 out, K, tile_px);
  } else if (method == METHOD_OBB) {
    bitmask_gen_kernel<GF, METHOD_OBB><<<grid, THREADS, 0, s>>>(feat, origin, tile_in_image,
                                                                out, K, tile_px);
  } else {
    bitmask_gen_kernel<GF, METHOD_ELLIPSE><<<grid, THREADS, 0, s>>>(
        feat, origin, tile_in_image, out, K, tile_px);
  }
}

}  // namespace

extern "C" {

const char* gstg_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat (G, 16, K) f32, origin (G, 2) f32 (integers of magnitude at most
// 2^24 - gf * tile_px), tile_in_image (G, gf*gf) i32, out (G, K) u32;
// method 0 aabb, 1 obb, 2 ellipse.
int bitmask_gen_launch(const float* feat, const float* origin,
                       const int32_t* tile_in_image, uint32_t* out, int G,
                       int K, int tile_px, int gf, int method, void* stream) {
  if (gf < 1 || gf * gf > 32 || method < METHOD_AABB || method > METHOD_ELLIPSE) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((K + THREADS - 1) / THREADS, G);
  cudaStream_t s = (cudaStream_t)stream;
  switch (gf) {
    case 1: launch<1>(method, grid, s, feat, origin, tile_in_image, out, K, tile_px); break;
    case 2: launch<2>(method, grid, s, feat, origin, tile_in_image, out, K, tile_px); break;
    case 3: launch<3>(method, grid, s, feat, origin, tile_in_image, out, K, tile_px); break;
    case 4: launch<4>(method, grid, s, feat, origin, tile_in_image, out, K, tile_px); break;
    default: launch<MAX_GF>(method, grid, s, feat, origin, tile_in_image, out, K, tile_px);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
