// Bitmask Generation Module (BGM, paper Fig 10) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitmask_gen.py::bitmask_kernel.
// For every entry of a group's depth-sorted list it runs the chosen boundary
// test (aabb, obb or ellipse) against each of the gf^2 member-tile rects and
// packs the hits, ANDed with entry-valid and tile-in-image, into one 32-bit
// word: bit `slot` == the entry covers member tile `slot`.
//
// Design: one thread per (group, entry); the gf^2 tests run in a loop in
// registers and the thread writes one word. Reads are coalesced rows of the
// (G, 16, K) feature block, so the kernel is bound by the bytes it moves:
// the 3-7 feature rows its method reads plus the output word per entry. A
// test is a few tens of float32 operations, far below the card's rate.
//
// Must be built with --fmad=false: every expression keeps the JAX package's
// operation order and rounds each operation on its own, so the words are
// bit-identical to the plain PyTorch version (a fused multiply-add could
// flip a hit that sits exactly on q = 9 or on a rect edge). Division and
// sqrtf are IEEE (no --use_fast_math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_RADIUS = 9, F_EIGVEC_X = 10, F_EIGVEC_Y = 11,
              F_EIGVAL_1 = 12, F_EIGVAL_2 = 13, F_VALID = 15, NUM_FEATURES = 16;
constexpr float QMAX = 9.0f;
constexpr float SIGMA_CUT = 3.0f;
constexpr int METHOD_AABB = 0, METHOD_OBB = 1, METHOD_ELLIPSE = 2;
constexpr int THREADS = 256;

// min/max that propagate NaN like jnp.minimum / torch.minimum (fminf would
// return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ bool aabb(float mx, float my, float r, float x0,
                                     float y0, float x1, float y1) {
  return (mx + r >= x0) & (mx - r <= x1) & (my + r >= y0) & (my - r <= y1);
}

__device__ __forceinline__ bool obb(float mx, float my, float ux, float uy,
                                    float l1, float l2, float x0, float y0,
                                    float x1, float y1) {
  const float vx = -uy, vy = ux;
  const float e1 = SIGMA_CUT * sqrtf(nan_max(l1, 0.0f));
  const float e2 = SIGMA_CUT * sqrtf(nan_max(l2, 0.0f));
  const float cx = 0.5f * (x0 + x1), cy = 0.5f * (y0 + y1);
  const float hx = 0.5f * (x1 - x0), hy = 0.5f * (y1 - y0);
  const float dx = mx - cx, dy = my - cy;
  const bool sep_x = fabsf(dx) > hx + fabsf(ux) * e1 + fabsf(vx) * e2;
  const bool sep_y = fabsf(dy) > hy + fabsf(uy) * e1 + fabsf(vy) * e2;
  const bool sep_u = fabsf(dx * ux + dy * uy) > e1 + hx * fabsf(ux) + hy * fabsf(uy);
  const bool sep_v = fabsf(dx * vx + dy * vy) > e2 + hx * fabsf(vx) + hy * fabsf(vy);
  return !(sep_x | sep_y | sep_u | sep_v);
}

__device__ __forceinline__ float q_at(float A, float B, float C, float mx,
                                      float my, float px, float py) {
  const float dx = px - mx, dy = py - my;
  return A * dx * dx + 2.0f * B * dx * dy + C * dy * dy;
}

__device__ __forceinline__ bool ellipse(float mx, float my, float A, float B,
                                        float C, float x0, float y0, float x1,
                                        float y1) {
  const float C_s = fabsf(C) > 1e-12f ? C : 1e-12f;
  const float A_s = fabsf(A) > 1e-12f ? A : 1e-12f;
  const float bc = B / C_s, ba = B / A_s;
  // Vertical edges x = xe: y* = my - (B/C)(xe - mx), clamped to [y0, y1].
  const float ys0 = nan_min(nan_max(my - bc * (x0 - mx), y0), y1);
  const float ys1 = nan_min(nan_max(my - bc * (x1 - mx), y0), y1);
  // Horizontal edges y = ye: x* = mx - (B/A)(ye - my), clamped to [x0, x1].
  const float xs0 = nan_min(nan_max(mx - ba * (y0 - my), x0), x1);
  const float xs1 = nan_min(nan_max(mx - ba * (y1 - my), x0), x1);
  const float qmin = nan_min(
      nan_min(q_at(A, B, C, mx, my, x0, ys0), q_at(A, B, C, mx, my, x1, ys1)),
      nan_min(q_at(A, B, C, mx, my, xs0, y0), q_at(A, B, C, mx, my, xs1, y1)));
  const bool inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1);
  return (inside ? 0.0f : qmin) <= QMAX;
}

__global__ void __launch_bounds__(THREADS)
bitmask_gen_kernel(const float* __restrict__ feat, const float* __restrict__ origin,
                   const int32_t* __restrict__ tile_in_image, uint32_t* __restrict__ out,
                   int K, int tile_px, int gf, int method) {
  const int g = blockIdx.y;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const float* f = feat + (size_t)g * NUM_FEATURES * K + k;
  uint32_t mask = 0u;
  if (f[(size_t)F_VALID * K] > 0.5f) {
    const float mx = f[(size_t)F_MEAN_X * K];
    const float my = f[(size_t)F_MEAN_Y * K];
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    if (method == METHOD_AABB) {
      p0 = f[(size_t)F_RADIUS * K];
    } else if (method == METHOD_OBB) {
      p0 = f[(size_t)F_EIGVEC_X * K];
      p1 = f[(size_t)F_EIGVEC_Y * K];
      p2 = f[(size_t)F_EIGVAL_1 * K];
      p3 = f[(size_t)F_EIGVAL_2 * K];
    } else {
      p0 = f[(size_t)F_CONIC_A * K];
      p1 = f[(size_t)F_CONIC_B * K];
      p2 = f[(size_t)F_CONIC_C * K];
    }
    const float ox = origin[2 * g], oy = origin[2 * g + 1];
    const int tpg = gf * gf;
    for (int slot = 0; slot < tpg; ++slot) {
      if (!tile_in_image[g * tpg + slot]) continue;
      const float x0 = ox + (float)((slot % gf) * tile_px);
      const float y0 = oy + (float)((slot / gf) * tile_px);
      const float x1 = x0 + (float)tile_px, y1 = y0 + (float)tile_px;
      bool hit;
      if (method == METHOD_AABB) {
        hit = aabb(mx, my, p0, x0, y0, x1, y1);
      } else if (method == METHOD_OBB) {
        hit = obb(mx, my, p0, p1, p2, p3, x0, y0, x1, y1);
      } else {
        hit = ellipse(mx, my, p0, p1, p2, x0, y0, x1, y1);
      }
      mask |= (uint32_t)hit << slot;
    }
  }
  out[(size_t)g * K + k] = mask;
}

}  // namespace

extern "C" {

const char* gstg_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat (G, 16, K) f32, origin (G, 2) f32, tile_in_image (G, gf*gf) i32,
// out (G, K) u32; method 0 aabb, 1 obb, 2 ellipse.
int bitmask_gen_launch(const float* feat, const float* origin,
                       const int32_t* tile_in_image, uint32_t* out, int G,
                       int K, int tile_px, int gf, int method, void* stream) {
  if (gf * gf > 32 || method < METHOD_AABB || method > METHOD_ELLIPSE) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((K + THREADS - 1) / THREADS, G);
  bitmask_gen_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      feat, origin, tile_in_image, out, K, tile_px, gf, method);
  return (int)cudaGetLastError();
}

}  // extern "C"
