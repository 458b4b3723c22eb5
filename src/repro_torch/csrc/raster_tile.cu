// Rasterization Module (RM, paper Fig 10) for Hopper: both raster kernels.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/raster_tile.py:
//   * raster_group_fused_kernel (the fused GS-TG RM, stages 5 + 6): one block
//     per (group, member tile) streams the GROUP's depth-sorted list and keeps
//     an entry only if its mask bit for this tile and its valid flag are set,
//     clamping the tile's virtual FIFO at tile_capacity;
//   * raster_tile_kernel: one block per tile over a compacted per-tile list,
//     no mask filter (tile_baseline, and group_baseline with groups as tiles).
// Both share one __device__ blend (raster_body).
//
// Design: one thread per pixel (a thread owns NPIX pixels when a tile has
// more than 256 of them). Each chunk of `chunk` entries is staged once into
// shared memory (mean, conic, opacity, rgb, valid, mask: 11 words an entry)
// and every thread walks it in order, blending SEQUENTIALLY like the original
// 3D-GS CUDA rasterizer: t_before = T; ...; T *= (1 - alpha). Because every
// thread walks the same entries, each computes the tile's FIFO position
// `kept` itself, with no communication. A masked-out entry has alpha 0 and
// multiplies T by exactly 1.0, so the fused kernel gives images bit-identical
// to the tile kernel on the compacted lists: the paper's losslessness holds
// on the card. (The TPU kernel's per-chunk exclusive cumprod reassociates
// against this; the plain PyTorch versions follow the cumprod, and the two
// agree to float32 rounding.)
//
// Early exit as on the TPU: each entry's weight is gated on its own
// T_before > T_EPS, and a chunk is skipped when no pixel of the block is
// alive (__syncthreads_or), which changes no counter. The walk also stops
// after the block's last entry with opacity > 0: later entries are no-ops.
//
// Bound: the alpha and blend arithmetic (about 15 float32 operations and one
// expf per (pixel, entry) alpha test) on the data this frame needs; the
// bytes (the feature rows of each list, read once) are far smaller. Each
// block re-reads its group's list from L2 — sharing one staged chunk across
// the gf^2 member tiles is the next design step.
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
// Staged words per entry: mx, my, ca, cb, cc, op, r, g, b, valid, mask.
constexpr int ROWS = 11;
constexpr int MAX_THREADS = 256;
constexpr int MAX_CHUNK = 1024;  // 11 * 1024 * 4 bytes < 48 KB static limit

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// One block rasterizes one tile of NPIX * blockDim.x pixels over the list
// f (16, K) [+ mask (K)], writing out (4, P) and counts (2).
template <int NPIX, bool FUSED>
__device__ __forceinline__ void raster_body(
    const float* __restrict__ f, const uint32_t* __restrict__ mask, int K,
    float ox, float oy, int tile_px, int chunk, uint32_t tile_bit,
    int tile_capacity, bool early_exit, float* __restrict__ out,
    int32_t* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  __shared__ int s_counts[2];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int P = NPIX * nthreads;

  // Walk only up to the last entry with opacity > 0 (or NaN): the rest are
  // no-ops for every output and counter.
  if (tid == 0) {
    s_last = 0;
    s_counts[0] = 0;
    s_counts[1] = 0;
  }
  __syncthreads();
  int last = 0;
  for (int k = tid; k < K; k += nthreads) {
    if (!(f[(size_t)F_OPACITY * K + k] <= 0.0f)) last = k + 1;
  }
  if (last > 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n_walk = min(K, (s_last + chunk - 1) / chunk * chunk);

  float px[NPIX], py[NPIX], T[NPIX], cr[NPIX], cg[NPIX], cb[NPIX];
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int p = j * nthreads + tid;
    px[j] = ox + ((float)(p % tile_px) + 0.5f);
    py[j] = oy + ((float)(p / tile_px) + 0.5f);
    T[j] = 1.0f;
    cr[j] = 0.0f;
    cg[j] = 0.0f;
    cb[j] = 0.0f;
  }
  int a_ops = 0, b_ops = 0, kept = 0;

  float* s_row = smem;  // ROWS rows of `chunk` words
  for (int c0 = 0; c0 < n_walk; c0 += chunk) {
    bool any_live = true;
    if (early_exit) {
      bool mine = false;
#pragma unroll
      for (int j = 0; j < NPIX; ++j) mine |= T[j] > T_EPS;
      any_live = __syncthreads_or(mine);
    } else {
      __syncthreads();
    }
    if (!any_live) break;  // uniform across the block
    for (int i = tid; i < chunk; i += nthreads) {
      const int k = c0 + i;
      s_row[0 * chunk + i] = f[(size_t)F_MEAN_X * K + k];
      s_row[1 * chunk + i] = f[(size_t)F_MEAN_Y * K + k];
      s_row[2 * chunk + i] = f[(size_t)F_CONIC_A * K + k];
      s_row[3 * chunk + i] = f[(size_t)F_CONIC_B * K + k];
      s_row[4 * chunk + i] = f[(size_t)F_CONIC_C * K + k];
      s_row[5 * chunk + i] = f[(size_t)F_OPACITY * K + k];
      s_row[6 * chunk + i] = f[(size_t)F_RGB_R * K + k];
      s_row[7 * chunk + i] = f[(size_t)F_RGB_G * K + k];
      s_row[8 * chunk + i] = f[(size_t)F_RGB_B * K + k];
      s_row[9 * chunk + i] = f[(size_t)F_VALID * K + k];
      s_row[10 * chunk + i] = FUSED ? __uint_as_float(mask[k]) : 0.0f;
    }
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float op = s_row[5 * chunk + i];
      if (FUSED) {
        // GS-TG RM filter + virtual FIFO clamp, as in the TPU kernel.
        bool stream = ((__float_as_uint(s_row[10 * chunk + i]) >> tile_bit) & 1u) &&
                      s_row[9 * chunk + i] > 0.5f;
        if (stream && tile_capacity >= 0) {
          stream = kept < tile_capacity;
          kept += 1;
        }
        if (!stream) continue;  // alpha 0: T *= 1, nothing counted
      }
      if (op <= 0.0f) continue;  // alpha 0 and not counted
      const float mx = s_row[0 * chunk + i], my = s_row[1 * chunk + i];
      const float ca = s_row[2 * chunk + i], cbq = s_row[3 * chunk + i];
      const float cc = s_row[4 * chunk + i];
      const float r = s_row[6 * chunk + i], g = s_row[7 * chunk + i];
      const float b = s_row[8 * chunk + i];
#pragma unroll
      for (int j = 0; j < NPIX; ++j) {
        const float dx = px[j] - mx, dy = py[j] - my;
        const float q = ca * dx * dx + 2.0f * cbq * dx * dy + cc * dy * dy;
        float a = nan_min(op * expf(-0.5f * q), ALPHA_MAX);
        if (q > QMAX || a < ALPHA_MIN) a = 0.0f;
        const float t_before = T[j];
        const bool live = !early_exit || t_before > T_EPS;
        const float w = live ? a * t_before : 0.0f;
        cr[j] = cr[j] + w * r;
        cg[j] = cg[j] + w * g;
        cb[j] = cb[j] + w * b;
        T[j] = T[j] * (1.0f - a);
        a_ops += live && op > 0.0f;
        b_ops += w > 0.0f;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int p = j * nthreads + tid;
    out[0 * P + p] = cr[j];
    out[1 * P + p] = cg[j];
    out[2 * P + p] = cb[j];
    out[3 * P + p] = T[j];
  }
  if (a_ops) atomicAdd(&s_counts[0], a_ops);
  if (b_ops) atomicAdd(&s_counts[1], b_ops);
  __syncthreads();
  if (tid == 0) {
    counts[0] = s_counts[0];
    counts[1] = s_counts[1];
  }
}

template <int NPIX>
__global__ void __launch_bounds__(MAX_THREADS)
raster_group_fused(const float* __restrict__ feat, const uint32_t* __restrict__ masks,
                   const float* __restrict__ origin, float* __restrict__ out,
                   int32_t* __restrict__ counts, int K, int tile_px, int gf,
                   int chunk, int tile_capacity, int early_exit) {
  const int slot = blockIdx.x, g = blockIdx.y, tpg = gf * gf;
  const int P = tile_px * tile_px;
  const float ox = origin[2 * g] + (float)((slot % gf) * tile_px);
  const float oy = origin[2 * g + 1] + (float)((slot / gf) * tile_px);
  const size_t item = (size_t)g * tpg + slot;
  raster_body<NPIX, true>(feat + (size_t)g * NUM_FEATURES * K, masks + (size_t)g * K,
                          K, ox, oy, tile_px, chunk, (uint32_t)slot, tile_capacity,
                          early_exit != 0, out + item * 4 * P, counts + item * 2);
}

template <int NPIX>
__global__ void __launch_bounds__(MAX_THREADS)
raster_tile(const float* __restrict__ feat, const float* __restrict__ origin,
            float* __restrict__ out, int32_t* __restrict__ counts, int K,
            int tile_px, int chunk, int early_exit) {
  const int t = blockIdx.x;
  const int P = tile_px * tile_px;
  raster_body<NPIX, false>(feat + (size_t)t * NUM_FEATURES * K, nullptr, K,
                           origin[2 * t], origin[2 * t + 1], tile_px, chunk, 0u,
                           -1, early_exit != 0, out + (size_t)t * 4 * P,
                           counts + (size_t)t * 2);
}

// Pixels per thread for a P-pixel tile: 1, 4 or 16, with at most 256
// threads a block; 0 if the tile does not split evenly.
int pixels_per_thread(int P) {
  const int options[3] = {1, 4, 16};
  for (int npix : options) {
    if (P % npix == 0 && P / npix <= MAX_THREADS) return npix;
  }
  return 0;
}

bool bad_args(int B, int K, int tile_px, int chunk) {
  return B <= 0 || K <= 0 || chunk <= 0 || chunk > MAX_CHUNK || K % chunk != 0 ||
         pixels_per_thread(tile_px * tile_px) == 0;
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
  if (bad_args(G, K, tile_px, chunk) || gf * gf > 32) return (int)cudaErrorInvalidValue;
  const int P = tile_px * tile_px, npix = pixels_per_thread(P);
  const dim3 grid(gf * gf, G);
  const size_t smem = (size_t)ROWS * chunk * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (npix == 1) {
    raster_group_fused<1><<<grid, P, smem, s>>>(feat, masks, origin, out, counts, K,
                                                tile_px, gf, chunk, tile_capacity, early_exit);
  } else if (npix == 4) {
    raster_group_fused<4><<<grid, P / 4, smem, s>>>(feat, masks, origin, out, counts, K,
                                                    tile_px, gf, chunk, tile_capacity, early_exit);
  } else {
    raster_group_fused<16><<<grid, P / 16, smem, s>>>(feat, masks, origin, out, counts, K,
                                                      tile_px, gf, chunk, tile_capacity, early_exit);
  }
  return (int)cudaGetLastError();
}

// feat (N, 16, K) f32, origin (N, 2) f32, out (N, 4, tile_px^2) f32,
// counts (N, 2) i32 = (alpha_ops, blend_ops).
int raster_tile_launch(const float* feat, const float* origin, float* out,
                       int32_t* counts, int N, int K, int tile_px, int chunk,
                       int early_exit, void* stream) {
  if (bad_args(N, K, tile_px, chunk)) return (int)cudaErrorInvalidValue;
  const int P = tile_px * tile_px, npix = pixels_per_thread(P);
  const size_t smem = (size_t)ROWS * chunk * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (npix == 1) {
    raster_tile<1><<<N, P, smem, s>>>(feat, origin, out, counts, K, tile_px, chunk, early_exit);
  } else if (npix == 4) {
    raster_tile<4><<<N, P / 4, smem, s>>>(feat, origin, out, counts, K, tile_px, chunk, early_exit);
  } else {
    raster_tile<16><<<N, P / 16, smem, s>>>(feat, origin, out, counts, K, tile_px, chunk, early_exit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
