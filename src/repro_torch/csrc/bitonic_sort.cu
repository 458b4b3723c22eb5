// Group Sorting Module (GSM, paper Fig 10) for Hopper: a bitonic network
// that sorts each row of (G, K) float32 keys ascending and carries a 32-bit
// payload word with every key.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic_sort.py::bitonic_sort_kernel. It runs the same
// network in the same order: for k = 2, 4, ..., K and j = k/2, ..., 1, the
// element i with bit j clear is compared with i + j (= i ^ j); the pair
// sorts ascending where (i & k) == 0 and swaps when
// (asc ? lo > hi : lo < hi). Ties, +-0.0 and +inf padding therefore come out
// in the network's one fixed order, and the payload matches the TPU kernel
// word for word. The payload moves as raw 32-bit words, never as a float.
//
// What bounds it: each row's keys and payload are read once and written
// once (16 bytes a slot); the compare-exchanges, log2(K)(log2(K)+1)/2
// stages of K/2 each, are a few hundred million operations, far below the
// card's rate. So the bound is bytes. The TPU kernel reshapes the row to
// (K/2j, 2, j) so that partners sit in vregs; here instead a block keeps a
// whole row (up to SPAN slots: 128 KB of its 227 KB of shared memory) in
// dynamic shared memory and runs every stage there, 1024 threads each
// owning K/2048 pairs per stage, a __syncthreads() between stages. Device
// memory is touched once on the way in and once on the way out.
//
// A row longer than SPAN does not fit. Its network runs as: every stage
// with k <= SPAN in shared memory, SPAN-slot chunks each in its own block;
// then for each k > SPAN, the stages with j >= SPAN as global-memory passes
// (one launch per (k, j), one thread per pair), and the stages j < SPAN for
// that k again in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 16384;        // slots a block sorts in shared memory
constexpr int MAX_THREADS = 1024;
constexpr int PASS_THREADS = 256;

// The lo index of compare-exchange pair p at distance j (a power of two):
// p with a zero bit inserted at bit log2(j).
__device__ __forceinline__ int lo_index(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__device__ __forceinline__ void compare_exchange(float* keys, uint32_t* vals,
                                                 int lo, int hi, bool asc) {
  const float a = keys[lo], b = keys[hi];
  if (asc ? a > b : a < b) {
    keys[lo] = b;
    keys[hi] = a;
    const uint32_t t = vals[lo];
    vals[lo] = vals[hi];
    vals[hi] = t;
  }
}

// One block per (chunk of n slots, row). Loads the chunk, runs the stages
// k = k_first .. k_last (powers of two), starting the first at j = j_first
// and every later one at k/2, down to j = 1, and stores the chunk. Every j
// is < n, so partners stay inside the chunk; `asc` reads the slot's index
// in the whole row. keys_in/vals_in may alias keys_out/vals_out.
__global__ void bitonic_shared_kernel(const float* keys_in, const uint32_t* vals_in,
                                      float* keys_out, uint32_t* vals_out,
                                      int K, int n, int k_first, int k_last,
                                      int j_first) {
  extern __shared__ float smem[];
  float* keys = smem;
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + n);
  const size_t base = (size_t)blockIdx.y * K + (size_t)blockIdx.x * n;
  const int row_off = blockIdx.x * n;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    keys[s] = keys_in[base + s];
    vals[s] = vals_in[base + s];
  }
  __syncthreads();
  const int pairs = n >> 1;
  for (int k = k_first; k <= k_last; k <<= 1) {
    for (int j = (k == k_first ? j_first : k >> 1); j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = lo_index(p, j);
        compare_exchange(keys, vals, lo, lo + j, ((row_off + lo) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    keys_out[base + s] = keys[s];
    vals_out[base + s] = vals[s];
  }
}

// One stage (k, j) with j >= SPAN, in place in device memory: one thread
// per pair, grid (K/2 / PASS_THREADS, G).
__global__ void __launch_bounds__(PASS_THREADS)
bitonic_global_pass_kernel(float* keys, uint32_t* vals, int K, int k, int j) {
  const int p = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (p >= (K >> 1)) return;
  const size_t row = (size_t)blockIdx.y * K;
  const int lo = lo_index(p, j);
  compare_exchange(keys + row, vals + row, lo, lo + j, (lo & k) == 0);
}

cudaError_t launch_shared(const float* keys_in, const uint32_t* vals_in,
                          float* keys_out, uint32_t* vals_out, int G, int K,
                          int n, int k_first, int k_last, int j_first,
                          cudaStream_t stream) {
  const size_t smem = (size_t)n * (sizeof(float) + sizeof(uint32_t));
  // Above 48 KB a launch is refused unless the function is opted in first.
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = n / 2;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  dim3 grid(K / n, G);
  bitonic_shared_kernel<<<grid, threads, smem, stream>>>(
      keys_in, vals_in, keys_out, vals_out, K, n, k_first, k_last, j_first);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gstg_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// keys (G, K) f32 and vals (G, K) 32-bit words in; keys_out/vals_out (G, K)
// out, sorted ascending by key per row. K must be a power of two.
int bitonic_sort_launch(const float* keys, const uint32_t* vals, float* keys_out,
                        uint32_t* vals_out, int G, int K, void* stream_ptr) {
  if (G < 0 || K < 1 || (K & (K - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = K < SPAN ? K : SPAN;
  // Every stage with k <= n, in shared memory, chunk by chunk.
  cudaError_t err = launch_shared(keys, vals, keys_out, vals_out, G, K, n, 2, n, 1, stream);
  if (err != cudaSuccess) return (int)err;
  for (int k = 2 * n; k <= K; k <<= 1) {
    for (int j = k >> 1; j >= n; j >>= 1) {
      dim3 grid((K / 2 + PASS_THREADS - 1) / PASS_THREADS, G);
      bitonic_global_pass_kernel<<<grid, PASS_THREADS, 0, stream>>>(keys_out, vals_out, K, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = launch_shared(keys_out, vals_out, keys_out, vals_out, G, K, n, k, k, n / 2, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
