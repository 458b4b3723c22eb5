// Group Sorting Module (GSM, paper Fig 10) for Hopper: a bitonic network
// that sorts each row of (G, K) float32 keys ascending and carries a 32-bit
// payload word with every key.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic_sort.py::bitonic_sort_kernel. It runs the same
// network in the same order: for k = 2, 4, ..., K and j = k/2, ..., 1, the
// element i with bit j clear is compared with i + j (= i ^ j); the pair
// sorts ascending where (i & k) == 0 and swaps when
// (asc ? lo > hi : lo < hi). Ties, +-0.0, NaN and +inf padding therefore
// come out in the network's one fixed order, and the payload matches the
// TPU kernel word for word. The payload moves as raw 32-bit words, never as
// a float, and no stage uses fminf/fmaxf (they order NaN and +-0 their own
// way).
//
// What bounds it: each row's keys and payload are read once and written
// once (16 bytes a slot); the compare-exchanges, log2(K)(log2(K)+1)/2
// stages of K/2 each, are a few hundred million operations, far below the
// card's rate. So the bound is bytes. What costs the time is moving the
// row between the partners of each stage: the TPU kernel reshapes the row
// to (K/2j, 2, j) so that partners sit in vregs. Here a block sorts a chunk
// of n = min(K, SPAN) slots with the chunk held in registers, E = 32 slots
// a thread (fewer, in one warp, for chunks under 1024 slots). A slot's
// index s in the chunk has three kinds of bits:
//
//   layout P (s = tid * E + r):  bits [0, e)        register r   (E = 2^e)
//                                bits [e, e + 5)    lane of the warp
//                                bits [e + 5, L)    warp of the block
//
// A stage at distance j = 2^b then runs where bit b lives: in registers
// with no communication (b < e); through __shfl_xor_sync of key and
// payload, each lane keeping lo or hi by its own index (b a lane bit); or,
// for the W = L - e - 5 warp bits, after one round trip through shared
// memory into layout Q (s = r * T + tid), whose registers hold the top e
// bits of the index (W <= e: the warp bits and the lane bits above
// log2(T)), so that those stages run in registers too, and one back. For
// K = 8192 (256 threads): 55 of the 91 stages in registers in P, 12 in
// registers in Q, 24 through shuffles. Every layout change is a
// shared-memory round trip behind two barriers: 3 k's x 2, plus one on the
// way in and one on the way out, to keep device memory reads and writes
// coalesced. Shared memory is padded one word in 32 (s + s/32), so every
// access in these layouts is free of bank conflicts. On an H100, 32 slots
// a thread ran faster than 16 slots with 512 threads: more stages in
// registers, fewer shuffles (PERF.md).
//
// A row longer than SPAN does not fit one block. Its network runs as: every
// stage with k <= SPAN, SPAN-slot chunks each in its own block; then for
// each k > SPAN, the stages with j >= SPAN as global-memory passes (one
// launch per (k, j), one thread per pair), and the stages j < SPAN for that
// k again in the block kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 16384;        // slots a block sorts
constexpr int SLOTS = 32;          // slots a thread holds in registers
constexpr int PASS_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// The block for a chunk of 2^L slots: SLOTS slots a thread, 2^L / SLOTS
// threads; below 32 * SLOTS slots one warp with fewer slots a thread (one
// a thread, lanes past the chunk idle, for chunks shorter than a warp).
constexpr int block_threads(int L) { return (1 << L) / SLOTS <= 32 ? 32 : (1 << L) / SLOTS; }
constexpr int block_slots(int L) { return L <= 5 ? 1 : (1 << L) / block_threads(L); }
static_assert(SPAN == 1 << 14, "launch_block dispatches chunks of up to 2^14 slots");

// The lo index of compare-exchange pair p at distance j (a power of two):
// p with a zero bit inserted at bit log2(j).
__device__ __forceinline__ int lo_index(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Shared-memory word of slot s: one pad word every 32, so that 32 lanes at
// any power-of-two stride up to 32 hit 32 banks. For s and t with no bit
// in common, pad(s | t) = pad(s) + pad(t): a thread's slots are its base
// word plus a constant per register.
__host__ __device__ constexpr int pad(int s) { return s + (s >> 5); }

// Compare-exchange of two register slots: lo (a, va), hi (b, vb). The pair
// swaps when asc ? a > b : a < b; written as x > y on the pair put in
// order, so a NaN (every comparison false) never swaps. Returns whether
// the pair swapped.
__device__ __forceinline__ bool exchange(float& a, uint32_t& va, float& b, uint32_t& vb,
                                         bool asc) {
  const float x = asc ? a : b, y = asc ? b : a;
  if (x > y) {
    const float t = a;
    a = b;
    b = t;
    const uint32_t u = va;
    va = vb;
    vb = u;
    return true;
  }
  return false;
}

// Layout P: the register stages on slot bits B, B - 1, ..., 0 that are
// <= top. asc reads bit log2(k) of the row index of the pair's lo slot:
// for k >= E (UNI) that bit is the thread's own (asc_t), below it register
// r's (the thread's base is a multiple of E).
template <int E, int B, bool UNI>
__device__ __forceinline__ void register_stages_p(float (&key)[E], uint32_t (&val)[E],
                                                  bool asc_t, int k, int top) {
  if constexpr (B >= 0) {
    if (B <= top) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & (1 << B)) continue;
        exchange(key[r], val[r], key[r | (1 << B)], val[r | (1 << B)],
                 UNI ? asc_t : (r & k) == 0);
      }
    }
    register_stages_p<E, B - 1, UNI>(key, val, asc_t, k, top);
  }
}

// Layout Q (s = r * T + tid): the register stages on register bits C,
// C - 1, ..., 0 that are <= top (register bit c holds slot bit log2(T) + c).
// qrow is the row index of the thread's register 0.
template <int E, int T, int C>
__device__ __forceinline__ void register_stages_q(float (&key)[E], uint32_t (&val)[E],
                                                  int qrow, int k, int top) {
  if constexpr (C >= 0) {
    if (C <= top) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & (1 << C)) continue;
        exchange(key[r], val[r], key[r | (1 << C)], val[r | (1 << C)],
                 ((qrow | r * T) & k) == 0);
      }
    }
    register_stages_q<E, T, C - 1>(key, val, qrow, k, top);
  }
}

// Layout P: stage on lane bit d (a lane mask). Both lanes of a pair compute
// the same predicate on the same (lo, hi) pair; a lane that keeps the
// smaller key (lo of an ascending pair, hi of a descending one) takes its
// partner's slot when its own key is greater, the other when its own is
// less. All 32 lanes shuffle, also idle ones (chunks shorter than a warp).
template <int E>
__device__ __forceinline__ void shuffle_stage(float (&key)[E], uint32_t (&val)[E],
                                              int base, int lane, int d, int k) {
  const bool asc = (base & k) == 0;
  const bool keep_min = asc == ((lane & d) == 0);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const float other = __shfl_xor_sync(FULL_MASK, key[r], d);
    const uint32_t other_val = __shfl_xor_sync(FULL_MASK, val[r], d);
    const float x = keep_min ? key[r] : other, y = keep_min ? other : key[r];
    if (x > y) {
      key[r] = other;
      val[r] = other_val;
    }
  }
}

// One layout change, P to Q (TO_Q) or back: the registers to shared memory
// at their slots in one layout, and back from their slots in the other.
// pbase is the padded word of the thread's register 0 in P; in Q it is
// pad(tid). The barrier before the writes lets every thread finish reading
// the last change.
template <int E, int T, bool TO_Q>
__device__ __forceinline__ void relayout(float (&key)[E], uint32_t (&val)[E], float* skeys,
                                         uint32_t* svals, int pbase, int tid) {
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = TO_Q ? pbase + pad(r) : pad(tid) + pad(r * T);
    skeys[at] = key[r];
    svals[at] = val[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = TO_Q ? pad(tid) + pad(r * T) : pbase + pad(r);
    key[r] = skeys[at];
    val[r] = svals[at];
  }
}

// One block of T threads per (chunk of n = 2^L slots, row), E slots a
// thread (E * T = n, or one slot a thread with lanes past n idle). Loads
// the chunk, runs for each k = 2^m, m = m_first .. m_last, the stages
// j = min(k, n)/2 .. 1, and stores it. Partners stay inside the chunk;
// `asc` reads the slot's index in the whole row. keys_in/vals_in may alias
// keys_out/vals_out.
template <int E, int T>
__global__ void __launch_bounds__(T, E >= 32 ? 1 : 2)
bitonic_block_kernel(const float* keys_in, const uint32_t* vals_in, float* keys_out,
                     uint32_t* vals_out, int K, int L, int m_first, int m_last) {
  constexpr int LOG_E = log2_of(E);
  constexpr int W = log2_of(T) - 5;       // warp bits of the slot index
  static_assert(W <= LOG_E, "one layout change must bring every warp bit into registers");
  extern __shared__ float smem[];
  const int n = 1 << L;
  float* skeys = smem;
  uint32_t* svals = reinterpret_cast<uint32_t*>(smem + pad(n));
  const int tid = threadIdx.x, lane = tid & 31;
  const int row_off = blockIdx.x * n;
  const size_t gbase = (size_t)blockIdx.y * K + row_off;
  const bool active = tid * E < n;
  const int base = row_off + tid * E;     // row index of register 0, layout P
  const int pbase = pad(tid * E);

  float key[E];
  uint32_t val[E];
  // In: coalesced from device memory into shared memory, then layout P.
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (i * T + tid < n) {
      skeys[pad(tid) + pad(i * T)] = keys_in[gbase + i * T + tid];
      svals[pad(tid) + pad(i * T)] = vals_in[gbase + i * T + tid];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    key[r] = active ? skeys[pbase + pad(r)] : 0.0f;
    val[r] = active ? svals[pbase + pad(r)] : 0u;
  }

  for (int m = m_first; m <= m_last; ++m) {
    const int k = 1 << m;
    const int top = (m < L ? m : L) - 1;   // the stage bits run top .. 0
    int lane_top = top < LOG_E + 4 ? top : LOG_E + 4;
    if constexpr (W > 0) {
      if (top >= LOG_E + 5) {  // warp bits: in registers, layout Q, down to bit log2(T)
        relayout<E, T, true>(key, val, skeys, svals, pbase, tid);
        register_stages_q<E, T, LOG_E - 1>(key, val, row_off | tid, k, top - log2_of(T));
        relayout<E, T, false>(key, val, skeys, svals, pbase, tid);
        lane_top = log2_of(T) - 1;
      }
    }
    for (int b = lane_top; b >= LOG_E; --b) {
      shuffle_stage<E>(key, val, base, lane, 1 << (b - LOG_E), k);
    }
    if (k >= E) {
      register_stages_p<E, LOG_E - 1, true>(key, val, (base & k) == 0, k, top);
    } else {  // the first k of a row: each register's own direction
      register_stages_p<E, LOG_E - 1, false>(key, val, true, k, top);
    }
  }

  // Out: layout P into shared memory, then coalesced to device memory.
  __syncthreads();
  if (active) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      skeys[pbase + pad(r)] = key[r];
      svals[pbase + pad(r)] = val[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (i * T + tid < n) {
      keys_out[gbase + i * T + tid] = skeys[pad(tid) + pad(i * T)];
      vals_out[gbase + i * T + tid] = svals[pad(tid) + pad(i * T)];
    }
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
  float a = keys[row + lo], b = keys[row + lo + j];
  uint32_t va = vals[row + lo], vb = vals[row + lo + j];
  if (exchange(a, va, b, vb, (lo & k) == 0)) {
    keys[row + lo] = a;
    keys[row + lo + j] = b;
    vals[row + lo] = va;
    vals[row + lo + j] = vb;
  }
}

// Keys and payload of a chunk of n slots, padded.
size_t block_smem(int n) { return 2 * (size_t)pad(n) * sizeof(float); }

template <int L>
cudaError_t launch_block(const float* keys_in, const uint32_t* vals_in, float* keys_out,
                         uint32_t* vals_out, int G, int K, int n, int m_first, int m_last,
                         cudaStream_t stream) {
  constexpr int E = block_slots(L), T = block_threads(L);
  const size_t smem = block_smem(n);
  // Above 48 KB a launch is refused unless the function is opted in first.
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_block_kernel<E, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(K / n, G);
  bitonic_block_kernel<E, T><<<grid, T, smem, stream>>>(keys_in, vals_in, keys_out, vals_out,
                                                        K, log2_of(n), m_first, m_last);
  return cudaGetLastError();
}

// The block kernel over every chunk of n slots of each row.
cudaError_t launch_block(const float* keys_in, const uint32_t* vals_in, float* keys_out,
                         uint32_t* vals_out, int G, int K, int n, int m_first, int m_last,
                         cudaStream_t stream) {
#define GSTG_BLOCK(L) \
  launch_block<L>(keys_in, vals_in, keys_out, vals_out, G, K, n, m_first, m_last, stream)
  switch (log2_of(n)) {
    case 0: case 1: case 2: case 3: case 4: case 5: return GSTG_BLOCK(5);
    case 6: return GSTG_BLOCK(6);
    case 7: return GSTG_BLOCK(7);
    case 8: return GSTG_BLOCK(8);
    case 9: return GSTG_BLOCK(9);
    case 10: return GSTG_BLOCK(10);
    case 11: return GSTG_BLOCK(11);
    case 12: return GSTG_BLOCK(12);
    case 13: return GSTG_BLOCK(13);
    case 14: return GSTG_BLOCK(14);
  }
#undef GSTG_BLOCK
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* gstg_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// The block kernel's launch for a row of K, as shape[0..3]: threads a
// block, slots a thread holds, slots a block sorts, and bytes of dynamic
// shared memory.
int bitonic_block_shape(int K, int32_t* shape) {
  if (K < 1 || (K & (K - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int n = K < SPAN ? K : SPAN;
  const int L = log2_of(n);
  shape[0] = block_threads(L);
  shape[1] = block_slots(L);
  shape[2] = n;
  shape[3] = (int)block_smem(n);
  return (int)cudaSuccess;
}

// keys (G, K) f32 and vals (G, K) 32-bit words in; keys_out/vals_out (G, K)
// out, sorted ascending by key per row. K must be a power of two.
int bitonic_sort_launch(const float* keys, const uint32_t* vals, float* keys_out,
                        uint32_t* vals_out, int G, int K, void* stream_ptr) {
  if (G < 0 || K < 1 || (K & (K - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = K < SPAN ? K : SPAN;
  const int L = log2_of(n);
  // Every stage with k <= n, chunk by chunk.
  cudaError_t err = launch_block(keys, vals, keys_out, vals_out, G, K, n, 1, L, stream);
  if (err != cudaSuccess) return (int)err;
  for (int k = 2 * n, m = L + 1; k <= K; k <<= 1, ++m) {
    for (int j = k >> 1; j >= n; j >>= 1) {
      dim3 grid((K / 2 + PASS_THREADS - 1) / PASS_THREADS, G);
      bitonic_global_pass_kernel<<<grid, PASS_THREADS, 0, stream>>>(keys_out, vals_out, K, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = launch_block(keys_out, vals_out, keys_out, vals_out, G, K, n, m, m, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
