// Block-local top-c selection for the relaxed top-k arbitration.
//
// Replaces the TPU kernel _block_topc_kernel_batched
// (src/repro/kernels/relaxed_topk.py:134) and, as its B = 1 call,
// _block_topc_kernel (relaxed_topk.py:43).
//
// What it computes: for every (instance b, block j) of `block_size` values of
// x[b, :] (entries at index >= n count as -inf), c rounds of
//   take the max m; take the LOWEST global index i with x[i] >= m;
//   report (m, i); set x[i] = -inf.
// Once a block is exhausted every entry is -inf, so the round reports the
// block's base index, exactly as the reference kernel does.
//
// Design. One thread block per (j, b) with min(block_size, 256) threads; the
// block's values live in shared memory (<= 16 KB). Each thread keeps the best
// (value, index) pair of the entries it owns (t, t + T, t + 2T, ...) in
// registers. A round reduces those pairs with the order "greater value wins;
// equal value: lower index wins" -- warp shuffles, then across warps through
// shared memory -- and only the owner of the winner masks it and rescans its
// own <= 16 entries. IEEE `>` and `==` make -0.0 == 0.0, as `x >= m` does.
//
// Bound. The function reads B*N floats once and writes B*NB*c (value, index)
// pairs: memory-bound in principle (microseconds at 3.35 TB/s for the
// scheduler's [4, 10000] scores). The c rounds are serial and each ends in a
// block barrier, so this simple form is latency-bound instead; at the main
// path's shapes the grid (NB*B = 40 blocks) does not even fill the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void block_topc_kernel(const float* __restrict__ x,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx,
                                  int n, int block_size, int c) {
  extern __shared__ float xs[];  // block_size values of this block
  __shared__ float warp_v[kMaxThreads / 32];
  __shared__ int warp_i[kMaxThreads / 32];
  __shared__ int winner;

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int nb = gridDim.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = nthreads >> 5;
  const int base = j * block_size;
  const float* row = x + static_cast<size_t>(b) * n;
  const size_t out = (static_cast<size_t>(b) * nb + j) * c;

  // load this thread's entries and find its local best
  float best_v = -CUDART_INF_F;
  int best_i = INT_MAX;
  for (int e = t; e < block_size; e += nthreads) {
    const int g = base + e;
    const float v = g < n ? row[g] : -CUDART_INF_F;
    xs[e] = v;
    if (better(v, g, best_v, best_i)) {
      best_v = v;
      best_i = g;
    }
  }

  for (int r = 0; r < c; ++r) {
    float v = best_v;
    int i = best_i;
    warp_best(v, i);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? warp_v[lane] : -CUDART_INF_F;
      i = lane < nwarps ? warp_i[lane] : INT_MAX;
      warp_best(v, i);
      if (lane == 0) {
        winner = i;
        vals[out + r] = v;
        idx[out + r] = i;
      }
    }
    __syncthreads();
    // only the owner of the winning entry masks it and rescans its entries
    if (best_i == winner) {
      xs[winner - base] = -CUDART_INF_F;
      best_v = -CUDART_INF_F;
      best_i = INT_MAX;
      for (int e = t; e < block_size; e += nthreads) {
        const float xv = xs[e];
        if (better(xv, base + e, best_v, best_i)) {
          best_v = xv;
          best_i = base + e;
        }
      }
    }
  }
}

}  // namespace

// x f32[batch, n] (contiguous), vals f32[batch, nb, c], idx i32[batch, nb, c]
// with nb = ceil(n / block_size). Launches on `stream`; returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int relaxed_topk_blocks(const void* x, void* vals, void* idx,
                                   int batch, int n, int block_size, int c,
                                   void* stream) {
  const int nb = (n + block_size - 1) / block_size;
  const int threads = block_size < kMaxThreads ? block_size : kMaxThreads;
  const dim3 grid(nb, batch);
  block_topc_kernel<<<grid, threads, block_size * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(idx), n, block_size, c);
  return static_cast<int>(cudaGetLastError());
}
