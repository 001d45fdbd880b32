// Tiled online-softmax attention (FlashAttention forward), f32 accumulation.
//
// Replaces the TPU kernel _flash_kernel (src/repro/kernels/flash_attention.py:30,
// launched at :127 by flash_attention).
//
// What it computes, per (batch b, query head h, query row i):
//   o[i] = sum_j softmax_j(scale * q[i] . k[j]) v[j]   over the keys j that
//   the masks keep: j < skv; causal: i >= j; window w: i - j < w (positions
//   counted from 0 for queries and keys alike). Query head h reads KV head
//   h / group. A row that keeps no key outputs 0. Inputs are f32 or bf16;
//   products and sums are f32; the output has q's dtype.
// The recurrence over key tiles is the reference's: m' = max(m, rowmax(s)),
// safe = m' if finite else 0, alpha = exp(m - safe), p = exp(s - safe),
// l' = alpha l + rowsum(p), acc' = alpha acc + p v, o = acc / l (0 if l = 0).
// Tiles that the causal or window mask hides entirely are skipped: for them
// alpha = 1 and p = 0, so skipping changes no bit.
//
// Design. One thread block of 128 threads per (64-row query tile, head,
// batch), query tiles launched longest-first so the causal tail does not
// straggle. The query tile and each 64-key tile of K and V are staged in
// shared memory as f32 (rows padded by one float, so the column reads below
// hit 32 distinct banks). Thread t owns 4 query rows (row group t / 8) and,
// of every key tile, the 8 keys t % 8 + 8 j: it computes their 32 scores
// with scalar FMAs, and the 8 threads of a row group combine row max and
// row sum with warp shuffles, so the running max and denominator stay in
// registers. The probabilities go through shared memory; thread t then
// accumulates its 4 rows times the D / 8 output columns t % 8 + 8 c in
// registers.
//
// Bound. At the serving shape (bf16, 16 query / 8 KV heads, S = 2048,
// D = 128, causal) the function does 2 S^2 H D flops against S (2 H + 2 Hkv)
// D bf16 values moved: bounded by operations on the tensor cores
// (chip_smoke.py's flash_timing phase prints the bound beside the time).
// This kernel uses the CUDA cores' f32 FMAs instead and reads shared memory
// for every FMA's operands, so it is far from that bound; tensor cores
// (wgmma), TMA staging and warp specialisation are the later work that
// closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;                        // query rows per block
constexpr int kBK = 64;                        // keys per tile
constexpr int kThreads = 128;
constexpr int kColGroups = 8;                  // threads sharing a row group
constexpr int kRows = kBQ / (kThreads / kColGroups);   // 4 rows per thread
constexpr int kCols = kBK / kColGroups;                // 8 keys per thread
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;   // element strides of batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int group, sq, skv, causal, window;   // window <= 0: no window
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// reduce over the 8 lanes of a row group (lanes that differ in bits 0..2)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kColGroups / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kColGroups / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kQS = D + 1;      // padded row strides (floats)
  constexpr int kKS = D + 1;
  constexpr int kPS = kBK + 1;
  constexpr int kOut = D / kColGroups;   // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][D + 1]
  float* ks = qs + kBQ * kQS;       // [kBK][D + 1]
  float* vs = ks + kBK * kKS;       // [kBK][D]
  float* ps = vs + kBK * D;         // [kBQ][kBK + 1]

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;
  const int q0 = iq * kBQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qpos = q0 + r;
    qs[r * kQS + d] = qpos < p.sq ? to_f32(qg[qpos * p.q_ss + d]) : 0.f;
  }

  // the keys any row of this tile can see
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1) / kBK * kBK;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int kpos = k0 + r;
      const bool in = kpos < p.skv;
      ks[r * kKS + d] = in ? to_f32(kg[kpos * p.k_ss + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[kpos * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(rg * kRows + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(cg + kColGroups * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + rg * kRows + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cg + kColGroups * j;
        bool keep = kpos < p.skv;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.window > 0) keep = keep && qpos - kpos < p.window;
        s[i][j] = keep ? s[i][j] * p.scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_cur = fmaxf(m[i], group_max(mx));
      const float safe = isfinite(m_cur) ? m_cur : 0.f;
      alpha[i] = expf(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - safe);
        rs += s[i][j];
      }
      l[i] = alpha[i] * l[i] + group_sum(rs);
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ps[(rg * kRows + i) * kPS + cg + kColGroups * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(rg * kRows + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = vs[j * D + cg + kColGroups * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + rg * kRows + i;
    if (qpos >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const float val = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
      og[qpos * p.o_ss + cg + kColGroups * c] = from_f32<T>(val);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int heads, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int head_dim, int heads, int batch,
               cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, heads, batch, stream);
    case 64: return launch<T, 64>(p, heads, batch, stream);
    case 96: return launch<T, 96>(p, heads, batch, stream);
    case 128: return launch<T, 128>(p, heads, batch, stream);
    case 160: return launch<T, 160>(p, heads, batch, stream);
    case 192: return launch<T, 192>(p, heads, batch, stream);
    case 224: return launch<T, 224>(p, heads, batch, stream);
    case 256: return launch<T, 256>(p, heads, batch, stream);
    default: return -1;
  }
}

}  // namespace

// q [batch, heads, sq, head_dim], k and v [batch, kv_heads, skv, head_dim],
// o like q; the last dimension of each is contiguous and `strides` holds the
// element strides of (batch, head, position) for q, k, v, o in that order.
// dtype 0 = float32, 1 = bfloat16 (all four tensors). window <= 0 means no
// window. Launches on `stream`; returns -1 for an unsupported dtype or
// head_dim, else the cudaGetLastError() code of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int batch, int heads, int kv_heads,
                                   int sq, int skv, int head_dim, int dtype,
                                   int causal, int window, float scale,
                                   const long long* strides, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.group = heads / kv_heads;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, head_dim, heads, batch, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, heads, batch, s);
  return -1;
}
