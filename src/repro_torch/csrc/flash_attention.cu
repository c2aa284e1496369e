// Blocked online-softmax attention (forward), GQA, causal / sliding-window /
// q_offset masks, for the prefill path.
//
// Replaces the TPU kernel `flash_attention` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it on an H100: at the serving prefill's shapes (Sq = Sk = 32
// to 2048, head dim 128) the work is 4*B*H*Sq*Sk*D operations (half under a
// causal mask) on B*(Sq*H + 2*Sk*KVH)*D inputs, so a long prefill is bound
// by operations and a short one by launch latency and bytes.  This first
// version computes in fp32 on the CUDA cores (no tensor cores), so its own
// ceiling is the 67 TFLOP/s fp32 rate, not the 989 TFLOP/s bf16 rate; the
// tensor-core version (wgmma, TMA) is later work.
//
// What the design does about it:
//  * One thread block per (q tile of 64 rows, head, batch); 4 threads per
//    query row.  The kernel reads q, k, v through their strides in the
//    (B, S, heads, D) layout, so no transposed or padded copy is made.
//  * The k loop stages 32-key tiles of K and V in shared memory as fp32; a
//    q tile is loaded once and reused for every k tile.  Row strides of
//    D + 1 floats keep the 8 rows a warp reads on distinct banks.
//  * GQA: the block of query head h reads kv head h / (H / KVH), so
//    repeated K/V is never materialized.
//  * Running max, denominator and accumulator are fp32 in registers; k
//    tiles wholly outside the causal or window mask are skipped.
//  * Masked scores never enter the sums, padded rows are never written,
//    and a fully masked row (l == 0) gives 0, not NaN, as the TPU kernel
//    and the plain version do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kLanes = 4;               // threads per query row
constexpr int kThreads = kBQ * kLanes;  // 256
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int heads, int group, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int causal,
                 int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // kBQ x (D + 1)
  float* ks = qs + kBQ * (D + 1);         // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);         // kBK x D
  float* ps = vs + kBK * D;               // kBQ x (kBK + 1)

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r;
    qs[r * (D + 1) + d] = qi < sq ? to_float(qb[qi * qss + d]) : 0.f;
  }

  const int qi = q0 + row;
  const bool row_valid = qi < sq;
  const int qpos = qi + q_offset;
  constexpr int kDims = D / kLanes;       // output dims per thread
  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;
  float m = kNegBig;
  float l = 0.f;

  // keys that any row of this tile may attend to: [k_lo, k_hi)
  const int last_row = min(q0 + kBQ, sq) - 1;
  int k_hi = sk;
  if (causal) k_hi = min(sk, last_row + q_offset + 1);
  int k_lo = 0;
  if (window) k_lo = max(0, q0 + q_offset - window + 1);

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int kj = k0 + r;
      const bool in = kj < sk;
      ks[r * (D + 1) + d] = in ? to_float(kb[kj * kss + d]) : 0.f;
      vs[r * D + d] = in ? to_float(vb[kj * vss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this row against columns lane, lane + 4, ...
    constexpr int kCols = kBK / kLanes;
    float s[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) s[t] = 0.f;
    const float* qrow = qs + row * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        s[t] += qv * ks[(lane + kLanes * t) * (D + 1) + d];
      }
    }
    float m_tile = kNegBig;
    unsigned ok_bits = 0;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int kj = k0 + lane + kLanes * t;
      bool ok = row_valid && kj < sk;
      if (causal) ok = ok && kj <= qpos;
      if (window) ok = ok && kj > qpos - window;
      s[t] = ok ? s[t] * scale : kNegBig;
      ok_bits |= (ok ? 1u : 0u) << t;
      m_tile = fmaxf(m_tile, s[t]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const float p = (ok_bits >> t) & 1u ? expf(s[t] - m_new) : 0.f;
      ps[row * (kBK + 1) + lane + kLanes * t] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * alpha + p_sum;
    m = m_new;
    __syncwarp();  // a row's 4 lanes lie in one warp

#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[j] *= alpha;
    const float* prow = ps + row * (kBK + 1);
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * D + lane;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[j] += p * vrow[kLanes * j];
    }
  }

  if (row_valid) {
    const float denom = l == 0.f ? 1.f : l;
    T* orow = o + ((static_cast<long long>(b) * sq + qi) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kDims; ++j) store(orow + lane + kLanes * j, acc[j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int heads, int kv_heads, const long long* st,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, heads,
      heads / kv_heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int batch, int sq, int sk, int heads, int kv_heads,
               const long long* st, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                                  \
  case DIM:                                                                    \
    return launch<T, DIM>(q, k, v, o, batch, sq, sk, heads, kv_heads, st,      \
                          causal, window, q_offset, scale, stream);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(48)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(96)
    REPRO_FLASH_CASE(112)
    REPRO_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); o: (B, Sq, H, D) contiguous.  The
// last dim of q, k and v is contiguous; `strides` holds, in elements, the
// batch, sequence and head strides of q, then k, then v.  dtype 0 = fp32,
// 1 = bf16.  D is a multiple of 16 up to 128 and H % KVH == 0 (the wrapper
// checks).  Returns cudaGetLastError() (or the attribute call's error).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int batch, int sq, int sk, int heads,
                                     int kv_heads, int d,
                                     const long long* strides, int causal,
                                     int window, int q_offset, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, batch, sq, sk, heads,
                                     kv_heads, strides, causal, window,
                                     q_offset, scale, s);
  }
  return dispatch_d<float>(d, q, k, v, o, batch, sq, sk, heads, kv_heads,
                           strides, causal, window, q_offset, scale, s);
}
