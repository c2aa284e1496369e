// The paper's LSTM accelerator over a whole sequence, in one launch.
//
// Replaces the TPU kernel `lstm_pallas` (body `_lstm_kernel`) at
// src/repro/kernels/lstm/kernel.py:67.  It computes what that kernel
// computes: gates i, f, g, o from x_t·W_ih + h·W_hh + b, h and c carried in
// fp32 across the sequence, and returns hs (B,S,H) and (h_N, c_N) in
// x's dtype.  The weights hold the gates as four unpadded H-wide column
// blocks [i|f|g|o]; nothing is padded to the TPU's 128 lanes.
//
// What bounds it on an H100: the chain of S dependent steps.  At the
// paper's shape (B 32, S 64, I 6, H 20) the work is about 8.5 MFLOP and
// 0.22 MB, which the card's rates would clear in about 0.13 us; but step t
// cannot start before step t-1's h is known, and each step is a short
// chain of dependent FMAs, two barriers and the transcendental functions.
// The kernel's time is 64 times the latency of one step, far above its
// bytes and operations.
//
// What the design does about it: the whole recurrence runs inside one
// launch (the TPU's sequential grid axis becomes a loop), so the chain pays
// one launch and no round trip to the host or to device memory between
// steps.  h and c stay in shared memory for all S steps, and each step's x
// is fetched during the step before it.  The grid runs over
// batch rows, which are independent, so a larger batch adds blocks, not
// steps.  Within a row, thread j computes gate pre-activation j (stride
// blockDim.x, so any H works) as two independent FMA chains (the x·W_ih and
// h·W_hh sums), unrolled so that several weight loads are in flight at
// once; then threads j < H update c and h.  Neighbouring threads read neighbouring weight columns, so the weight
// reads coalesce, and L1/L2 keep the 8.3 KB of weights across steps.  x is
// read through its (B,S,I) strides, so the TPU wrapper's transposes and
// padding copies are gone.  Arithmetic is fp32 FMA with expf and tanhf
// (no fast math), sigmoid(x) = 1/(1+expf(-x)).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxThreadsX = 256;
constexpr int kMaxRows = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

// blockDim = (threads per row, rows per block); one row of the batch for
// each threadIdx.y.  Shared memory per row, fp32: gates (4H), h (H), c (H)
// and two buffers of one step's x (2 I).
template <typename T>
__global__ void lstm_kernel(const T* __restrict__ x, const T* __restrict__ w_ih,
                            const T* __restrict__ w_hh, const T* __restrict__ bias,
                            const T* __restrict__ h0, const T* __restrict__ c0,
                            T* __restrict__ hs, T* __restrict__ h_n, T* __restrict__ c_n,
                            int batch, int seq, int in_dim, int hidden,
                            long long sx_b, long long sx_s, long long sx_i) {
  extern __shared__ float smem[];
  const int g4 = 4 * hidden;
  float* gates = smem + threadIdx.y * (6 * hidden + 2 * in_dim);
  float* h_s = gates + g4;
  float* c_s = h_s + hidden;
  float* x_s = c_s + hidden;          // x_s[(t & 1) * in_dim + k] = x[row, t, k]
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < batch;
  const T* xr = x + (live ? row * sx_b : 0);
  T* hr = hs + (live ? row * seq * hidden : 0);

  if (live) {
    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      h_s[j] = h0 ? to_float(h0[row * hidden + j]) : 0.0f;
      c_s[j] = c0 ? to_float(c0[row * hidden + j]) : 0.0f;
    }
    for (int k = threadIdx.x; k < in_dim; k += blockDim.x) x_s[k] = to_float(xr[k * sx_i]);
  }
  __syncthreads();

  for (int t = 0; t < seq; ++t) {
    const float* x_t = x_s + (t & 1) * in_dim;
    float* x_next = x_s + ((t + 1) & 1) * in_dim;
    const bool fetch = live && t + 1 < seq && (int)threadIdx.x < in_dim;
    // the next step's x is read from device memory now and stored after
    // this step's gates, so its latency hides behind them
    const float x_pre = fetch ? to_float(xr[(t + 1) * sx_s + threadIdx.x * sx_i]) : 0.0f;
    if (live) {
      for (int j = threadIdx.x; j < g4; j += blockDim.x) {
        float acc_x = 0.0f;
        float acc_h = 0.0f;
#pragma unroll 8
        for (int k = 0; k < in_dim; ++k)
          acc_x = fmaf(x_t[k], to_float(w_ih[(long long)k * g4 + j]), acc_x);
#pragma unroll 8
        for (int k = 0; k < hidden; ++k)
          acc_h = fmaf(h_s[k], to_float(w_hh[(long long)k * g4 + j]), acc_h);
        gates[j] = (acc_x + acc_h) + to_float(bias[j]);
      }
      if (fetch) x_next[threadIdx.x] = x_pre;
      if (t + 1 < seq) {
        for (int k = threadIdx.x + blockDim.x; k < in_dim; k += blockDim.x)
          x_next[k] = to_float(xr[(t + 1) * sx_s + k * sx_i]);
      }
    }
    __syncthreads();   // every gate of this step, and the next x, in shared memory
    if (live) {
      for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
        const float i_g = sigmoid_f32(gates[j]);
        const float f_g = sigmoid_f32(gates[hidden + j]);
        const float g_g = tanhf(gates[2 * hidden + j]);
        const float o_g = sigmoid_f32(gates[3 * hidden + j]);
        const float c = f_g * c_s[j] + i_g * g_g;
        const float h = o_g * tanhf(c);
        c_s[j] = c;
        h_s[j] = h;
        hr[(long long)t * hidden + j] = from_float<T>(h);
      }
    }
    __syncthreads();   // h of this step is visible to the next step's gates
  }

  if (live) {
    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      h_n[row * hidden + j] = from_float<T>(h_s[j]);
      c_n[row * hidden + j] = from_float<T>(c_s[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_ih, const void* w_hh, const void* bias,
                   const void* h0, const void* c0, void* hs, void* h_n, void* c_n,
                   int batch, int seq, int in_dim, int hidden, long long sx_b,
                   long long sx_s, long long sx_i, cudaStream_t stream) {
  int tx = ((4 * hidden + 31) / 32) * 32;
  if (tx > kMaxThreadsX) tx = kMaxThreadsX;
  // one row per block while the batch alone gives two blocks per SM; a few
  // rows per block beyond that, so that a large batch launches fewer blocks
  int rows = batch / 264;
  if (rows < 1) rows = 1;
  if (rows > kMaxRows) rows = kMaxRows;
  const size_t per_row = ((size_t)6 * hidden + 2 * (size_t)in_dim) * sizeof(float);
  while (rows > 1 && rows * per_row > 48 * 1024) --rows;
  const dim3 block(tx, rows);
  const unsigned grid = (unsigned)((batch + rows - 1) / rows);
  lstm_kernel<T><<<grid, block, rows * per_row, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih), static_cast<const T*>(w_hh),
      static_cast<const T*>(bias), static_cast<const T*>(h0), static_cast<const T*>(c0),
      static_cast<T*>(hs), static_cast<T*>(h_n), static_cast<T*>(c_n), batch, seq,
      in_dim, hidden, sx_b, sx_s, sx_i);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, seq, in_dim) with element strides (sx_b, sx_s, sx_i);
// w_ih (in_dim, 4H), w_hh (H, 4H), bias (4H,), h0 and c0 (batch, H), all
// contiguous; h0 and c0 may be null (zeros).  Outputs, contiguous: hs
// (batch, seq, H), h_n and c_n (batch, H).  Every tensor is fp32 (dtype 0)
// or bf16 (dtype 1).  The wrapper checks shapes, types and that one row's
// shared memory, (6 H + 2 I) floats, fits in 48 KB.  Returns
// cudaGetLastError().
extern "C" int repro_lstm(const void* x, const void* w_ih, const void* w_hh,
                          const void* bias, const void* h0, const void* c0, void* hs,
                          void* h_n, void* c_n, int dtype, int batch, int seq,
                          int in_dim, int hidden, long long sx_b, long long sx_s,
                          long long sx_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || seq == 0 || hidden == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(x, w_ih, w_hh, bias, h0, c0, hs, h_n, c_n,
                                                  batch, seq, in_dim, hidden, sx_b, sx_s,
                                                  sx_i, s));
  }
  return static_cast<int>(launch<float>(x, w_ih, w_hh, bias, h0, c0, hs, h_n, c_n, batch,
                                        seq, in_dim, hidden, sx_b, sx_s, sx_i, s));
}
