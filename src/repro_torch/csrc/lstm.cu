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
// cannot start before step t-1's h is known.  The kernel's time is S times
// the latency of one step, far above its bytes and operations.
//
// What the design does about it: the whole recurrence runs inside one
// launch (the TPU's sequential grid axis becomes a loop), and one warp runs
// one batch row, so a step's critical path holds no block barrier:
//  * Lane j owns hidden unit j (and j + 32, j + 64, ... when H > 32).  It
//    computes all four gates of its units, i, f, g and o, and updates its
//    own c and h; no gate crosses lanes.
//  * Where a unit's weights fit a register budget (H ≤ 32 and I ≤ 8: at
//    most 4·(8 + 32) + 4 floats a lane), the lane holds its four columns of
//    W_ih and W_hh and its biases in registers for all S steps (template
//    parameter HC, H rounded up to a multiple of 4, zero-padded: a zero
//    weight times a zero input adds exactly nothing).  Otherwise (HC = 0)
//    it reads them through L1 on every step, as the block kernel this one
//    replaced did; neighbouring lanes read neighbouring columns.
//  * h is shared inside the warp only: each lane writes its units' new h
//    to a warp-private, double-buffered slice of shared memory, one
//    __syncwarp, and the next step reads the whole h back as broadcasts
//    (float4 reads in the register case).  c stays in a register (or, for
//    H > 32, in the warp's slice).
//  * Each step's x is read from device memory during the step before it
//    and stored after that step's gates, so its latency hides behind them.
//  * A block holds up to four rows (warps); the grid runs over rows.
// x is read through its (B,S,I) strides.  Arithmetic is as before: fp32
// FMA chains (acc_x + acc_h) + b, expf and tanhf (no fast math),
// sigmoid(x) = 1/(1+expf(-x)).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 4;   // warps, one batch row each
constexpr int kIC = 8;             // register capacity for one step's x

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.0f / (1.0f + expf(-v)); }

struct Args {
  const void* x;
  const void* w_ih;
  const void* w_hh;
  const void* bias;
  const void* h0;
  const void* c0;
  void* hs;
  void* h_n;
  void* c_n;
  int batch, seq, in_dim, hidden;
  long long sx_b, sx_s, sx_i;
};

// floats of one warp's slice of shared memory: h and x, double-buffered
// (HC and kIC wide for float4 reads in the register case), and c when it
// is not in a register: at most 6 H + 2 I, what the wrapper lets through
__host__ __device__ inline int warp_floats(int hc, int hidden, int in_dim) {
  return hc > 0 ? 2 * hc + 2 * kIC : 3 * hidden + 2 * in_dim;
}

// one step's gates of a unit: pre-activations (acc_x + acc_h) + b in
// gate order i, f, g, o → the new c and h
__device__ __forceinline__ void cell(const float (&pre)[4], float& c, float& h) {
  const float i_g = sigmoid_f32(pre[0]);
  const float f_g = sigmoid_f32(pre[1]);
  const float g_g = tanhf(pre[2]);
  const float o_g = sigmoid_f32(pre[3]);
  c = f_g * c + i_g * g_g;
  h = o_g * tanhf(c);
}

template <typename T, int HC>
__global__ void __launch_bounds__(32 * kRowsPerBlock) lstm_kernel(const Args args) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= args.batch) return;   // a whole warp: nothing below waits for it
  const int H = args.hidden, I = args.in_dim, G4 = 4 * H, S = args.seq;
  const int hw = HC > 0 ? HC : H;     // h buffer width
  const int xw = HC > 0 ? kIC : I;    // x buffer width
  float* hb = smem + warp * warp_floats(HC, H, I);   // h[2][hw]
  float* xb = hb + 2 * hw;                           // x[2][xw]
  const T* x = static_cast<const T*>(args.x) + row * args.sx_b;
  const T* w_ih = static_cast<const T*>(args.w_ih);
  const T* w_hh = static_cast<const T*>(args.w_hh);
  const T* bias = static_cast<const T*>(args.bias);
  const T* h0 = static_cast<const T*>(args.h0);
  const T* c0 = static_cast<const T*>(args.c0);
  T* hs = static_cast<T*>(args.hs) + row * S * H;

  for (int k = lane; k < 2 * hw; k += 32) hb[k] = 0.0f;
  for (int k = lane; k < 2 * xw; k += 32) xb[k] = k < I ? to_float(x[k * args.sx_i]) : 0.0f;
  for (int u = lane; u < H; u += 32) hb[u] = h0 ? to_float(h0[row * H + u]) : 0.0f;

  if constexpr (HC > 0) {
    // lane j's unit j: its four gate columns in registers
    const int u = lane;
    const bool live = u < H;
    float wx[4][kIC], wh[4][HC], bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < kIC; ++k)
        wx[q][k] = live && k < I ? to_float(w_ih[k * G4 + q * H + u]) : 0.0f;
#pragma unroll
      for (int k = 0; k < HC; ++k)
        wh[q][k] = live && k < H ? to_float(w_hh[k * G4 + q * H + u]) : 0.0f;
      bq[q] = live ? to_float(bias[q * H + u]) : 0.0f;
    }
    float c = live && c0 ? to_float(c0[row * H + u]) : 0.0f;
    float h = 0.0f;
    __syncwarp();
    for (int t = 0; t < S; ++t) {
      const float* xt = xb + (t & 1) * kIC;
      const float* ht = hb + (t & 1) * HC;
      const bool fetch = t + 1 < S && lane < I;
      // the next step's x, read now and stored after this step's gates
      const float x_pre = fetch ? to_float(x[(t + 1) * args.sx_s + lane * args.sx_i]) : 0.0f;
      float acc_x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc_h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kIC; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xt + k);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc_x[q] = fmaf(xv[kk], wx[q][k + kk], acc_x[q]);
      }
#pragma unroll
      for (int k = 0; k < HC; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ht + k);
        const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc_h[q] = fmaf(hv[kk], wh[q][k + kk], acc_h[q]);
      }
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[q] = (acc_x[q] + acc_h[q]) + bq[q];
      cell(pre, c, h);
      if (live) {
        hs[(long long)t * H + u] = from_float<T>(h);
        hb[((t + 1) & 1) * HC + u] = h;
      }
      if (fetch) xb[((t + 1) & 1) * kIC + lane] = x_pre;
      __syncwarp();   // this step's h (and the next x) for every lane
    }
    if (live) {
      static_cast<T*>(args.h_n)[row * H + u] = from_float<T>(h);
      static_cast<T*>(args.c_n)[row * H + u] = from_float<T>(c);
    }
  } else {
    // units j, j + 32, ...: weights through L1, c in the warp's slice
    float* cb = xb + 2 * xw;
    for (int u = lane; u < H; u += 32) cb[u] = c0 ? to_float(c0[row * H + u]) : 0.0f;
    __syncwarp();
    for (int t = 0; t < S; ++t) {
      const float* xt = xb + (t & 1) * xw;
      const float* ht = hb + (t & 1) * hw;
      float* hn = hb + ((t + 1) & 1) * hw;
      float* xn = xb + ((t + 1) & 1) * xw;
      const bool fetch = t + 1 < S && lane < I;
      const float x_pre = fetch ? to_float(x[(t + 1) * args.sx_s + lane * args.sx_i]) : 0.0f;
      for (int u = lane; u < H; u += 32) {
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = q * H + u;
          float acc_x = 0.0f;
          float acc_h = 0.0f;
#pragma unroll 8
          for (int k = 0; k < I; ++k) acc_x = fmaf(xt[k], to_float(w_ih[(long long)k * G4 + j]), acc_x);
#pragma unroll 8
          for (int k = 0; k < H; ++k) acc_h = fmaf(ht[k], to_float(w_hh[(long long)k * G4 + j]), acc_h);
          pre[q] = (acc_x + acc_h) + to_float(bias[j]);
        }
        float c = cb[u], h;
        cell(pre, c, h);
        cb[u] = c;
        hn[u] = h;
        hs[(long long)t * H + u] = from_float<T>(h);
      }
      if (t + 1 < S) {
        if (fetch) xn[lane] = x_pre;
        for (int k = lane + 32; k < I; k += 32) xn[k] = to_float(x[(t + 1) * args.sx_s + k * args.sx_i]);
      }
      __syncwarp();   // this step's h (and the next x) for every lane
    }
    const float* hl = hb + (S & 1) * hw;
    for (int u = lane; u < H; u += 32) {
      static_cast<T*>(args.h_n)[row * H + u] = from_float<T>(hl[u]);
      static_cast<T*>(args.c_n)[row * H + u] = from_float<T>(cb[u]);
    }
  }
}

template <typename T, int HC>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  const size_t per_row = (size_t)warp_floats(HC, args.hidden, args.in_dim) * sizeof(float);
  int rows = args.batch < kRowsPerBlock ? args.batch : kRowsPerBlock;
  while (rows > 1 && rows * per_row > 48 * 1024) --rows;
  const unsigned grid = (unsigned)((args.batch + rows - 1) / rows);
  lstm_kernel<T, HC><<<grid, 32 * rows, rows * per_row, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& args, cudaStream_t stream) {
  if (args.in_dim > kIC || args.hidden > 32) return launch<T, 0>(args, stream);
  switch ((args.hidden + 3) / 4) {   // H rounded up to a multiple of 4
    case 1: return launch<T, 4>(args, stream);
    case 2: return launch<T, 8>(args, stream);
    case 3: return launch<T, 12>(args, stream);
    case 4: return launch<T, 16>(args, stream);
    case 5: return launch<T, 20>(args, stream);
    case 6: return launch<T, 24>(args, stream);
    case 7: return launch<T, 28>(args, stream);
    default: return launch<T, 32>(args, stream);
  }
}

}  // namespace

// x: (batch, seq, in_dim) with element strides (sx_b, sx_s, sx_i);
// w_ih (in_dim, 4H), w_hh (H, 4H), bias (4H,), h0 and c0 (batch, H), all
// contiguous; h0 and c0 may be null (zeros).  Outputs, contiguous: hs
// (batch, seq, H), h_n and c_n (batch, H).  Every tensor is fp32 (dtype 0)
// or bf16 (dtype 1).  The wrapper checks shapes, types and that one row's
// state fits in 48 KB (6 H + 2 I floats, at least what a warp's slice takes).
// Returns cudaGetLastError().
extern "C" int repro_lstm(const void* x, const void* w_ih, const void* w_hh,
                          const void* bias, const void* h0, const void* c0, void* hs,
                          void* h_n, void* c_n, int dtype, int batch, int seq,
                          int in_dim, int hidden, long long sx_b, long long sx_s,
                          long long sx_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || seq == 0 || hidden == 0) return static_cast<int>(cudaGetLastError());
  const Args args{x, w_ih, w_hh, bias, h0, c0, hs, h_n, c_n, batch, seq, in_dim, hidden,
                  sx_b, sx_s, sx_i};
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(args, s));
  return static_cast<int>(dispatch<float>(args, s));
}
