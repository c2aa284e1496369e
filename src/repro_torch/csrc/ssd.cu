// Mamba-2 chunked SSD scan (state-space duality), forward, for the prefill
// path.
//
// Replaces the TPU kernel `ssd_pallas` (body `_ssd_kernel`) at
// src/repro/kernels/ssd/kernel.py:89.  It computes what that kernel
// computes, per (batch, head) and chunk of Q steps, in fp32:
//
//   x̄ = x·dt,  cs = cumsum(a·dt) within the chunk,  total = cs[Q-1]
//   intra-chunk:  Y  = ((C·Bᵀ) ⊙ L)·x̄,  L[i,j] = exp(cs_i − cs_j) for j ≤ i
//   inter-chunk:  Y += exp(cs) ⊙ (C·Hᵀ)          (H: the state entering)
//   state:        H  ← exp(total)·H + (exp(total − cs) ⊙ x̄)ᵀ·B
//   output:       y  = Y + D·x, rounded once to x's dtype
//
// and returns the final state in fp32.  Heads share B and C per group
// (head h reads group h / (H/G)), as the TPU kernel's index maps do.
//
// What bounds it on an H100: at the served prefill's shape (B 2, S 256,
// H 32, P 64, G 1, N 128, Q 128, bf16) the four products take about
// 2·B·H·S·(Q·N/2 + Q·P/2 + 2·N·P) ≈ 0.94 GFLOP (the causal half of the
// score and diagonal products) on about 6.6 MB of x, B, C, dt, y and the
// fp32 state: 2.0 µs to move the bytes at 3.35 TB/s against 0.95 µs for
// the operations at bf16's 989 TFLOP/s, so the card's bound is the bytes.
// This version keeps every product in fp32 on the CUDA cores, to stay
// within the reference tests' 5e-4 (TF32 or bf16 products would not), so
// its own floor is the operations at 67 TFLOP/s: 14 µs.
//
// What the design does about it:
//  * The TPU grid's sequential chunk axis becomes a loop inside one block,
//    with the P×N fp32 state in shared memory across chunks.  Blocks run
//    over (slice of P, head, batch): each p-column's state is independent,
//    so P is split (into power-of-two slices of 8 to 64) while the grid
//    still fits one wave over the card's 132 SMs; the score product C·Bᵀ,
//    which does not depend on p, is recomputed by each slice.
//  * Each input is read from device memory once per block and each output
//    written once.  A chunk's B, x̄ and cs stay in shared memory as fp32;
//    C and the scores are staged 32 rows at a time, so Q 128 and N 128 fit
//    in 116-165 KB whatever the input type.  Row strides of N+1 and Q+1
//    floats keep the rows a warp reads on distinct banks.  The staging
//    loops are unrolled so that several loads are in flight at once.
//  * The slice width and N are template parameters (8-64 and 16-128), so
//    every thread map and register tile is fixed at compile time: each
//    thread accumulates a 4×(1-8) (scores), up to 4×2 (y) or up to 8×4
//    (state) tile, so each shared-memory read feeds 1.3-2.7 FMAs.  Score
//    tiles wholly above the diagonal are skipped, and exp(cs_i − cs_j) is
//    taken only for j ≤ i: above the diagonal the exponent is positive and
//    its inf times the mask's 0 would be NaN.
//  * x, B, C and dt are read through their strides (the last dim
//    contiguous), so the TPU wrapper's transposes and the model's
//    split-and-reshape views need no copy.
// Tensor cores (wgmma) and sharing the scores across the heads of a group
// are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 32;            // chunk rows per score tile
constexpr int kRows = kRT / kWarps;
constexpr int kMaxSmem = 232448;   // what one block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);   // round to nearest even, as torch's cast
}

struct Args {
  const void* x;        // (B, S, H, P), strides sx_*
  const float* dt;      // (B, S, H), strides sdt_*
  const float* a;       // (H,)
  const void* b;        // (B, S, G, N), strides sb_*
  const void* c;        // (B, S, G, N), strides sc_*
  const void* d;        // (H,) fp32 or bf16
  const float* h0;      // (B, H, P, N) contiguous, or null
  void* y;              // (B, S, H, P) contiguous
  float* hout;          // (B, H, P, N) contiguous
  int seq, heads, p, groups, chunk, d_bf16;
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sdt_h;
  long long sb_b, sb_s, sb_g, sc_b, sc_s, sc_g;
};

// rows [0, rows) × W columns of a (·, stride) matrix in device memory into
// shared memory (row stride ld, fp32); W a power of two.  Threads cover a
// row with min(W, 32) lanes; the row loop is unrolled so that several
// loads are in flight before the first store waits for its data.
template <int W, typename T, typename F>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long stride,
                                      int rows, F scale) {
  constexpr int TW = W < 32 ? W : 32, RW = kThreads / TW, U = W / TW;
  const int col = threadIdx.x % TW;
#pragma unroll 4
  for (int j = threadIdx.x / TW; j < rows; j += RW) {
    const float s = scale(j);
#pragma unroll
    for (int u = 0; u < U; ++u) dst[j * ld + col + TW * u] = to_float(src[j * stride + col + TW * u]) * s;
  }
}

// Scores of rows r0 + i (i = warp + 8·ii) against keys j = lane + 32·jj,
// jj < JT: Ss[i][j] = (C_i·B_j)·exp(cs_{r0+i} − cs_j) for j ≤ r0 + i, else 0.
template <int JT, int N>
__device__ __forceinline__ void scores(float* Ss, int ldq, const float* Cs, const float* Bs,
                                       const float* cs, int r0) {
  constexpr int ldn = N + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kRows][JT];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) acc[ii][jj] = 0.0f;
#pragma unroll 4
  for (int nn = 0; nn < N; ++nn) {
    float cv[kRows], bv[JT];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) cv[ii] = Cs[(warp + kWarps * ii) * ldn + nn];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) bv[jj] = Bs[(lane + 32 * jj) * ldn + nn];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
      for (int jj = 0; jj < JT; ++jj) acc[ii][jj] = fmaf(cv[ii], bv[jj], acc[ii][jj]);
  }
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = warp + kWarps * ii, gi = r0 + i;
    const float ci = cs[gi];
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      const int j = lane + 32 * jj;
      Ss[i * ldq + j] = j <= gi ? acc[ii][jj] * expf(ci - cs[j]) : 0.0f;
    }
  }
}

// grid (P / PS, H, B); shared memory, fp32:
//   Bs [Q][N+1], Cs [kRT][N+1], Hs [PS][N+1], Xs [Q][PS], Ss [kRT][Q+1], cs [Q]
template <typename T, int PS, int N>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args args) {
  extern __shared__ float smem[];
  constexpr int ldn = N + 1;
  // y: lanes over p (TP of them), rows of the tile over the rest
  constexpr int TP = PS < 32 ? PS : 32, NY = kThreads / TP, NROW = kRT / NY, NP = PS / TP;
  // state: lanes over n (TN), p over the rest
  constexpr int TN = N < 32 ? N : 32, NY2 = kThreads / TN, NK = N / TN;
  constexpr int RPS = (PS + NY2 - 1) / NY2;
  static_assert(NY <= kRT, "a y row tile needs at least one row a thread");
  const int Q = args.chunk, P = args.p, H = args.heads;
  const int ldq = Q + 1;
  float* Bs = smem;
  float* Cs = Bs + Q * ldn;
  float* Hs = Cs + kRT * ldn;
  float* Xs = Hs + PS * ldn;
  float* Ss = Xs + Q * PS;
  float* cs = Ss + kRT * ldq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const long long bi = blockIdx.z;
  const int g = h / (H / args.groups);
  const float a = args.a[h];
  const float dskip = args.d_bf16
      ? __bfloat162float(static_cast<const __nv_bfloat16*>(args.d)[h])
      : static_cast<const float*>(args.d)[h];
  const T* x = static_cast<const T*>(args.x) + bi * args.sx_b + h * args.sx_h + p0;
  const float* dt = args.dt + bi * args.sdt_b + h * args.sdt_h;
  const T* bm = static_cast<const T*>(args.b) + bi * args.sb_b + g * args.sb_g;
  const T* cm = static_cast<const T*>(args.c) + bi * args.sc_b + g * args.sc_g;
  T* y = static_cast<T*>(args.y) + (bi * args.seq * H + h) * P + p0;
  const long long sy_s = (long long)H * P;
  const long long st0 = ((bi * H + h) * P + p0) * N;   // this block's state rows
  const auto one = [](int) { return 1.0f; };

  if (args.h0) {
    stage<N>(Hs, ldn, args.h0 + st0, N, PS, one);
  } else {
    for (int e = tid; e < PS * N; e += kThreads) Hs[(e / N) * ldn + e % N] = 0.0f;
  }

  const int tp = tid % TP, ty = tid / TP;
  const int tn = tid % TN, ty2 = tid / TN;
  const int n_chunks = args.seq / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const long long s0 = (long long)c * Q;

    // log-decay a·dt and its inclusive cumsum over the chunk (warp 0:
    // each lane sums Q/32 consecutive steps, then a shuffle scan)
    if (warp == 0) {
      const int per = Q / 32;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int j = lane * per + k;
        run += a * dt[(s0 + j) * args.sdt_s];
        cs[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const float before = __shfl_up_sync(kFull, incl, 1);   // the lanes below's sum
      if (lane > 0)
        for (int k = 0; k < per; ++k) cs[lane * per + k] += before;
    }
    stage<N>(Bs, ldn, bm + s0 * args.sb_s, args.sb_s, Q, one);
    const float* dtc = dt + s0 * args.sdt_s;
    const long long sdt = args.sdt_s;
    stage<PS>(Xs, PS, x + s0 * args.sx_s, args.sx_s, Q, [dtc, sdt](int j) { return dtc[j * sdt]; });
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += kRT) {
      stage<N>(Cs, ldn, cm + (s0 + r0) * args.sc_s, args.sc_s, kRT, one);
      __syncthreads();
      switch ((r0 + kRT) / 32) {   // the column groups that reach the diagonal
        case 1: scores<1, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 2: scores<2, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 3: scores<3, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 4: scores<4, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 5: scores<5, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 6: scores<6, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        case 7: scores<7, N>(Ss, ldq, Cs, Bs, cs, r0); break;
        default: scores<8, N>(Ss, ldq, Cs, Bs, cs, r0); break;
      }
      __syncthreads();

      // y for rows i = ty + NY·r and columns p = tp + TP·k of the slice
      {
        float dg[NROW][NP], of[NROW][NP];
#pragma unroll
        for (int r = 0; r < NROW; ++r)
#pragma unroll
          for (int k = 0; k < NP; ++k) dg[r][k] = of[r][k] = 0.0f;
        const int jend = r0 + kRT;
#pragma unroll 4
        for (int j = 0; j < jend; ++j) {
          float xv[NP], sv[NROW];
#pragma unroll
          for (int k = 0; k < NP; ++k) xv[k] = Xs[j * PS + tp + TP * k];
#pragma unroll
          for (int r = 0; r < NROW; ++r) sv[r] = Ss[(ty + NY * r) * ldq + j];
#pragma unroll
          for (int r = 0; r < NROW; ++r)
#pragma unroll
            for (int k = 0; k < NP; ++k) dg[r][k] = fmaf(sv[r], xv[k], dg[r][k]);
        }
#pragma unroll 4
        for (int nn = 0; nn < N; ++nn) {
          float hv[NP], cv[NROW];
#pragma unroll
          for (int k = 0; k < NP; ++k) hv[k] = Hs[(tp + TP * k) * ldn + nn];
#pragma unroll
          for (int r = 0; r < NROW; ++r) cv[r] = Cs[(ty + NY * r) * ldn + nn];
#pragma unroll
          for (int r = 0; r < NROW; ++r)
#pragma unroll
            for (int k = 0; k < NP; ++k) of[r][k] = fmaf(cv[r], hv[k], of[r][k]);
        }
#pragma unroll
        for (int r = 0; r < NROW; ++r) {
          const int i = r0 + ty + NY * r;
          const long long gi = s0 + i;
          const float ecs = expf(cs[i]);
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int pp = tp + TP * k;
            const float v = dg[r][k] + ecs * of[r][k];
            y[gi * sy_s + pp] = from_float<T>(v + dskip * to_float(x[gi * args.sx_s + pp]));
          }
        }
      }
      __syncthreads();   // Cs and Ss are refilled by the next row tile
    }

    // state: H ← exp(total)·H + Σ_j (x̄_j·exp(total − cs_j)) ⊗ B_j
    const float total = cs[Q - 1];
    for (int e = tid; e < Q * PS; e += kThreads) Xs[e] *= expf(total - cs[e / PS]);
    __syncthreads();
    {
      const float etot = expf(total);
      float acc[RPS][NK];
#pragma unroll
      for (int r = 0; r < RPS; ++r) {
        const int pp = ty2 + NY2 * r;
#pragma unroll
        for (int k = 0; k < NK; ++k)
          acc[r][k] = (PS % NY2 == 0 || pp < PS) ? etot * Hs[pp * ldn + tn + TN * k] : 0.0f;
      }
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        float bv[NK], xv[RPS];
#pragma unroll
        for (int k = 0; k < NK; ++k) bv[k] = Bs[j * ldn + tn + TN * k];
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          const int pp = ty2 + NY2 * r;
          xv[r] = (PS % NY2 == 0 || pp < PS) ? Xs[j * PS + pp] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RPS; ++r)
#pragma unroll
          for (int k = 0; k < NK; ++k) acc[r][k] = fmaf(xv[r], bv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < RPS; ++r) {
        const int pp = ty2 + NY2 * r;
        if (PS % NY2 == 0 || pp < PS) {
#pragma unroll
          for (int k = 0; k < NK; ++k) Hs[pp * ldn + tn + TN * k] = acc[r][k];
        }
      }
    }
    __syncthreads();   // the new state, and free B, x̄ and cs for the next chunk
  }

  for (int e = tid; e < PS * N; e += kThreads) args.hout[st0 + e] = Hs[(e / N) * ldn + e % N];
}

template <typename T, int PS, int N>
cudaError_t launch(const Args& args, int batch, size_t smem, cudaStream_t stream) {
  // once per instantiation, before any launch (so never inside a graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, PS, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(args.p / PS, args.heads, batch);
  ssd_kernel<T, PS, N><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, int PS>
cudaError_t launch_n(const Args& args, int n, int batch, size_t smem, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, PS, 16>(args, batch, smem, stream);
    case 32: return launch<T, PS, 32>(args, batch, smem, stream);
    case 64: return launch<T, PS, 64>(args, batch, smem, stream);
    case 128: return launch<T, PS, 128>(args, batch, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_ps(const Args& args, int ps, int n, int batch, size_t smem,
                      cudaStream_t stream) {
  switch (ps) {
    case 8: return launch_n<T, 8>(args, n, batch, smem, stream);
    case 16: return launch_n<T, 16>(args, n, batch, smem, stream);
    case 32: return launch_n<T, 32>(args, n, batch, smem, stream);
    case 64: return launch_n<T, 64>(args, n, batch, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Shared memory one block needs, in bytes (ops.py::smem_bytes in Python).
long long smem_bytes(int chunk, int n, int ps) {
  const long long floats = (long long)chunk * (n + 1) + (long long)kRT * (n + 1) +
                           (long long)ps * (n + 1) + (long long)chunk * ps +
                           (long long)kRT * (chunk + 1) + chunk;
  return floats * (long long)sizeof(float);
}

}  // namespace

// x (B,S,H,P), b and c (B,S,G,N) in one type (dtype 0 fp32, 1 bf16) with
// the last dim contiguous; dt (B,S,H) fp32 with its last dim contiguous;
// a (H,) fp32; d (H,) fp32 (d_bf16 0) or bf16 (1); h0 (B,H,P,N) fp32
// contiguous or null (zeros).  strides: x's (b, s, h), dt's (b, s, h),
// b's (b, s, g), c's (b, s, g), in elements.  Outputs, contiguous: y
// (B,S,H,P) in x's type, hout (B,H,P,N) fp32.  The wrapper checks that
// S % chunk == 0, chunk is a multiple of 32 up to 256, N is 16, 32, 64 or
// 128, ps is 8, 16, 32 or 64 and divides P, G | H, and that the shared
// memory fits.  Returns cudaGetLastError() (cudaErrorInvalidValue for an
// N or ps without an instantiation).
extern "C" int repro_ssd(const void* x, const void* dt, const void* a, const void* b,
                         const void* c, const void* d, const void* h0, void* y, void* hout,
                         int dtype, int d_bf16, int batch, int seq, int heads, int p,
                         int groups, int n, int chunk, int ps, const long long* strides,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || heads == 0 || p == 0) return static_cast<int>(cudaGetLastError());
  Args args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.d = d;
  args.h0 = static_cast<const float*>(h0);
  args.y = y;
  args.hout = static_cast<float*>(hout);
  args.seq = seq;
  args.heads = heads;
  args.p = p;
  args.groups = groups;
  args.chunk = chunk;
  args.d_bf16 = d_bf16;
  args.sx_b = strides[0];
  args.sx_s = strides[1];
  args.sx_h = strides[2];
  args.sdt_b = strides[3];
  args.sdt_s = strides[4];
  args.sdt_h = strides[5];
  args.sb_b = strides[6];
  args.sb_s = strides[7];
  args.sb_g = strides[8];
  args.sc_b = strides[9];
  args.sc_s = strides[10];
  args.sc_g = strides[11];
  const size_t smem = static_cast<size_t>(smem_bytes(chunk, n, ps));
  if (dtype == 1) return static_cast<int>(launch_ps<__nv_bfloat16>(args, ps, n, batch, smem, s));
  return static_cast<int>(launch_ps<float>(args, ps, n, batch, smem, s));
}
