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
//                 (total − cs_j = Σ_{i>j} a·dt_i, summed from the chunk's end)
//   output:       y  = Y + D·x, rounded once to x's dtype
//
// and returns the final state in fp32.  Heads share B and C per group
// (head h reads group h / (H/G)), as the TPU kernel's index maps do.
//
// What bounds it on an H100: at the served prefill's shape (B 2, S 256,
// H 32, P 64, G 1, N 128, Q 128, bf16) the function moves about 6.6 MB
// (x, B, C, dt, y and the fp32 state), 2.0 µs at 3.35 TB/s, against
// 0.94 GFLOP of products counted per head, so the card's bound is the
// bytes.  The products with an fp32 side (x̄, L and the state) need fp32
// accuracy to hold the reference tests' 5e-4 and 5e-5: TF32 or plain bf16
// operands there would not.
//
// The design follows Mamba-2's own GPU implementation (Dao & Gu 2024, §6):
// one call runs four kernels on the current stream, each over all chunks
// at once, with scratch that the wrapper allocates:
//  1. prep_kernel: per (batch, group, chunk) the score tile C·Bᵀ, once for
//     all the group's heads (bf16 inputs on the tensor cores, mma.sync
//     m16n8k16 with fp32 sums: the product of two bf16 values is exact in
//     fp32; fp32 inputs on the CUDA cores), tiles wholly above the diagonal
//     skipped, written transposed to scores (B, G, nc, Q, Q); and, in the
//     same grid, per (batch, head, chunk) cs = cumsum(a·dt), one warp a
//     chunk, to cs (B, H, S).
//  2. chunk_state_kernel: per (batch, head, chunk) the chunk's own state
//     Σ_j (x̄_j·exp(total − cs_j)) ⊗ B_j (P×N), to states (B, H, nc, P, N),
//     with total − cs_j summed from the chunk's end by one warp (the
//     difference of the two cumsums loses their ulp: ROADMAP C-ref-5).
//  3. state_pass_kernel: per (batch, head) and element of the P×N state,
//     H_c = exp(total_c)·H_{c−1} + ΔH_c over the chunks in order, from
//     init_state or zeros, in fp32; it writes the state entering each
//     chunk (over the chunk's own slot, or for bf16 inputs as bf16 parts,
//     below) and the final state.
//  4. output_kernel: per (batch, head, chunk, rows, 64 columns of P)
//     y = exp(cs) ⊙ (C·H_enteringᵀ) + ((C·Bᵀ) ⊙ L)·x̄ + D·x, the columns
//     of L above a block's (or warpgroup's) last row skipped and
//     exp(cs_i − cs_j) taken only for j ≤ i (above the diagonal the
//     exponent is positive and its inf times the mask's 0 would be NaN).
// bf16 inputs (the served path) run kernels 2 and 4 on warpgroup MMAs
// (wgmma m64n64k16, fp32 sums).  The operand that holds fp32 values goes
// in bf16 parts, each the rounding of what the ones before leave, against
// the operand that is bf16 exactly (x, B or C), so every product is exact
// in fp32: three parts for the chunk's own state (they sum to the fp32
// value exactly; the state is held to 5e-5), two for the output, which is
// rounded to bf16 (they leave under 2^-16 of each value, far below half a
// bf16 ulp).  For this x̄ = x·dt becomes (L·dt)·x.  The parts of x̄ and of
// L are made in registers as the A fragments are built; the state's, by
// kernel 3.  Kernel 4 takes a whole chunk of 128 rows (two warpgroups), so
// the entering state and x are read once a chunk.  Slices of the summed
// dimension are fetched by cp.async into 128-byte-swizzled tiles, one
// while the other is multiplied.
// fp32 inputs run kernels 2 and 4 on the CUDA cores: 64 threads, each with
// an 8×8 register tile (four FMAs per float read from shared memory), over
// slices of 32 that are fetched raw by cp.async while the previous slice is
// multiplied, then converted, scaled (dt, the decays, L) and, where the
// sum runs along a row of the input, transposed, in shared memory.
// Ragged edges (P, N below a tile, Q not a multiple of the rows) are
// zero-filled.  x, B, C and dt are read through their strides (the last
// dim contiguous), so the model's split-and-reshape views need no copy;
// a view whose rows are not 16-byte aligned is copied by plain loads.
// Only the bf16 output kernel takes more than 48 KB of shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;            // rows and columns of a product tile
constexpr int kK = 32;               // depth of one staged slice
constexpr int kLd = kTile + 4;       // row stride (floats) of the fp32 operands
constexpr int kGemm = 64;            // threads of a tile product: 8 × 8
constexpr int kPrep = 128;           // threads of prep_kernel: four warps
constexpr int kPass = 256;           // threads of state_pass_kernel
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kRawBytes = kTile * (kK + 4) * 4;   // one raw slice, either orientation
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
  float* scores;        // (B, G, nc, Q, Q): scores[j][i] = B_j · C_i
  float* cs;            // (B, H, S)
  float* states;        // (B, H, nc, P, N)
  __nv_bfloat16* entering;   // (B, H, nc, 2, P, N) for bf16 inputs, else null
  int batch, seq, heads, p, groups, n, chunk, d_bf16, vec;
  long long sx_b, sx_s, sx_h, sdt_b, sdt_s, sdt_h;
  long long sb_b, sb_s, sb_g, sc_b, sc_s, sc_g;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows × cols elements of a row-major matrix in device memory (row stride
// `stride` elements, zero beyond rows_valid × cols_valid) into shared
// memory with row stride `ld`: 16-byte cp.async copies when `vec` (every
// row start 16-byte aligned, cols and cols_valid multiples of 16 bytes),
// else plain loads.  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long stride, int rows,
                                      int cols, int rows_valid, int cols_valid, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int ch = cols / E;
    for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
      const int r = e / ch, col = (e % ch) * E;
      const bool ok = r < rows_valid && col < cols_valid;
      cp_async16(dst + r * ld + col, ok ? src + r * stride + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, col = e % cols;
      dst[r * ld + col] = (r < rows_valid && col < cols_valid) ? src[r * stride + col]
                                                              : from_float<T>(0.0f);
    }
  }
}

// the 8 rows (or columns) of a 64-wide tile that thread t (0-7) owns:
// t·4 + 0..3 and 32 + t·4 + 0..3, so a warp's float4 reads hit distinct banks
__device__ __forceinline__ int own(int t, int r) { return (r & 4) * 8 + t * 4 + (r & 3); }

// acc[r][c] += Σ_k As[k][own(ty, r)] · Bs[k][own(tx, c)] over one slice
__device__ __forceinline__ void fma_slice(float (&acc)[8][8], const float* As, const float* Bs,
                                          int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLd + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * kLd + 32 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLd + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kLd + 32 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Shared memory of one fp32 tile product: a raw slice of each operand and
// the two fp32 operands.
struct GemmSmem {
  alignas(16) unsigned char raw_a[kRawBytes];
  alignas(16) unsigned char raw_b[kRawBytes];
  alignas(16) float as[kK * kLd];
  alignas(16) float bs[kK * kLd];
};

// ----------------------------------------------------------------------------
// 1. scores (once per batch, group and chunk) and cs (per batch, head, chunk)
// ----------------------------------------------------------------------------
__device__ __forceinline__ unsigned pack2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// scores[j][i] = B_j · C_i for j in [j0, j0+64), i in [i0, i0+64) of one
// chunk: bf16 on the tensor cores.  Warp w takes rows j0 + 16w .. +16 (the
// A operand, B's rows) against all 64 columns (the B operand, C's rows).
__device__ void score_tile_bf16(const __nv_bfloat16* bm, long long sb, const __nv_bfloat16* cm,
                                long long sc, float* out, int q, int n, int j0, int i0, bool vec) {
  constexpr int kLdMax = kMaxN + 8;   // bf16 row stride: rows a fragment reads hit distinct banks
  __shared__ __align__(16) __nv_bfloat16 bsm[kTile * kLdMax];
  __shared__ __align__(16) __nv_bfloat16 csm[kTile * kLdMax];
  const int ld = n + 8;
  stage<__nv_bfloat16>(bsm, ld, bm + j0 * sb, sb, kTile, n, q - j0, n, vec);
  stage<__nv_bfloat16>(csm, ld, cm + i0 * sc, sc, kTile, n, q - i0, n, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4] = {};
  const __nv_bfloat16* arow = bsm + (warp * 16 + g) * ld + 2 * t;
  for (int k = 0; k < n; k += 16) {
    const unsigned af[4] = {pack2(arow + k), pack2(arow + 8 * ld + k), pack2(arow + k + 8),
                            pack2(arow + 8 * ld + k + 8)};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const __nv_bfloat16* brow = csm + (nb * 8 + g) * ld + 2 * t + k;
      mma_bf16(acc[nb], af, pack2(brow), pack2(brow + 8));
    }
  }
  const int jr = j0 + warp * 16 + g;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int i = i0 + nb * 8 + 2 * t;
    if (i >= q) continue;
    if (jr < q) *reinterpret_cast<float2*>(out + (long long)jr * q + i) = make_float2(acc[nb][0], acc[nb][1]);
    if (jr + 8 < q)
      *reinterpret_cast<float2*>(out + (long long)(jr + 8) * q + i) = make_float2(acc[nb][2], acc[nb][3]);
  }
}

// the same in fp32 on the CUDA cores: the first 64 threads run the tile
// product over slices of N, all 128 stage and convert
__device__ void score_tile_f32(const float* bm, long long sb, const float* cm, long long sc,
                               float* out, int q, int n, int j0, int i0, bool vec) {
  __shared__ GemmSmem sm;
  float* ra = reinterpret_cast<float*>(sm.raw_a);
  float* rb = reinterpret_cast<float*>(sm.raw_b);
  constexpr int ldr = kK + 4;
  const int tid = threadIdx.x, tx = tid & 7, ty = (tid >> 3) & 7;
  float acc[8][8] = {};
  for (int k0 = 0; k0 < n; k0 += kK) {
    __syncthreads();   // the previous slice's operands are read
    stage<float>(ra, ldr, bm + j0 * sb + k0, sb, kTile, kK, q - j0, n - k0, vec);
    stage<float>(rb, ldr, cm + i0 * sc + k0, sc, kTile, kK, q - i0, n - k0, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < kK * kTile; e += blockDim.x) {
      const int m = e / kK, k = e % kK;
      sm.as[k * kLd + m] = ra[m * ldr + k];
      sm.bs[k * kLd + m] = rb[m * ldr + k];
    }
    __syncthreads();
    if (tid < kGemm) fma_slice(acc, sm.as, sm.bs, ty, tx);
  }
  if (tid >= kGemm) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = j0 + own(ty, r);
    if (j >= q) continue;
#pragma unroll
    for (int c = 0; c < 8; c += 4) {
      const int i = i0 + own(tx, c);
      if (i < q)
        *reinterpret_cast<float4*>(out + (long long)j * q + i) =
            make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    }
  }
}

// log-decay a·dt and its inclusive cumsum over one chunk, by one warp: each
// lane sums Q/32 consecutive steps, then a shuffle scan adds the lanes below
__device__ void chunk_cumsum(const Args& args, int item) {
  const int lane = threadIdx.x & 31;
  const int nc = args.seq / args.chunk, q = args.chunk;
  const int c = item % nc, bh = item / nc, h = bh % args.heads;
  const long long bi = bh / args.heads;
  const float a = args.a[h];
  const float* dt = args.dt + bi * args.sdt_b + h * args.sdt_h + (long long)c * q * args.sdt_s;
  float* out = args.cs + (long long)bh * args.seq + (long long)c * q;
  const int per = q / 32;
  float part[kMaxQ / 32];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    if (k < per) {
      run += a * dt[(lane * per + k) * args.sdt_s];
      part[k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const float before = __shfl_up_sync(kFull, incl, 1);   // the lanes below's sum
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k)
    if (k < per) out[lane * per + k] = lane > 0 ? part[k] + before : part[k];
}

// decay[j] = exp(Σ_{i>j} a·dt_i) over one chunk, by one warp, summed from
// the chunk's end: each lane sums its Q/32 steps from its last, then a
// shuffle scan adds the lanes above.  exp(total − cs_j), the difference of
// two cumsums that reach |a|·Σdt (about 90 over 128 steps at a = −1), loses
// ulp(90) of the exponent at every step, and the chunk's state 5e-5 at 256
// heads (ROADMAP C-ref-5); a sum from the end is short and small for the
// steps near it, whose decays weigh most.
__device__ void suffix_decay(const float* dts, float* decay, float a, int q) {
  const int lane = threadIdx.x & 31, per = q / 32;
  float after[kMaxQ / 32];
  float run = 0.0f;
#pragma unroll
  for (int k = kMaxQ / 32 - 1; k >= 0; --k) {
    if (k < per) {
      after[k] = run;                       // the lane's steps after k
      run += a * dts[lane * per + k];
    }
  }
  float incl = run;                         // this lane's steps and the lanes above's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += t;
  }
  float above = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) above = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k)
    if (k < per) decay[lane * per + k] = expf(after[k] + above);
}

// grid: score_blocks tiles (batch, group, chunk, tile pair jt ≤ it), then
// blocks of four warps, one (batch, head, chunk) cumsum a warp
template <typename T>
__global__ void __launch_bounds__(kPrep) prep_kernel(const Args args, int score_blocks) {
  const int q = args.chunk, nc = args.seq / q;
  if ((int)blockIdx.x >= score_blocks) {
    const int item = ((int)blockIdx.x - score_blocks) * (kPrep / 32) + (threadIdx.x >> 5);
    if (item < args.batch * args.heads * nc) chunk_cumsum(args, item);
    return;
  }
  const int nt = (q + kTile - 1) / kTile, pairs = nt * (nt + 1) / 2;
  int pair = blockIdx.x % pairs;
  int it = 0;
  while (pair > it) pair -= ++it;   // pair = it·(it+1)/2 + jt
  const int jt = pair;
  const int bgc = blockIdx.x / pairs;
  const int c = bgc % nc, bg = bgc / nc, g = bg % args.groups;
  const long long bi = bg / args.groups;
  const long long s0 = (long long)c * q;
  const T* bm = static_cast<const T*>(args.b) + bi * args.sb_b + g * args.sb_g + s0 * args.sb_s;
  const T* cm = static_cast<const T*>(args.c) + bi * args.sc_b + g * args.sc_g + s0 * args.sc_s;
  float* out = args.scores + (long long)bgc * q * q;
  if constexpr (sizeof(T) == 2) {
    score_tile_bf16(bm, args.sb_s, cm, args.sc_s, out, q, args.n, jt * kTile, it * kTile, args.vec);
  } else {
    score_tile_f32(bm, args.sb_s, cm, args.sc_s, out, q, args.n, jt * kTile, it * kTile, args.vec);
  }
}

// ----------------------------------------------------------------------------
// Tile products for kernels 2 and 4, over slices along the summed
// dimension (the file's head has the design).
//  * fp32 inputs, on the CUDA cores (64 threads): pipeline() and
//    fma_slice().
//  * bf16 inputs, on warpgroup MMAs: chunk states 128 threads (one
//    warpgroup, 64 rows), the output 256 (two, 128 rows); warp w holds rows
//    16w..16w+15 in the mma.sync accumulator layout, as wgmma leaves them.
//    pipeline_tc() with two swizzled buffers; split_a() builds an A operand
//    in registers, in parts.
// ----------------------------------------------------------------------------
template <typename T> constexpr bool kTc = sizeof(T) == 2;
template <typename T> constexpr int kThreads = kTc<T> ? 128 : kGemm;
constexpr int kLdx = kTile + 8;    // bf16 row stride of an x slice [k][64]
// the output kernel's rows a block: a whole chunk of 128 on the tensor
// cores (eight warps, so that the state and x are read once per chunk)
template <typename T> constexpr int kRowsOut = kTc<T> ? 2 * kTile : kTile;
template <typename T> constexpr int kThreadsOut = kTc<T> ? 256 : kGemm;
constexpr int kLds = 2 * kTile + 4;   // fp32 row stride of a [k][128] slice of scores
constexpr int kStateParts = 3;    // the chunk's own state: exact, for the state's 5e-5
constexpr int kOutParts = 2;      // the output (bf16): within 2^-16 of each fp32 operand
// one slice of chunk_state_kernel's operands: B [k][64] (swizzled) and x
// [k][64], rounded up to 1024 bytes
constexpr int kStateBuf = (kK * kTile * 2 + kK * kLdx * 2 + 1023) / 1024 * 1024;
constexpr int kStateSmem = 2 * kStateBuf + 1024;
// one slice of output_kernel's: C [128][64] and the state's parts [64][64]
// (swizzled), or the scores [k][128] (fp32) and x [k][64]
constexpr int kOutBuf = (2 * kTile + kOutParts * kTile) * kTile * 2;
constexpr int kScoresBytes = (kK * kLds * 4 + 1023) / 1024 * 1024;   // x's tile 1024-aligned after
static_assert(kOutBuf >= kScoresBytes + kK * kTile * 2, "a slice of scores and x fits");
constexpr int kOutSmem = 2 * kOutBuf + 1024;   // two buffers, and room to align them

// slices 0..n−1 of an fp32 product: fetch(s) issues slice s's copies,
// convert(s) turns the raw slice into operands, multiply(s) adds its
// products; slice s + 1 is fetched while slice s is multiplied
template <class Fetch, class Convert, class Multiply>
__device__ __forceinline__ void pipeline(int n, Fetch fetch, Convert convert, Multiply multiply) {
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    cp_async_wait_all();
    __syncthreads();   // slice s is in; every thread is done with slice s−1's operands
    convert(s);
    __syncthreads();
    if (s + 1 < n) {
      fetch(s + 1);
      cp_async_commit();
    }
    multiply(s);
  }
}

// slices 0..n−1 of a tensor-core product: fetch(s) issues slice s's copies
// into buffer s & 1, multiply(s) reads them; slice s + 1 is in flight while
// slice s is multiplied
template <class Fetch, class Multiply>
__device__ __forceinline__ void pipeline_tc(int n, Fetch fetch, Multiply multiply) {
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    cp_async_wait_all();
    // this thread's copies are visible to the tensor cores' reads (wgmma);
    // after the barrier everyone's are, and slice s − 1's buffer is free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + 1 < n) {
      fetch(s + 1);
      cp_async_commit();
    }
    multiply(s);
  }
}

// wgmma operands in shared memory, K-major and 128-byte swizzled: a tile
// of rows of 64 bf16 (128 bytes), the 16-byte chunk c of row r at chunk
// c ^ (r % 8), groups of 8 rows 1024 bytes apart, tiles 1024-aligned.
__device__ __forceinline__ int sw128(int r, int c) { return r * 64 + (((c & 7) ^ (r & 7)) << 3); }
// (lbo: the byte stride between 64-column blocks, read only for a
// transposed operand)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo = 0) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// rows × 64 bf16 of a row-major matrix (row stride `stride`, zero beyond
// rows_valid × cols_valid, cols_valid a multiple of 8) into a swizzled tile
__device__ __forceinline__ void stage_sw128(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long stride, int rows, int rows_valid,
                                            int cols_valid, bool vec) {
  for (int e = threadIdx.x; e < rows * 8; e += blockDim.x) {
    const int r = e >> 3, c = e & 7;
    const bool ok = r < rows_valid && c * 8 < cols_valid;
    __nv_bfloat16* d = dst + sw128(r, c);
    if (vec) {
      cp_async16(d, ok ? src + r * stride + c * 8 : src, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = ok ? src[r * stride + c * 8 + k] : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching an accumulator while a wgmma owns it
__device__ __forceinline__ void wg_hold(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define SSD_F4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
// d (64×64: the warpgroup's rows, the mma.sync accumulator layout in each
// warp) += A (64×16) · B (16×64), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, 1, 1, 1, 0, 0;\n"
      : SSD_F4(0), SSD_F4(1), SSD_F4(2), SSD_F4(3), SSD_F4(4), SSD_F4(5), SSD_F4(6), SSD_F4(7)
      : "l"(a), "l"(b));
}
// d += A (64×16, registers: each warp's 16 rows in the mma.sync A layout) ·
// B (16×64, shared, N-major: rows of k)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, 1, 1, 1, 1;\n"
      : SSD_F4(0), SSD_F4(1), SSD_F4(2), SSD_F4(3), SSD_F4(4), SSD_F4(5), SSD_F4(6), SSD_F4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
#undef SSD_F4

// (v0, v1) as PARTS bf16 pairs, largest first, each the bf16 rounding of
// what the ones before leave (every remainder is exact in fp32).  Three
// parts sum to v0 and v1 exactly (the last holds at most 8 significant
// bits); two leave less than 2^-16 of each.
template <int PARTS>
__device__ __forceinline__ void split(float v0, float v1, unsigned (&out)[PARTS]) {
#pragma unroll
  for (int u = 0; u < PARTS; ++u) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
    out[u] = *reinterpret_cast<const unsigned*>(&b);
    const float2 f = __bfloat1622float2(b);
    v0 -= f.x;
    v1 -= f.y;
  }
}

// the PARTS A fragments of the warp's rows at k-step k: value(r, kk) for
// tile row r = 16w + g (+8) and slice column kk = k + 2t (+1, +8, +9)
template <int PARTS, class Value>
__device__ __forceinline__ void split_a(unsigned (&a)[PARTS][4], int k, Value value) {
  const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int kk = k + 2 * (lane & 3);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int rr = r + (f & 1) * 8, kf = kk + (f >> 1) * 8;
    unsigned parts[PARTS];
    split<PARTS>(value(rr, kf), value(rr, kf + 1), parts);
#pragma unroll
    for (int u = 0; u < PARTS; ++u) a[u][f] = parts[u];
  }
}

// ----------------------------------------------------------------------------
// 2. each chunk's own state, all chunks at once
// ----------------------------------------------------------------------------
// grid (B·H·nc, P tiles × N tiles); ΔH[p][n] = Σ_j ((x_j[p]·dt_j)·exp(Σ_{i>j} a·dt_i))·B_j[n]
template <typename T>
__global__ void __launch_bounds__(kThreads<T>) chunk_state_kernel(const Args args) {
  constexpr int NT = kThreads<T>;
  __shared__ std::conditional_t<kTc<T>, char, GemmSmem> sm;   // the fp32 path's
  extern __shared__ __align__(1024) unsigned char dsmem[];     // the tensor-core path's
  __shared__ float dts[kMaxQ], decay[kMaxQ];
  const int q = args.chunk, nc = args.seq / q, P = args.p, N = args.n, H = args.heads;
  const int item = blockIdx.x;
  const int c = item % nc, bh = item / nc, h = bh % H;
  const long long bi = bh / H;
  const int g = h / (H / args.groups);
  const int ptiles = (P + kTile - 1) / kTile;
  const int p0 = (blockIdx.y % ptiles) * kTile, n0 = (blockIdx.y / ptiles) * kTile;
  const long long s0 = (long long)c * q;
  const float* dt = args.dt + bi * args.sdt_b + h * args.sdt_h + s0 * args.sdt_s;
  for (int j = threadIdx.x; j < q; j += NT) dts[j] = dt[j * args.sdt_s];
  __syncthreads();
  if (threadIdx.x < 32) suffix_decay(dts, decay, args.a[h], q);
  __syncthreads();
  const T* x = static_cast<const T*>(args.x) + bi * args.sx_b + h * args.sx_h + s0 * args.sx_s + p0;
  const T* bm = static_cast<const T*>(args.b) + bi * args.sb_b + g * args.sb_g + s0 * args.sb_s + n0;
  const bool vec = args.vec;
  const int tid = threadIdx.x;
  float* out = args.states + (long long)item * P * N;
  if constexpr (kTc<T>) {
    // slice s in buffer s & 1: B [j][n] (swizzled: the warpgroup MMA's
    // transposed B operand) and x [j][p], whose x̄' makes the A fragments
    unsigned char* base = dsmem + (-static_cast<int>(__cvta_generic_to_shared(dsmem)) & 1023);
    const auto bs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(base + (s & 1) * kStateBuf); };
    const auto xs = [&](int s) { return reinterpret_cast<T*>(bs(s) + kK * kTile); };
    float acc[8][4] = {};
    pipeline_tc(q / kK, [&](int s) {
      const long long j0 = (long long)s * kK;
      stage_sw128(bs(s), bm + j0 * args.sb_s, args.sb_s, kK, kK, N - n0, vec);
      stage<T>(xs(s), kLdx, x + j0 * args.sx_s, args.sx_s, kK, kTile, kK, P - p0, vec);
    }, [&](int s) {
      const T* xr = xs(s);
      unsigned a[kK / 16][kStateParts][4];
#pragma unroll
      for (int kq = 0; kq < kK / 16; ++kq)
        split_a<kStateParts>(a[kq], kq * 16, [&](int pp, int kk) {
          const int j = s * kK + kk;
          return (to_float(xr[kk * kLdx + pp]) * dts[j]) * decay[j];
        });
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < kK / 16; ++kq)
#pragma unroll
        for (int u = kStateParts - 1; u >= 0; --u)
          wgmma_rs(acc, a[kq][u], sw128_desc(bs(s) + kq * 16 * kTile, kK * 128));
      wg_commit_wait();
      wg_hold(acc);
    });
    const int lane = tid & 31, p = p0 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int n = n0 + nb * 8 + 2 * (lane & 3);
      if (n >= N) continue;
      if (p < P) *reinterpret_cast<float2*>(out + (long long)p * N + n) = make_float2(acc[nb][0], acc[nb][1]);
      if (p + 8 < P)
        *reinterpret_cast<float2*>(out + (long long)(p + 8) * N + n) = make_float2(acc[nb][2], acc[nb][3]);
    }
  } else {
    T* ra = reinterpret_cast<T*>(sm.raw_a);
    T* rb = reinterpret_cast<T*>(sm.raw_b);
    const int tx = tid & 7, ty = tid >> 3;
    float acc[8][8] = {};
    pipeline(q / kK, [&](int s) {
      const long long j0 = (long long)s * kK;
      stage<T>(ra, kTile, x + j0 * args.sx_s, args.sx_s, kK, kTile, kK, P - p0, vec);
      stage<T>(rb, kTile, bm + j0 * args.sb_s, args.sb_s, kK, kTile, kK, N - n0, vec);
    }, [&](int s) {
      for (int e = tid; e < kK * kTile; e += NT) {   // raw [j][p] and [j][n], e = k·64 + m
        const int k = e / kTile, m = e % kTile, j = s * kK + k;
        sm.as[k * kLd + m] = (to_float(ra[e]) * dts[j]) * decay[j];
        sm.bs[k * kLd + m] = rb[e];
      }
    }, [&](int) { fma_slice(acc, sm.as, sm.bs, ty, tx); });
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int p = p0 + own(ty, r);
      if (p >= P) continue;
#pragma unroll
      for (int cc = 0; cc < 8; cc += 4) {
        const int n = n0 + own(tx, cc);
        if (n < N)
          *reinterpret_cast<float4*>(out + (long long)p * N + n) =
              make_float4(acc[r][cc], acc[r][cc + 1], acc[r][cc + 2], acc[r][cc + 3]);
      }
    }
  }
}

// ----------------------------------------------------------------------------
// 3. the states passed from chunk to chunk
// ----------------------------------------------------------------------------
// grid (B·H, P·N / (4·256)), four consecutive elements a thread (P·N is a
// multiple of 128).  Slot c of states becomes the state entering chunk c;
// for the tensor-core path (SPLIT) it goes instead to entering, as the
// output's kOutParts bf16 parts (B, H, nc, kOutParts, P, N).
template <bool SPLIT>
__global__ void __launch_bounds__(kPass) state_pass_kernel(const Args args) {
  const int pn = args.p * args.n, q = args.chunk, nc = args.seq / q;
  const long long bh = blockIdx.x;
  const int e = (blockIdx.y * kPass + threadIdx.x) * 4;
  if (e >= pn) return;
  float4 carry = args.h0 ? *reinterpret_cast<const float4*>(args.h0 + bh * pn + e)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* st = args.states + bh * nc * pn + e;
  const float* total = args.cs + bh * args.seq + (q - 1);
  constexpr int kU = 8;   // loads in flight: they do not depend on the carry
  for (int c0 = 0; c0 < nc; c0 += kU) {
    float4 dh[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (c0 + u < nc) dh[u] = *reinterpret_cast<const float4*>(st + (long long)(c0 + u) * pn);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u < nc) {
        const long long cc = c0 + u;
        if constexpr (SPLIT) {
          __nv_bfloat16* parts = args.entering + (bh * nc + cc) * kOutParts * pn + e;
          unsigned xy[kOutParts], zw[kOutParts];
          split<kOutParts>(carry.x, carry.y, xy);
          split<kOutParts>(carry.z, carry.w, zw);
#pragma unroll
          for (int u = 0; u < kOutParts; ++u)
            *reinterpret_cast<uint2*>(parts + u * pn) = make_uint2(xy[u], zw[u]);
        } else {
          *reinterpret_cast<float4*>(st + cc * pn) = carry;
        }
        const float d = expf(total[cc * q]);
        carry = make_float4(fmaf(d, carry.x, dh[u].x), fmaf(d, carry.y, dh[u].y),
                            fmaf(d, carry.z, dh[u].z), fmaf(d, carry.w, dh[u].w));
      }
    }
  }
  *reinterpret_cast<float4*>(args.hout + bh * pn + e) = carry;
}

// ----------------------------------------------------------------------------
// 4. the output, all chunks at once
// ----------------------------------------------------------------------------
// grid (B·H·nc, row tiles × P tiles); rows i = r0.., columns p = p0..
template <typename T>
__global__ void __launch_bounds__(kThreadsOut<T>) output_kernel(const Args args) {
  constexpr int NT = kThreadsOut<T>, R = kRowsOut<T>;
  __shared__ std::conditional_t<kTc<T>, char, GemmSmem> sm;   // the fp32 path's
  extern __shared__ __align__(1024) unsigned char dsmem[];     // the tensor-core path's
  __shared__ float css[kMaxQ], dts[kMaxQ];
  const int q = args.chunk, nc = args.seq / q, P = args.p, N = args.n, H = args.heads;
  const int item = blockIdx.x;
  const int c = item % nc, bh = item / nc, h = bh % H;
  const long long bi = bh / H;
  const int g = h / (H / args.groups);
  const int ptiles = (P + kTile - 1) / kTile;
  const int p0 = (blockIdx.y % ptiles) * kTile, r0 = (blockIdx.y / ptiles) * R;
  const long long s0 = (long long)c * q;
  const float* cs = args.cs + (long long)bh * args.seq + s0;
  const float* dt = args.dt + bi * args.sdt_b + h * args.sdt_h + s0 * args.sdt_s;
  for (int j = threadIdx.x; j < q; j += NT) {
    css[j] = cs[j];
    dts[j] = dt[j * args.sdt_s];
  }
  const T* x = static_cast<const T*>(args.x) + bi * args.sx_b + h * args.sx_h + s0 * args.sx_s + p0;
  const T* cm = static_cast<const T*>(args.c) + bi * args.sc_b + g * args.sc_g +
                (s0 + r0) * args.sc_s;
  const float* sc = args.scores + ((((long long)bi * args.groups + g) * nc + c) * q) * q + r0;
  const bool vec = args.vec;
  const int tid = threadIdx.x;
  const int rows = min(R, q - r0);
  const bool inter = c > 0 || args.h0;   // the state entering is zero otherwise
  const int n_slices = (N + kK - 1) / kK, j_slices = min(r0 + R, q) / kK;
  // the score times L: zero above the diagonal, where exp would overflow
  const auto score_l = [&](float sji, int i, int j) {
    return (i < q && j <= i) ? sji * expf(css[i] - css[j]) : 0.0f;
  };
  const float dskip = args.d_bf16
      ? __bfloat162float(static_cast<const __nv_bfloat16*>(args.d)[h])
      : static_cast<const float*>(args.d)[h];
  T* y = static_cast<T*>(args.y) + ((bi * args.seq + s0) * H + h) * P + p0;
  const long long sy = (long long)H * P;
  const auto emit = [&](int i, int pp, float v) {   // tile row i, column pp
    if (r0 + i < q && p0 + pp < P) {
      const float xv = to_float(x[(long long)(r0 + i) * args.sx_s + pp]);
      y[(long long)(r0 + i) * sy + pp] = from_float<T>(v + dskip * xv);
    }
  };

  if constexpr (kTc<T>) {
    // acc = exp(cs_i)·Σ_n C_i[n]·H[p][n]  (C exact, H in two parts), then
    // acc += Σ_j ((S_ji·L_ij)·dt_j)·x_j[p]  (x exact; dt moves to the split side)
    const int lane = tid & 31, warp = tid >> 5, g4 = lane >> 2, t4 = lane & 3;
    const int ti = warp * 16 + g4;
    float acc[8][4] = {};
    // two buffers of kOutBuf bytes, 1024-aligned for the swizzled tiles
    unsigned char* base = dsmem + (-static_cast<int>(__cvta_generic_to_shared(dsmem)) & 1023);
    const auto buf = [&](int s) { return base + (s & 1) * kOutBuf; };
    if (inter) {
      // slices of 64 along n on warpgroup MMAs: C [i][n] (128 rows) and the
      // state's parts [p][n] (64 rows each), swizzled; warpgroup wg takes
      // rows 64·wg..64·wg+63
      const auto cb = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(buf(s)); };
      const auto hb = [&](int s, int u) { return cb(s) + (R + u * kTile) * kTile; };
      const __nv_bfloat16* parts = args.entering + ((long long)item * kOutParts * P + p0) * N;
      pipeline_tc((N + kTile - 1) / kTile, [&](int s) {
        const int k0 = s * kTile;
        stage_sw128(cb(s), reinterpret_cast<const __nv_bfloat16*>(cm) + k0, args.sc_s, R, rows,
                    N - k0, vec);
        for (int u = 0; u < kOutParts; ++u)
          stage_sw128(hb(s, u), parts + (long long)u * P * N + k0, N, kTile, P - p0, N - k0, true);
      }, [&](int s) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int u = kOutParts - 1; u >= 0; --u)
            wgmma_ss(acc, sw128_desc(cb(s) + (warp >> 2) * kTile * kTile + kk * 16),
                     sw128_desc(hb(s, u) + kk * 16));
        wg_commit_wait();
        wg_hold(acc);
      });
      const float e0 = ti < rows ? expf(css[r0 + ti]) : 0.0f;
      const float e8 = ti + 8 < rows ? expf(css[r0 + ti + 8]) : 0.0f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        acc[nb][0] *= e0;
        acc[nb][1] *= e0;
        acc[nb][2] *= e8;
        acc[nb][3] *= e8;
      }
    }
    // slice s: scores [j][i] (fp32, [k][128]) and x [j][p] (swizzled: the
    // warpgroup MMA's transposed B operand); the A fragments are the
    // scores times L and dt, in parts
    const auto sb = [&](int s) { return reinterpret_cast<float*>(buf(s)); };
    const auto xb = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(buf(s) + kScoresBytes); };
    const int wg_last = r0 + (warp >> 2) * 64 + 63;   // the warpgroup's last row
    pipeline_tc(j_slices, [&](int s) {
      const long long j0 = (long long)s * kK;
      stage<float>(sb(s), kLds, sc + j0 * q, q, kK, R, kK, rows, true);
      stage_sw128(xb(s), reinterpret_cast<const __nv_bfloat16*>(x) + j0 * args.sx_s, args.sx_s,
                  kK, kK, P - p0, vec);
    }, [&](int s) {
      const float* sr = sb(s);
      const int below = wg_last - s * kK;   // k-steps past it are above the diagonal
      if (below < 0) return;
      const int steps = min(kK / 16, below / 16 + 1);
      unsigned a[kK / 16][kOutParts][4];
#pragma unroll
      for (int kq = 0; kq < kK / 16; ++kq)
        if (kq < steps)
          split_a<kOutParts>(a[kq], kq * 16, [&](int ii, int kk) {
            const int j = s * kK + kk;
            return score_l(sr[kk * kLds + ii], r0 + ii, j) * dts[j];
          });
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < kK / 16; ++kq)
        if (kq < steps)
#pragma unroll
          for (int u = kOutParts - 1; u >= 0; --u)
            wgmma_rs(acc, a[kq][u], sw128_desc(xb(s) + kq * 16 * kTile, kK * 128));
      wg_commit_wait();
      wg_hold(acc);
    });
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int pp = nb * 8 + 2 * t4;
      emit(ti, pp, acc[nb][0]);
      emit(ti, pp + 1, acc[nb][1]);
      emit(ti + 8, pp, acc[nb][2]);
      emit(ti + 8, pp + 1, acc[nb][3]);
    }
  } else {
    // acc = exp(cs_i)·Σ_n C_i[n]·H[p][n], then acc += Σ_j (S_ji·L_ij)·(x_j[p]·dt_j)
    const int tx = tid & 7, ty = tid >> 3;
    float acc[8][8] = {};
    constexpr int ldr = kK + 4;
    if (inter) {
      // raw C [i][n] and the entering state [p][n]
      T* rc = reinterpret_cast<T*>(sm.raw_a);
      float* rh = reinterpret_cast<float*>(sm.raw_b);
      const float* hst = args.states + ((long long)item * P + p0) * N;
      pipeline(n_slices, [&](int s) {
        const int k0 = s * kK;
        stage<T>(rc, ldr, cm + k0, args.sc_s, kTile, kK, rows, N - k0, vec);
        stage<float>(rh, ldr, hst + k0, N, kTile, kK, P - p0, N - k0, true);
      }, [&](int) {
        for (int e = tid; e < kK * kTile; e += NT) {
          const int m = e / kK, k = e % kK;
          sm.as[k * kLd + m] = rc[m * ldr + k];
          sm.bs[k * kLd + m] = rh[m * ldr + k];
        }
      }, [&](int) { fma_slice(acc, sm.as, sm.bs, ty, tx); });
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = own(ty, r);
        const float e = i < rows ? expf(css[r0 + i]) : 0.0f;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[r][cc] *= e;
      }
    }
    // raw scores [j][i] and x [j][p]
    float* rs = reinterpret_cast<float*>(sm.raw_a);
    T* rx = reinterpret_cast<T*>(sm.raw_b);
    pipeline(j_slices, [&](int s) {
      const long long j0 = (long long)s * kK;
      stage<float>(rs, kTile, sc + j0 * q, q, kK, kTile, kK, rows, true);
      stage<T>(rx, kTile, x + j0 * args.sx_s, args.sx_s, kK, kTile, kK, P - p0, vec);
    }, [&](int s) {
      for (int e = tid; e < kK * kTile; e += NT) {   // e = k·64 + m
        const int k = e / kTile, m = e % kTile, j = s * kK + k;
        sm.as[k * kLd + m] = score_l(rs[e], r0 + m, j);
        sm.bs[k * kLd + m] = to_float(rx[e]) * dts[j];
      }
    }, [&](int) { fma_slice(acc, sm.as, sm.bs, ty, tx); });
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) emit(own(ty, r), own(tx, cc), acc[r][cc]);
  }
}

template <typename T>
cudaError_t launch_all(const Args& args, cudaStream_t stream, int stages) {
  const int q = args.chunk, nc = args.seq / q;
  const int nt = (q + kTile - 1) / kTile;
  const int items = args.batch * args.heads * nc;
  const int ptiles = (args.p + kTile - 1) / kTile;
  const int ntiles = (args.n + kTile - 1) / kTile;
  cudaError_t err;
  // once per instantiation, before any launch (so never inside a graph
  // capture): the tensor-core output kernel takes more than 48 KB
  static bool opted_in = false;
  if (kTc<T> && !opted_in) {
    err = cudaFuncSetAttribute(output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (stages & 1) {
    const int score_blocks = args.batch * args.groups * nc * nt * (nt + 1) / 2;
    const int cs_blocks = (items + kPrep / 32 - 1) / (kPrep / 32);
    prep_kernel<T><<<score_blocks + cs_blocks, kPrep, 0, stream>>>(args, score_blocks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 2) {
    chunk_state_kernel<T><<<dim3(items, ptiles * ntiles), kThreads<T>, kTc<T> ? kStateSmem : 0,
                            stream>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 4) {
    const int pn = args.p * args.n;
    state_pass_kernel<kTc<T>><<<dim3(args.batch * args.heads, (pn + 4 * kPass - 1) / (4 * kPass)), kPass,
                        0, stream>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stages & 8) {
    const int rtiles = (q + kRowsOut<T> - 1) / kRowsOut<T>;
    output_kernel<T><<<dim3(items, rtiles * ptiles), kThreadsOut<T>, kTc<T> ? kOutSmem : 0,
                       stream>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x (B,S,H,P), b and c (B,S,G,N) in one type (dtype 0 fp32, 1 bf16) with
// the last dim contiguous; dt (B,S,H) fp32 with its last dim contiguous;
// a (H,) fp32; d (H,) fp32 (d_bf16 0) or bf16 (1); h0 (B,H,P,N) fp32
// contiguous or null (zeros).  strides: x's (b, s, h), dt's (b, s, h),
// b's (b, s, g), c's (b, s, g), in elements; vec 1 when x, b and c and
// their strides are 16-byte aligned.  Scratch, contiguous: scores
// (B,G,S/chunk,chunk,chunk), cs (B,H,S), states (B,H,S/chunk,P,N), fp32,
// and for bf16 inputs entering (B,H,S/chunk,2,P,N) bf16 (else null).
// Outputs, contiguous: y (B,S,H,P) in x's type, hout (B,H,P,N) fp32.
// stages: a mask of the four kernels to launch, in order (15 for a whole
// call; the others time one stage on the scratch of a whole call).  The
// wrapper checks that S % chunk == 0, chunk is a multiple of 32 up to 256,
// N is 16, 32, 64 or 128, P is a multiple of 8, G | H.  Returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int repro_ssd(const void* x, const void* dt, const void* a, const void* b,
                         const void* c, const void* d, const void* h0, void* y, void* hout,
                         void* scores, void* cs, void* states, void* entering, int dtype,
                         int d_bf16,
                         int batch, int seq, int heads, int p, int groups, int n, int chunk,
                         int vec, int stages, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || heads == 0 || p == 0 || seq == 0) return static_cast<int>(cudaGetLastError());
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
  args.scores = static_cast<float*>(scores);
  args.cs = static_cast<float*>(cs);
  args.states = static_cast<float*>(states);
  args.entering = static_cast<__nv_bfloat16*>(entering);
  args.batch = batch;
  args.seq = seq;
  args.heads = heads;
  args.p = p;
  args.groups = groups;
  args.n = n;
  args.chunk = chunk;
  args.d_bf16 = d_bf16;
  args.vec = vec;
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
  if (dtype == 1) return static_cast<int>(launch_all<__nv_bfloat16>(args, s, stages));
  return static_cast<int>(launch_all<float>(args, s, stages));
}
