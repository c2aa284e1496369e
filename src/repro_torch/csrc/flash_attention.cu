// Blocked online-softmax attention (forward), GQA, causal / sliding-window /
// q_offset masks, for the prefill path.  Two kernels:
//
//  * `flash_wg_kernel` takes bf16 q, k, v at any head dim the wrapper
//    accepts (16, 32, ..., 128) and runs both products as Hopper's
//    warpgroup MMAs (wgmma);
//  * `flash_fp32_kernel` takes fp32 q, k, v and computes in fp32 on the
//    CUDA cores, so it meets the reference tests' 2e-5 fp32 limit, which
//    TF32 tensor cores would not.
//
// Both replace the TPU kernel `flash_attention` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py:93, and compute what it
// computes: scale D**-0.5, GQA, causal and window masks from absolute
// positions (query i sits at i + q_offset), Sq != Sk, ragged lengths, and a
// fully masked row gives 0, not NaN.
//
// What bounds them on an H100: the work is 4*D operations (two multiply-
// adds) for every (query, key) pair the mask lets through, per batch row
// and head, on B*(Sq*H + 2*Sk*KVH)*D inputs and B*Sq*H*D outputs.  At a
// 2048-token causal prefill (B 1, H 16, KVH 8, D 128) that is 17.19 GFLOP
// against 25 MB: bound by operations, 0.01738 ms at bf16's 989 TFLOP/s.
// At the served prefill (B 2, S 32) it is 0.786 MB and 8.7 MFLOP: bound by
// bytes, 0.000235 ms at 3.35 TB/s, so there launch latency is the
// practical floor.
//
// What the bf16 design does about it (FlashAttention-2's loop on Hopper's
// tensor cores):
//  * Tiles of 64 keys.  S = Q K^T is accumulated in fp32 registers; the
//    online softmax (running max, denominator, rescale) stays in registers
//    with quad shuffles for the row max, one FFMA and one ex2 a score; P
//    goes in two bf16 parts (its rounding, and the rounding of the rest:
//    within 2^-16 of the fp32 P, which the TPU kernel multiplies V by),
//    each used directly as the register A operand of a P V product (the S
//    accumulator layout is the A fragment layout), with no shared-memory
//    round trip.  The denominator sums the two parts, so each output row
//    is a convex combination of V's rows.
//  * wgmma: a block is one warpgroup of 64 rows (112 KB of shared memory at
//    D 128), so two blocks share an SM and one's softmax overlaps the
//    other's products.  The tensor cores read Q, K and V straight from
//    shared memory through 128-byte-swizzled descriptors (V as the
//    transposed operand), so no thread loads an operand fragment.
//  * Head dims: the tiles are 64 or 128 columns wide.  A head dim below
//    that (16-48, 80-112) fills the rest of each row with zeros (cp.async
//    of no bytes), which add exactly nothing to S and give output columns
//    that are not stored.
//  * Asynchronous copies: K and V tiles come in by 16-byte cp.async into a
//    3-stage ring in shared memory, so tiles j+1 and j+2 are in flight
//    while the products run on tile j, and one barrier a tile suffices (it
//    also frees the stage the next copy refills).
//  * GQA packing: a block serves all H/KVH query heads of one kv head, the
//    group's heads interleaved in its rows (row r = position r / group, head
//    r % group), so each K/V tile is read once per group instead of once
//    per head, and a short prefill (S 32, group 2) fills 64 rows.
//  * Masks: tiles wholly above the causal diagonal or left of the window
//    are skipped by the block;
//    the element mask runs only on tiles that straddle a boundary.  A row
//    that has seen no key yet (running max still -inf) subtracts 0, never
//    -inf - (-inf), and l == 0 gives 0.
//  * Scheduling: under a causal mask a block's work grows with its rows'
//    positions.  The grid is (kv heads, batch, row blocks) with the row
//    blocks in reverse, so the blocks go out longest first across all
//    heads and the short ones fill the tail of the last wave.
//
// The fp32 kernel: one block per (q tile of 64 rows, head, batch), 4
// threads per query row, K and V staged 32 keys at a time in shared memory
// (row stride D + 1 floats), products and softmax in fp32 registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 on warpgroup MMAs (wgmma)
// ---------------------------------------------------------------------------
constexpr int kWgBQ = 64;     // query rows per block (one warpgroup)
constexpr int kTcBK = 64;     // keys per K/V tile
constexpr int kStages = 3;    // K/V tiles in flight
constexpr int kNT = kTcBK / 8;   // n tiles of 8 keys in S

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2**x; 2**-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Where a block's rows are: the packed (position, head) rows of one kv
// head, [r0, r0 + BQ) of `rows`, and the key tiles [t_begin, t_end) that
// any of them may attend to.
struct BlockRows {
  int r0, rows, t_begin, t_end;
};

__device__ __forceinline__ BlockRows block_rows(int sq, int sk, int group,
                                                int causal, int window,
                                                int q_offset) {
  constexpr int BQ = kWgBQ;
  BlockRows br;
  br.rows = sq * group;
  br.r0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // late rows first
  const int pos_first = br.r0 / group;
  const int pos_last = (min(br.r0 + BQ, br.rows) - 1) / group;
  int k_hi = sk;
  if (causal) k_hi = min(sk, pos_last + q_offset + 1);
  int k_lo = 0;
  if (window) k_lo = max(0, pos_first + q_offset - window + 1);
  br.t_begin = k_lo / kTcBK;
  br.t_end = k_hi > k_lo ? (k_hi + kTcBK - 1) / kTcBK : br.t_begin;
  return br;
}

// Is any key of the tile at k0 masked for a query in [qmin, qmax]?
__device__ __forceinline__ bool tile_straddles(int k0, int qmin, int qmax,
                                               int sk, int causal, int window) {
  return k0 + kTcBK > sk || (causal && k0 + kTcBK - 1 > qmin) ||
         (window && k0 <= qmax - window);
}

// The online softmax over one key tile for the two rows a thread holds
// (rows g and g + 8 of its warp's 16; `qpos` their query positions).  `s`
// holds the raw scores as a 16x8-tile accumulator (s[j][0..1] row g,
// s[j][2..3] row g + 8, keys k0 + 8j + 2tq and + 1).  Updates the running
// max `m` (of raw scores) and this thread's partial sums `l`, leaves P as
// two bf16 parts, `pf[0]` its rounding and `pf[1]` the rounding of what
// that leaves (their sum within 2^-16 of P), as the A fragments of P V (16
// keys each), and the factor by which the output rows must be rescaled in
// `alpha`.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kNT][4], uint32_t (&pf)[2][kNT / 2][4], float (&alpha)[2],
    float (&m)[2], float (&l)[2], const int (&qpos)[2], bool masked, int k0,
    int sk, int causal, int window, int tq, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * tq + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = kj < sk;
        if (causal) ok = ok && kj <= qp;
        if (window) ok = ok && kj > qp - window;
        if (!ok) s[j][e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // p = 2**(s * scale_log2 - mu), one FFMA and one ex2 an element; a row
    // with no key yet keeps -inf and subtracts 0, so p is 0, not NaN
    mu[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
    alpha[i] = fast_exp2(m[i] * scale_log2 - mu[i]);
    m[i] = mx[i];
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e0 = fast_exp2(fmaf(s[j][2 * r], scale_log2, -mu[r]));
      const float e1 = fast_exp2(fmaf(s[j][2 * r + 1], scale_log2, -mu[r]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(e0 - __low2float(hi), e1 - __high2float(hi));
      ps[r] += (__low2float(hi) + __low2float(lo)) + (__high2float(hi) + __high2float(lo));
      pf[0][j >> 1][(j & 1) * 2 + r] = as_u32(hi);
      pf[1][j >> 1][(j & 1) * 2 + r] = as_u32(lo);
    }
  }
  l[0] = l[0] * alpha[0] + ps[0];
  l[1] = l[1] * alpha[1] + ps[1];
}

template <int kDT>
__device__ __forceinline__ void rescale(float (&acc)[kDT][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// 1 / (the quad's sum of l), or 0 for a row that saw no key
__device__ __forceinline__ float inv_row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l == 0.f ? 0.f : 1.f / l;
}

// Shared-memory tiles are 128-byte-swizzled: a tile of R rows by D columns
// is D / 64 column blocks of R rows of 128 bytes, the 16-byte chunks of row
// r permuted by r % 8.  Offset, in elements, of chunk c of row r:
__device__ __forceinline__ int sw128(int r, int c, int R) {
  return (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled tile: start
// address, `lbo` the byte stride between 64-column blocks (read only for
// a transposed operand), 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching an accumulator while a wgmma owns it
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

#define REPRO_F4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define REPRO_F32(j) REPRO_F4(j), REPRO_F4(j + 1), REPRO_F4(j + 2), \
    REPRO_F4(j + 3), REPRO_F4(j + 4), REPRO_F4(j + 5), REPRO_F4(j + 6), REPRO_F4(j + 7)
#define REPRO_D32 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"  \
    "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define REPRO_D64 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"  \
    "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"       \
    "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"       \
    "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"

// d (64x64) += A (64x16, shared) * B (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_s(float (&d)[8][4], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, 1, 1, 1, 0, 0;\n"
      : REPRO_F32(0)
      : "l"(a), "l"(b));
}

// d (64xN) += A (64x16, registers) * B (16xN, shared, N-major)
template <int N>
__device__ __forceinline__ void wgmma_o(float (&d)[N / 8][4],
                                        const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_o<64>(float (&d)[8][4],
                                            const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32,%33,%34,%35}, %36, 1, 1, 1, 1;\n"
      : REPRO_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma_o<128>(float (&d)[16][4],
                                             const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_D64
      ", {%64,%65,%66,%67}, %68, 1, 1, 1, 1;\n"
      : REPRO_F32(0), REPRO_F32(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// shared memory: Q, then kStages stages of K and V, rows of DP columns
// (112 KB at DP 128, so two blocks share an SM and one's softmax overlaps
// the other's products)
template <int DP>
constexpr int wg_smem_bytes() {
  return (kWgBQ + 2 * kStages * kTcBK) * DP * 2;
}

// head dim D in tiles of DP = 64 columns (D <= 64) or 128 (D > 64);
// columns D .. DP - 1 of each tile are zeros
template <int D>
__global__ void __launch_bounds__(kWgBQ * 2)
flash_wg_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int sq, int sk, int heads,
                int group, long long qsb, long long qss, long long qsh,
                long long ksb, long long kss, long long ksh, long long vsb,
                long long vss, long long vsh, int causal, int window,
                int q_offset, float scale_log2) {
  constexpr int DP = D <= 64 ? 64 : 128;
  constexpr int BQ = kWgBQ;
  constexpr int kThreads = BQ * 2;     // one warpgroup, 16 rows a warp
  constexpr int kChunks = DP / 8;      // 16-byte chunks in a tile row
  constexpr int kDT = DP / 8;          // n tiles of O
  constexpr int kTile = kTcBK * DP;    // elements of a K or V tile
  constexpr int kDataChunks = D / 8;   // chunks that hold data
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: tiles start 1024-aligned
  if (smem_addr(smem_raw) & 1023) __trap();
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * DP;
  __nv_bfloat16* sV = sK + kStages * kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const BlockRows br = block_rows(sq, sk, group, causal, window, q_offset);
  const __nv_bfloat16* qb = q + b * qsb + kvh * group * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

#pragma unroll
  for (int i = 0; i < kChunks / 2; ++i) {   // BQ * kChunks chunks, kThreads at a time
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int pr = br.r0 + r;
    const bool ok = pr < br.rows && (D == DP || c < kDataChunks);
    const int pos = pr / group;
    cp_async16(sQ + sw128(r, c, BQ),
               ok ? qb + pos * qss + (pr - pos * group) * qsh + c * 8 : qb, ok);
  }
  cp_async_commit();

  // a thread copies chunk lc of rows lr0, lr0 + kRowStep, ... of a K or V
  // tile; kRowStep is a multiple of 8, so their swizzle is the same
  constexpr int kRowStep = kThreads / kChunks;
  const int lc = tid % kChunks;
  const int lr0 = tid / kChunks;
  const int ldst = sw128(lr0, lc, kTcBK);
  const bool l_data = D == DP || lc < kDataChunks;
  auto load_kv = [&](int t, int stage) {
    const int kr = t * kTcBK + lr0;      // the key of this thread's first row
    const bool full = l_data && t * kTcBK + kTcBK <= sk;
    const __nv_bfloat16* ks = kb + kr * kss + lc * 8;
    const __nv_bfloat16* vs = vb + kr * vss + lc * 8;
    __nv_bfloat16* dk = sK + stage * kTile + ldst;
    __nv_bfloat16* dv = sV + stage * kTile + ldst;
#pragma unroll
    for (int i = 0; i < kTcBK / kRowStep; ++i) {
      const bool ok = full || (l_data && kr + i * kRowStep < sk);
      cp_async16(dk + i * kRowStep * 64, ok ? ks + i * kRowStep * kss : kb, ok);
      cp_async16(dv + i * kRowStep * 64, ok ? vs + i * kRowStep * vss : vb, ok);
    }
  };

  // this thread's rows (g and g + 8 of its warp's 16), and the query
  // positions of the block's rows
  const int wr0 = warp * 16;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int qpos[2] = {(br.r0 + wr0 + g) / group + q_offset,
                       (br.r0 + wr0 + g + 8) / group + q_offset};
  const int gmin = br.r0 / group + q_offset;
  const int gmax = (min(br.r0 + BQ, br.rows) - 1) / group + q_offset;

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of the raw scores
  float l[2] = {0.f, 0.f};               // this thread's partial sums

  // one commit group per tile, empty past the last, so that before tile t
  // the only group that may still be in flight is tile t + 1's.  Every
  // tile in [t_begin, t_end) is live for some row of the block.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (br.t_begin + i < br.t_end) load_kv(br.t_begin + i, i);
    cp_async_commit();
  }
  for (int t = br.t_begin; t < br.t_end; ++t) {
    const int stage = (t - br.t_begin) % kStages;
    cp_async_wait<kStages - 2>();
    // this thread's copies are visible to the tensor cores' reads; after
    // the barrier, everyone's are, and the products on tile t - 1, whose
    // stage the next copy refills, are done
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + kStages - 1 < br.t_end) {
      load_kv(t + kStages - 1, (t - br.t_begin + kStages - 1) % kStages);
    }
    cp_async_commit();
    const int k0 = t * kTcBK;
    const __nv_bfloat16* tk = sK + stage * kTile;
    const __nv_bfloat16* tv = sV + stage * kTile;
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_s(s, sw128_desc(sQ + (kk >> 2) * BQ * 64 + (kk & 3) * 16, 0),
              sw128_desc(tk + (kk >> 2) * kTcBK * 64 + (kk & 3) * 16, 0));
    }
    wg_commit();
    wg_wait<0>();
    wg_hold(s);
    uint32_t pf[2][kNT / 2][4];
    float alpha[2];
    softmax_tile(s, pf, alpha, m, l, qpos,
                 tile_straddles(k0, gmin, gmax, sk, causal, window), k0, sk,
                 causal, window, tq, scale_log2);
    rescale(acc, alpha);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint64_t vd = sw128_desc(tv + kk * 16 * 64, kTcBK * 128);
      wgmma_o<DP>(acc, pf[1][kk], vd);   // the small part first
      wgmma_o<DP>(acc, pf[0][kk], vd);
    }
    wg_commit();
    wg_wait<0>();
    wg_hold(acc);
  }
  cp_async_wait<0>();

  const float inv[2] = {inv_row_sum(l[0]), inv_row_sum(l[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = br.r0 + wr0 + g + 8 * i;
    if (pr < br.rows) {
      const int pos = pr / group;
      const int h = kvh * group + pr - pos * group;
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * sq + pos) * heads + h) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        if (j < kDataChunks) {   // known at compile time
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
              acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
        }
      }
    }
  }
}

// Launch the bf16 kernel: grid (kv heads, batch, row blocks), so that the
// blocks go out row block by row block, the longest first.
template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* o, int batch,
              int sq, int sk, int heads, int kv_heads, const long long* st,
              int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes<D <= 64 ? 64 : 128>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = heads / kv_heads;
  const long long rows = static_cast<long long>(sq) * group;
  dim3 grid(kv_heads, batch, static_cast<unsigned>((rows + kWgBQ - 1) / kWgBQ));
  flash_wg_kernel<D><<<grid, kWgBQ * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, heads, group, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kLanes = 4;               // threads per query row
constexpr int kThreads = kBQ * kLanes;  // 256
constexpr float kNegBig = -1e30f;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int sk, int heads, int group, long long qsb, long long qss,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r;
    qs[r * (D + 1) + d] = qi < sq ? qb[qi * qss + d] : 0.f;
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
      ks[r * (D + 1) + d] = in ? kb[kj * kss + d] : 0.f;
      vs[r * D + d] = in ? vb[kj * vss + d] : 0.f;
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
    float* orow = o + ((static_cast<long long>(b) * sq + qi) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kDims; ++j) orow[lane + kLanes * j] = acc[j] / denom;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                int batch, int sq, int sk, int heads, int kv_heads,
                const long long* st, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, heads,
      heads / kv_heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_FLASH_SWITCH_D(CALL)                                            \
  switch (d) {                                                                \
    case 16: return CALL(16);                                                 \
    case 32: return CALL(32);                                                 \
    case 48: return CALL(48);                                                 \
    case 64: return CALL(64);                                                 \
    case 80: return CALL(80);                                                 \
    case 96: return CALL(96);                                                 \
    case 112: return CALL(112);                                               \
    case 128: return CALL(128);                                               \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

// q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); o: (B, Sq, H, D) contiguous.  The
// last dim of q, k and v is contiguous; `strides` holds, in elements, the
// batch, sequence and head strides of q, then k, then v.  D is a multiple
// of 16 up to 128 and H % KVH == 0 (the wrapper checks).  Each returns
// cudaGetLastError() (or the attribute call's error).

// fp32 q, k, v, o: the CUDA-core kernel.
extern "C" int repro_flash_attention_fp32(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int sq, int sk, int heads,
                                          int kv_heads, int d,
                                          const long long* strides, int causal,
                                          int window, int q_offset, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_FP32(DIM)                                                 \
  launch_fp32<DIM>(q, k, v, o, batch, sq, sk, heads, kv_heads, strides,       \
                   causal, window, q_offset, scale, s)
  REPRO_FLASH_SWITCH_D(REPRO_FLASH_FP32)
#undef REPRO_FLASH_FP32
}

// bf16 q, k, v, o: the wgmma kernel.  q, k and v are 16-byte aligned and
// their strides are multiples of 8 elements (for cp.async; the wrapper
// checks).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int sq, int sk, int heads,
                                          int kv_heads, int d,
                                          const long long* strides, int causal,
                                          int window, int q_offset, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BF16(DIM)                                                 \
  launch_wg<DIM>(q, k, v, o, batch, sq, sk, heads, kv_heads, strides, causal, \
                 window, q_offset, scale, s)
  REPRO_FLASH_SWITCH_D(REPRO_FLASH_BF16)
#undef REPRO_FLASH_BF16
}
