// Blocked int8 -> bf16/fp32 dequantize for the checkpoint restore path.
//
// Replaces the TPU kernel `dequantize_blocked` (body `_dequant_kernel`) in
// src/repro/kernels/dequant/kernel.py.
//
// What bounds it on an H100: bytes.  Each element is read as 1 byte of int8
// and written as 2 (bf16) or 4 (fp32) bytes, plus one fp32 scale per 128
// elements; there is one multiply per element, so the pass sits far below
// the card's ops-per-byte balance point and its floor is the bytes moved
// over the 3.35 TB/s of HBM.
//
// What the design does about it: a grid-stride loop over 16-element vectors.
// Each thread reads its 16 int8 values with one 16-byte load, fetches the
// one scale its vector needs (a vector never straddles a 128-column group,
// since the group is a multiple of 16), and writes its outputs with 16-byte
// stores, so neighbouring threads touch neighbouring addresses.  The flat
// index needs no tiling, so a ragged row count (the 151936-row embedding)
// or column count needs no special case: the loop bound is the mask.
// The arithmetic is the plain version's: one fp32 multiply, then a
// round-to-nearest-even cast, so the result is bit-exact.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;        // int8 values per thread per step
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ void store_vec(float* out, const float* v) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    o[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ int pack_bf16x2(float lo, float hi) {
  // __floats2bfloat162_rn rounds each half to nearest even, as the cast does
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<int*>(&p);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* out, const float* v) {
  int4* o = reinterpret_cast<int4*>(out);
  o[0] = make_int4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  o[1] = make_int4(pack_bf16x2(v[8], v[9]), pack_bf16x2(v[10], v[11]),
                   pack_bf16x2(v[12], v[13]), pack_bf16x2(v[14], v[15]));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               OutT* __restrict__ out, long long n_vec, long long vec_per_row,
               long long vec_per_group, long long groups_per_row) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const long long row = i / vec_per_row;
    const long long vcol = i - row * vec_per_row;
    const float s = __ldg(scales + row * groups_per_row + vcol / vec_per_group);
    const int4 packed = __ldg(reinterpret_cast<const int4*>(q) + i);
    const int8_t* b = reinterpret_cast<const int8_t*>(&packed);
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = static_cast<float>(b[j]) * s;
    store_vec(out + i * kVec, v);
  }
}

}  // namespace

// q: int8 (rows, cols) contiguous, 16-byte aligned; scales: fp32
// (rows, cols / group) contiguous; out: (rows, cols) contiguous, 16-byte
// aligned, fp32 (out_dtype 0) or bf16 (out_dtype 1).  cols % group == 0 and
// group % 16 == 0 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int repro_dequant(const void* q, const void* scales, void* out,
                             long long rows, long long cols, int group,
                             int out_dtype, void* stream) {
  const long long n_vec = rows * cols / kVec;
  if (n_vec == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const long long vec_per_row = cols / kVec;
  const long long vec_per_group = group / kVec;
  const long long groups_per_row = cols / group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) {
    dequant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), n_vec, vec_per_row, vec_per_group,
        groups_per_row);
  } else {
    dequant_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), n_vec, vec_per_row, vec_per_group,
        groups_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
