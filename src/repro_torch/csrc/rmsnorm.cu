// rmsnorm_lib and rmsnorm_tab: fused RMSNorm with the table-backed rsqrt.
//
// Replaces repro/kernels/rmsnorm/kernel.py `fused_rmsnorm_lib` /
// `_rmsnorm_lib_kernel` (the rsqrt slot of a library ROM) and
// `fused_rmsnorm` / `_rmsnorm_kernel` (one design's own (2^R, 3) rows), both
// over `_rmsnorm_body`: ms = mean(x^2) + eps, then the IEEE-754 split of ms,
// the odd/even-exponent code into the rsqrt table over [1, 4) (the half-code
// split at 2^(in_bits - 1) of the table's own in_bits), rs = tab *
// 2^-out_bits * 2^-h, and out = x * rs * gamma.
//
// Bound on an H100: bytes (read x once, write out once, ~4 flops per
// element). Design: one block per row; x^2 is reduced in f32 (warp shuffles,
// then one value per warp through shared memory), the code, the single
// table read and the scale are computed in registers, and a second pass over
// the row (an L1/L2 hit at these row sizes) writes the output. Any D works;
// the strided loops mask the tail. The one table read per row goes through
// the cache to its (rom, TableArgs) pair: a library slot (and, for a
// segmented slot, its leaf rows) or a per-table design's rows.
#include <cuda_bf16.h>

#include "datapath.cuh"

using namespace repro;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// rsqrt of ms > 0 through the table: ms = 1.mant * 2^e; an even e selects
// segment [1, 2) of the table's input range, an odd e segment [2, 4).
__device__ __forceinline__ float table_rsqrt(float ms, const int32_t* rom,
                                             const TableArgs& tb) {
  const uint32_t bits = __float_as_uint(ms);
  const int e = (int)((bits >> 23) & 255u) - 127;
  const uint32_t mant = bits & 0x7FFFFFu;
  const int b = tb.in_bits;
  const int halfcode = 1 << (b - 1);
  const uint32_t rnd = 1u << (23 - (b - 1) - 1);
  const int frac_code =
      min((int)((mant + rnd) >> (23 - (b - 1))), halfcode - 1);
  const bool even = (e & 1) == 0;
  const int code = even ? frac_code : halfcode + frac_code;
  const int h = even ? e / 2 : (e - 1) / 2;  // exact: equals floor division
  const float tab = (float)lut_rom(rom, tb, code);
  return __fmul_rn(__fmul_rn(tab, pow2i(-tb.out_bits)), pow2i(-h));
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               T* __restrict__ out, int d, float eps,
                               const int32_t* __restrict__ rom,
                               TableArgs tb) {
  __shared__ float s_part[32];
  __shared__ float s_rs;
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    float s = lane < nw ? s_part[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      const float ms = __fadd_rn(__fdiv_rn(s, (float)d), eps);
      s_rs = table_rsqrt(ms, rom, tb);
    }
  }
  __syncthreads();
  const float rs = s_rs;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xr[i]), rs), gamma[i]));
}

namespace {

int run(const void* x, const float* gamma, void* out, int rows, int d,
        int dtype, float eps, const int32_t* rom, const TableArgs& tb,
        int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (!table_args_ok(tb)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int threads = d >= 1024 ? 256 : 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, threads, 0, s>>>(
        (const float*)x, gamma, (float*)out, d, eps, rom, tb);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        (const __nv_bfloat16*)x, gamma, (__nv_bfloat16*)out, d, eps, rom, tb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. meta12, dp: see datapath.cuh
// `table_args`.
extern "C" int repro_rmsnorm_lib(const void* x, const float* gamma, void* out,
                                 int rows, int d, int dtype, float eps,
                                 const int32_t* rom, const int32_t* dp,
                                 const int32_t* meta12, int device,
                                 void* stream) {
  return run(x, gamma, out, rows, d, dtype, eps, rom, table_args(meta12, dp),
             device, stream);
}

// The per-table entry: coeffs are one design's own (2^R, 3) int32 rows,
// meta12 its row (row0 0, rows 2^R, no segment table).
extern "C" int repro_rmsnorm_tab(const void* x, const float* gamma, void* out,
                                 int rows, int d, int dtype, float eps,
                                 const int32_t* coeffs, const int32_t* meta12,
                                 int device, void* stream) {
  return run(x, gamma, out, rows, d, dtype, eps, coeffs,
             table_args(meta12, nullptr), device, stream);
}
