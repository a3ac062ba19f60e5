// softmax_lib and softmax_tab: row softmax with the table-backed exp and
// reciprocal.
//
// Replaces repro/kernels/softmax/kernel.py `fused_softmax_lib` /
// `_softmax_lib_kernel` (both tables in one library ROM) and `fused_softmax`
// / `_softmax_kernel` (each table from its own design's (2^R, 3) rows), both
// over `_softmax_body`: per row, m = max(x),
// t = min((m - x) * log2e, 126), e = tab_exp(round(frac(t) * 2^eb)) *
// 2^-out_bits * 2^-floor(t), s = sum(e), 1/s from the IEEE-754 split of s
// into the reciprocal table, out = e * (1/s) in x's dtype. Both table reads
// are the shared datapath of datapath.cuh (`table_exp_neg`, `table_recip`).
//
// Bound on an H100: bytes (read x once, write out once, ~20 operations per
// element). Design: one body for both entry points; it takes a (rom,
// TableArgs) pair per table, and the library entry passes its ROM twice. The
// two tables (768 bytes each for the default library; a segmented slot with
// its packed segment table and its leaf datapath rows; a per-table design's
// 2^R rows, whatever its R and widths) are staged in shared memory once per
// block, each from its own pointer; tables that do not fit one block's
// shared memory are refused, not read from global memory. Rows of D <= 1024
// take one warp each (8 rows per block of 256 threads): a lane keeps its
// ceil(D / 32) elements in registers, and the row max and row sum are warp
// shuffles. Longer rows take one block of 256 threads each: the max and the
// sum are reduced through shared memory, and e is recomputed (the same
// arithmetic, so the same bits) for the output pass instead of being stored.
// Any D and any number of rows; the strided loops mask the tails.
//
// `e` depends only on the row max and one element, so it is bit-identical to
// the plain version's; only the order of the row sum differs, which can move
// the reciprocal's table code by one. An optional float32 `e_out` (null on
// the serving path) exposes e so a test can hold it bit-exact.
#include <cmath>

#include <cuda_bf16.h>

#include "datapath.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// Copy both tables (a segmented slot's packed table and leaf rows with it)
// into shared memory at s_exp and s_rec and re-base their TableArgs on the
// copies.
__device__ __forceinline__ void stage_slots(const int32_t* rom_e,
                                            TableArgs& te,
                                            const int32_t* rom_r,
                                            TableArgs& tr, int32_t* s_exp,
                                            int32_t* s_rec) {
  stage_slot(rom_e, te, s_exp);
  stage_slot(rom_r, tr, s_rec);
  __syncthreads();
}

__device__ __forceinline__ float exp_term(float m, float x,
                                          const int32_t* s_exp,
                                          const TableArgs& te) {
  const float t = fminf(__fmul_rn(__fsub_rn(m, x), kLog2e), 126.0f);
  return table_exp_neg(t, s_exp, te);
}

// One warp per row; K = elements per lane (a power of two, 32 * K >= D).
template <typename T, int K>
__global__ void softmax_warp_kernel(const T* __restrict__ x,
                                    T* __restrict__ out,
                                    float* __restrict__ e_out, int64_t rows,
                                    int d, const int32_t* __restrict__ rom_e,
                                    TableArgs te,
                                    const int32_t* __restrict__ rom_r,
                                    TableArgs tr) {
  extern __shared__ int32_t smem[];
  int32_t* s_exp = smem;
  int32_t* s_rec = smem + slot_words(te);
  stage_slots(rom_e, te, rom_r, tr, s_exp, s_rec);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float v[K];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < d ? to_f(xr[i]) : -INFINITY;
    m = fmaxf(m, v[j]);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    if (i < d) {
      v[j] = exp_term(m, v[j], s_exp, te);
      s = __fadd_rn(s, v[j]);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const float r = table_recip(s, s_rec, tr);
  T* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    if (i < d) {
      orow[i] = from_f<T>(__fmul_rn(v[j], r));
      if (e_out) e_out[row * d + i] = v[j];
    }
  }
}

// Block reduction of one value per thread (op: 0 = max, 1 = sum), result
// broadcast to every thread.
__device__ __forceinline__ float block_reduce(float a, int op, float* s_part) {
  for (int o = 16; o > 0; o >>= 1) {
    const float b = __shfl_xor_sync(0xffffffffu, a, o);
    a = op ? __fadd_rn(a, b) : fmaxf(a, b);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_part may still be read by a previous reduction
  if (lane == 0) s_part[warp] = a;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  a = lane < nw ? s_part[lane] : (op ? 0.0f : -INFINITY);
  for (int o = 16; o > 0; o >>= 1) {
    const float b = __shfl_xor_sync(0xffffffffu, a, o);
    a = op ? __fadd_rn(a, b) : fmaxf(a, b);
  }
  return a;
}

// One block per row, for D > 1024.
template <typename T>
__global__ void softmax_block_kernel(const T* __restrict__ x,
                                     T* __restrict__ out,
                                     float* __restrict__ e_out, int d,
                                     const int32_t* __restrict__ rom_e,
                                     TableArgs te,
                                     const int32_t* __restrict__ rom_r,
                                     TableArgs tr) {
  extern __shared__ int32_t smem[];
  __shared__ float s_part[32];
  int32_t* s_exp = smem;
  int32_t* s_rec = smem + slot_words(te);
  stage_slots(rom_e, te, rom_r, tr, s_exp, s_rec);
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < d; i += blockDim.x) m = fmaxf(m, to_f(xr[i]));
  m = block_reduce(m, 0, s_part);
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    s = __fadd_rn(s, exp_term(m, to_f(xr[i]), s_exp, te));
  s = block_reduce(s, 1, s_part);
  const float r = table_recip(s, s_rec, tr);
  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float e = exp_term(m, to_f(xr[i]), s_exp, te);
    orow[i] = from_f<T>(__fmul_rn(e, r));
    if (e_out) e_out[row * d + i] = e;
  }
}

// Launch one instantiation with `smem` bytes of dynamic shared memory,
// raising the kernel's limit above the default 48 KB where needed.
template <typename... P, typename... A>
cudaError_t launch_one(void (*kern)(P...), dim3 grid, size_t smem,
                       cudaStream_t s, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // refused: leave no error for the next launch
      return err;
    }
  }
  kern<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* out, float* e_out, int64_t rows,
                   int d, const int32_t* rom_e, const TableArgs& te,
                   const int32_t* rom_r, const TableArgs& tr,
                   cudaStream_t s) {
  const size_t smem = (size_t)(slot_words(te) + slot_words(tr)) *
                      sizeof(int32_t);
  const T* xi = (const T*)x;
  T* o = (T*)out;
  if (d > 1024) {
    if (rows > INT32_MAX) return cudaErrorInvalidValue;
    return launch_one(softmax_block_kernel<T>, dim3((unsigned)rows), smem, s,
                      xi, o, e_out, d, rom_e, te, rom_r, tr);
  }
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (d <= 64)
    return launch_one(softmax_warp_kernel<T, 2>, grid, smem, s, xi, o, e_out,
                      rows, d, rom_e, te, rom_r, tr);
  if (d <= 128)
    return launch_one(softmax_warp_kernel<T, 4>, grid, smem, s, xi, o, e_out,
                      rows, d, rom_e, te, rom_r, tr);
  if (d <= 256)
    return launch_one(softmax_warp_kernel<T, 8>, grid, smem, s, xi, o, e_out,
                      rows, d, rom_e, te, rom_r, tr);
  if (d <= 512)
    return launch_one(softmax_warp_kernel<T, 16>, grid, smem, s, xi, o,
                      e_out, rows, d, rom_e, te, rom_r, tr);
  return launch_one(softmax_warp_kernel<T, 32>, grid, smem, s, xi, o, e_out,
                    rows, d, rom_e, te, rom_r, tr);
}

// Both entry points: check the tables, then launch on x's dtype (0 =
// float32, 1 = bfloat16). Tables whose staged words do not fit one block's
// shared memory are refused.
int run(const void* x, void* out, float* e_out, int64_t rows, int d,
        int dtype, const int32_t* rom_e, const TableArgs& te,
        const int32_t* rom_r, const TableArgs& tr, int device,
        void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (!table_args_ok(te) || !table_args_ok(tr))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)(slot_words(te) + slot_words(tr)) * 4 + 32 * 4 > limit)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, out, e_out, rows, d, rom_e, te, rom_r, tr,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, out, e_out, rows, d, rom_e, te,
                                      rom_r, tr, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16; e_out:
// (rows, d) float32 or null. exp12 / recip12: the two slots' rows and dp the
// library's leaf rows, see datapath.cuh `table_args`.
extern "C" int repro_softmax_lib(const void* x, void* out, float* e_out,
                                 int64_t rows, int d, int dtype,
                                 const int32_t* rom, const int32_t* dp,
                                 const int32_t* exp12,
                                 const int32_t* recip12, int device,
                                 void* stream) {
  return run(x, out, e_out, rows, d, dtype, rom, table_args(exp12, dp), rom,
             table_args(recip12, dp), device, stream);
}

// The per-table entry: exp_coeffs and recip_coeffs are two designs' own
// (2^R, 3) int32 rows, exp12 / recip12 their rows (row0 0, rows 2^R, no
// segment table), see datapath.cuh `table_args`.
extern "C" int repro_softmax_tab(const void* x, void* out, float* e_out,
                                 int64_t rows, int d, int dtype,
                                 const int32_t* exp_coeffs,
                                 const int32_t* exp12,
                                 const int32_t* recip_coeffs,
                                 const int32_t* recip12, int device,
                                 void* stream) {
  return run(x, out, e_out, rows, d, dtype, exp_coeffs,
             table_args(exp12, nullptr), recip_coeffs,
             table_args(recip12, nullptr), device, stream);
}
