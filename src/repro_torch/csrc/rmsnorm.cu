// rmsnorm_lib and rmsnorm_tab: fused RMSNorm with the table-backed rsqrt.
//
// Replaces repro/kernels/rmsnorm/kernel.py `fused_rmsnorm_lib` /
// `_rmsnorm_lib_kernel` (the rsqrt slot of a library ROM) and
// `fused_rmsnorm` / `_rmsnorm_kernel` (one design's own (2^R, 3) rows), both
// over `_rmsnorm_body`: ms = mean(x^2) + eps, then the IEEE-754 split of ms,
// the odd/even-exponent code into the rsqrt table over [1, 4) (the half-code
// split at 2^(in_bits - 1) of the table's own in_bits), rs = tab *
// 2^-out_bits * 2^-h, and out = (x * rs) * gamma in x's dtype. gamma comes
// in its stored dtype, float32 or bf16 (bf16 -> f32 is exact), so a model's
// bf16 norm scale needs no cast before the call.
//
// Bound on an H100: bytes at prefill (read x once, write out once, gamma
// once; ~4 flops per element): (512, 4096) bf16 moves 8.4 MB, 2.5 us at
// 3.35 TB/s. At decode (4 rows) it is latency: one load of x, a reduction
// across the row, one table read, one store, in a chain.
// Design:
// - A row is read once, into registers: each thread holds NV chunks of the
//   row (16-byte vectors of 8 bf16 or 4 f32 on the vector body), and the
//   output is written from the same registers. gamma's chunks (in its own
//   dtype) load beside x's, so their latency hides under x's.
// - Threads per row (a multiple of 32, up to 1024) and chunks per thread
//   come from the wrapper (`rmsnorm/kernel.py` `launch_shape`): up to 256
//   threads a row, each with up to 8 chunks, so every load of a row is in
//   flight at once (D = 4096 bf16: 256 threads, two vectors each; measured
//   fastest of 64-1024 threads at decode and at prefill). Rows narrower
//   than 128 threads share a block. A row longer than a block's registers
//   hold (threads x NV chunks) is read again for its output.
// - The rsqrt slot (a library slot, and a segmented slot's leaf rows, or a
//   design's 2^R rows) is staged in shared memory by cp.async issued before
//   the loads of x, so the one table read after the reduction reads shared
//   memory (a slot above 48 KB is read through the cache).
// - The sum of x^2 runs in one fixed order: each thread's chunks in order,
//   a butterfly of warp shuffles (every lane ends with the same bits), then
//   every warp of a row sums the row's warp partials from shared memory in
//   the same order, so all warps agree bitwise with one __syncthreads and
//   no broadcast. The same launch shape gives the same bits, so
//   rmsnorm_tab on the library's own designs equals rmsnorm_lib.
// - The float glue is explicitly rounded: x^2 and the sum without FMA
//   contraction, ms = (s / d) + eps, out = (x * rs) * gamma.
// - Any shape: where D is no multiple of the vector or a pointer is not
//   16-byte aligned (a view at an odd offset) the wrapper picks the masked
//   body of the same kernel, one element per chunk with scalar loads.
#include <cuda_bf16.h>

#include "datapath.cuh"

using namespace repro;

namespace {

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

// VEC elements of T read or written as one access (a 16-byte vector for x
// on the vector body; gamma's chunk is 8, 16 or 32 bytes).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Chunk {
  T v[VEC];
};

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

// Blocks of `tpr` threads per row times rows_per_block rows; NV chunks of
// VEC elements per thread and pass. T is x's dtype, G gamma's.
template <typename T, typename G, int VEC, int NV>
__global__ void __launch_bounds__(NV >= 4 ? 512 : 1024)
    rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   T* __restrict__ out, int rows, int d, int tpr, float eps,
                   const int32_t* __restrict__ rom, TableArgs tb,
                   int staged) {
  extern __shared__ __align__(16) int32_t s_slot[];
  __shared__ float s_part[32];
  const int32_t* tab = rom;
  if (staged) {  // the slot lands while x loads
    stage_slot_async(rom, tb, s_slot);
    cp_async_commit();
    tab = s_slot;
  }
  using XC = Chunk<T, VEC>;
  using GC = Chunk<G, VEC>;
  const int t = threadIdx.x % tpr, r_blk = threadIdx.x / tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + r_blk;
  const bool live = row < rows;
  const XC* xr = reinterpret_cast<const XC*>(x + row * d);
  const GC* gr = reinterpret_cast<const GC*>(gamma);
  XC* orow = reinterpret_cast<XC*>(out + row * d);
  const int n_chunk = d / VEC;  // VEC divides d (the wrapper's choice)
  const int per_pass = tpr * NV;
  XC xv[NV];
  GC gv[NV];
  auto in_row = [&](int c) { return live && c < n_chunk; };
  auto load = [&](int base) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = base + k * tpr + t;
      if (in_row(c)) {
        xv[k] = xr[c];
        gv[k] = gr[c];
      }
    }
  };
  float acc = 0.0f;
  auto accumulate = [&](int base) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!in_row(base + k * tpr + t)) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = to_f(xv[k].v[e]);
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
    }
  };
  // the last pass (the only one where the row fits) stays in registers
  int last = 0;
  load(0);
  for (; last + per_pass < n_chunk; last += per_pass) {
    accumulate(last);
    load(last + per_pass);
  }
  accumulate(last);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_part[warp] = acc;
  if (staged) cp_async_wait<0>();
  __syncthreads();
  const int wpr = tpr >> 5;
  float s = lane < wpr ? s_part[r_blk * wpr + lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (!live) return;
  const float ms = __fadd_rn(__fdiv_rn(s, (float)d), eps);
  const float rs = table_rsqrt(ms, tab, tb);

  auto store = [&](int base) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = base + k * tpr + t;
      if (c >= n_chunk) continue;
      XC o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xv[k].v[e]), rs),
                                     to_f(gv[k].v[e])));
      orow[c] = o;
    }
  };
  store(last);
  for (int base = 0; base < last; base += per_pass) {
    load(base);
    store(base);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct Launch {
  const void* x;
  const void* gamma;
  void* out;
  int rows, d, tpr, rpb;
  float eps;
  const int32_t* rom;
  TableArgs tb;
};

template <typename T, typename G, int VEC, int NV>
int launch(const Launch& a, cudaStream_t s) {
  const size_t slot = (size_t)slot_words(a.tb) * 4;
  const int staged = slot <= 48 * 1024;
  const int blocks = (a.rows + a.rpb - 1) / a.rpb;
  rmsnorm_kernel<T, G, VEC, NV><<<blocks, a.tpr * a.rpb, staged ? slot : 0,
                                  s>>>(
      static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
      static_cast<T*>(a.out), a.rows, a.d, a.tpr, a.eps, a.rom, a.tb, staged);
  return (int)cudaGetLastError();
}

template <typename T, typename G, int VEC>
int launch_nv(int nv, const Launch& a, cudaStream_t s) {
  switch (nv) {
    case 1: return launch<T, G, VEC, 1>(a, s);
    case 2: return launch<T, G, VEC, 2>(a, s);
    case 4: return launch<T, G, VEC, 4>(a, s);
    default: return launch<T, G, VEC, 8>(a, s);
  }
}

template <typename T, typename G>
int launch_body(int vector, int nv, const Launch& a, cudaStream_t s) {
  return vector ? launch_nv<T, G, 16 / sizeof(T)>(nv, a, s)
                : launch_nv<T, G, 1>(nv, a, s);
}

// shape4: body (1 vector, 0 masked), threads per row, chunks per thread,
// rows per block (kernel.py `launch_shape`).
int run(const void* x, const void* gamma, void* out, int rows, int d,
        int dtype, int gamma_dtype, float eps, const int32_t* rom,
        const TableArgs& tb, const int32_t* shape4, int device,
        void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int vector = shape4[0], tpr = shape4[1], nv = shape4[2],
            rpb = shape4[3];
  const int vec = vector ? (dtype == 0 ? 4 : 8) : 1;
  const int max_threads = nv >= 4 ? 512 : 1024;
  if (!table_args_ok(tb) || dtype < 0 || dtype > 1 || gamma_dtype < 0 ||
      gamma_dtype > 1 || vector < 0 || vector > 1 || tpr < 32 ||
      tpr % 32 || rpb < 1 || tpr * rpb > max_threads ||
      (nv != 1 && nv != 2 && nv != 4 && nv != 8) || rows < 0 || d < 1 ||
      (vector && (d % vec || !aligned16(x) || !aligned16(gamma) ||
                  !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Launch a{x, gamma, out, rows, d, tpr, rpb, eps, rom, tb};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return gamma_dtype ? launch_body<float, bf16>(vector, nv, a, s)
                       : launch_body<float, float>(vector, nv, a, s);
  return gamma_dtype ? launch_body<bf16, bf16>(vector, nv, a, s)
                     : launch_body<bf16, float>(vector, nv, a, s);
}

}  // namespace

// dtype / gamma_dtype: 0 = float32, 1 = bfloat16. meta12, dp: see
// datapath.cuh `table_args`; shape4: see `run`.
extern "C" int repro_rmsnorm_lib(const void* x, const void* gamma, void* out,
                                 int rows, int d, int dtype, int gamma_dtype,
                                 float eps, const int32_t* rom,
                                 const int32_t* dp, const int32_t* meta12,
                                 const int32_t* shape4, int device,
                                 void* stream) {
  return run(x, gamma, out, rows, d, dtype, gamma_dtype, eps, rom,
             table_args(meta12, dp), shape4, device, stream);
}

// The per-table entry: coeffs are one design's own (2^R, 3) int32 rows,
// meta12 its row (row0 0, rows 2^R, no segment table).
extern "C" int repro_rmsnorm_tab(const void* x, const void* gamma, void* out,
                                 int rows, int d, int dtype, int gamma_dtype,
                                 float eps, const int32_t* coeffs,
                                 const int32_t* meta12,
                                 const int32_t* shape4, int device,
                                 void* stream) {
  return run(x, gamma, out, rows, d, dtype, gamma_dtype, eps, coeffs,
             table_args(meta12, nullptr), shape4, device, stream);
}
