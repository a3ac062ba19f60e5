// The paper's Figure-1 datapath as CUDA device functions, shared by every
// kernel of the port (twin of repro/kernels/interp/kernel.py `poly_tail`,
// `_lut_rom`, `_lut` / `_lut_seg` and repro/kernels/flashattn/kernel.py
// `_table_exp_neg`, `_table_recip`).
//
// Integer semantics follow the reference's int32 datapath: the Horner step
// wraps modulo 2^32 (done in uint32_t, then reinterpreted; signed overflow is
// undefined in C++), region and truncation shifts are logical (uint32_t), the
// final `>> k` is arithmetic on int32_t. The float glue that turns a value
// into a table code uses explicitly rounded operations (__fmul_rn,
// __fsub_rn) so nvcc cannot contract it into an FMA and flip a code at a
// boundary, rintf (round half to even, as jnp.round), and exact powers of
// two (ldexpf, or the exponent field where the exponent is normal).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>

namespace repro {

// One library slot's static datapath: where its rows start in the ROM the
// kernel reads, the (eval_bits, k, sq_trunc, lin_trunc, degree) row, the
// glue widths and, for a segmented (ROM v2) slot, the segment-index depth D,
// the leaf count and the leaves' (eval_bits, k, sq_trunc, lin_trunc, degree)
// rows. A segmented slot holds n_leaves coefficient rows, then the 2^D-entry
// segment-index table packed 3 entries per row, all inside its `rows`.
struct TableArgs {
  int row0;   // first ROM row of the slot (fid * r_max; 0 for a slot view
              // or one design's own rows)
  int rows;   // rows the slot holds (r_max; 2^R for one design's rows)
  int eval_bits, k, sq_trunc, lin_trunc, degree;
  int in_bits, out_bits;
  int seg_depth;           // 0: uniform slot
  int n_leaves;
  const int32_t* leaf_dp;  // n_leaves x 5 rows (segmented slots only)
};

// Truncated square and linear terms, int32 Horner accumulate, arithmetic
// shift by k.
__device__ __forceinline__ int32_t poly_tail(int32_t a, int32_t b, int32_t c,
                                             uint32_t x, int k, int sq,
                                             int lin, int degree) {
  uint32_t xs = (x >> sq) << sq;
  uint32_t xl = (x >> lin) << lin;
  if (degree != 2) xs = 0u;
  uint32_t acc = (uint32_t)a * xs * xs + (uint32_t)b * xl + (uint32_t)c;
  return ((int32_t)acc) >> k;
}

// Segmented slot read (`_lut_seg`): cell = top D bits of the code, leaf =
// entry (n_leaves * 3 + cell) of the slot (the packed table's entries are
// row-major, so no division by 3), then the leaf's coefficient row and its
// own datapath row, with per-element shift amounts. A cell past the table or
// a leaf past the slot reads a zero row, as the reference's one-hot reads.
// Written without branches (selects around in-slot reads), so a caller's
// unrolled loop of table reads stays one block the compiler can interleave.
__device__ __forceinline__ int32_t lut_seg(const int32_t* rom,
                                           const TableArgs& t, uint32_t u) {
  const uint32_t cell = u >> (t.in_bits - t.seg_depth);
  const bool in_cell = cell < (1u << t.seg_depth);
  const int leaf = rom[3 * (t.row0 + t.n_leaves) + (in_cell ? (int)cell : 0)];
  const bool in_leaf = in_cell && (unsigned)leaf < (unsigned)t.n_leaves;
  const int li = in_leaf ? leaf : 0;
  const int32_t* m = t.leaf_dp + 5 * li;
  const int32_t* row = rom + 3 * (t.row0 + li);
  const uint32_t x = u & ((1u << m[0]) - 1u);
  const int32_t v = poly_tail(row[0], row[1], row[2], x, m[1], m[2], m[3],
                              m[4]);
  return in_leaf ? v : 0;
}

// Uniform slot read: region = top bits of the code, x = its low eval_bits
// bits; a region past the slot reads a zero row, as the reference's one-hot
// ROM read does (branch-free, as `lut_seg`).
__device__ __forceinline__ int32_t lut_uniform(const int32_t* rom,
                                               const TableArgs& t,
                                               uint32_t u) {
  const uint32_t r = u >> t.eval_bits;
  const uint32_t x = u & ((1u << t.eval_bits) - 1u);
  const bool in = r < (uint32_t)t.rows;
  const int32_t* row = rom + 3 * (t.row0 + (in ? (int)r : 0));
  const int32_t a = in ? row[0] : 0, b = in ? row[1] : 0, c = in ? row[2] : 0;
  return poly_tail(a, b, c, x, t.k, t.sq_trunc, t.lin_trunc, t.degree);
}

// Table read of a slot whose kind (segmented or not) the caller knows.
template <bool SEG>
__device__ __forceinline__ int32_t lut_slot(const int32_t* rom,
                                            const TableArgs& t, int32_t code) {
  if constexpr (SEG) return lut_seg(rom, t, (uint32_t)code);
  else return lut_uniform(rom, t, (uint32_t)code);
}

// Table read against a ROM of int32 (a, b, c) rows: `lut_uniform` or, for a
// segmented slot, `lut_seg`.
__device__ __forceinline__ int32_t lut_rom(const int32_t* rom,
                                           const TableArgs& t, int32_t code) {
  return t.seg_depth ? lut_slot<true>(rom, t, code)
                     : lut_slot<false>(rom, t, code);
}

__device__ __forceinline__ float pow2i(int e) { return ldexpf(1.0f, e); }

// 2^e for the normal exponents -126 <= e <= 127, exactly (pow2i's value
// there, without its range handling).
__device__ __forceinline__ float pow2_normal(int e) {
  return __int_as_float((e + 127) << 23);
}

// 2^(-t) for t >= 0 through the exp2neg table: 2^-floor(t) * tab(frac(t)),
// t clamped at 126 (so both powers of two are normal), for a slot whose
// kind the caller knows.
template <bool SEG>
__device__ __forceinline__ float exp_neg_slot(float t, const int32_t* rom,
                                              const TableArgs& tb) {
  t = fminf(t, 126.0f);
  float n = floorf(t);
  float frac = __fsub_rn(t, n);
  int eb = tb.in_bits;
  int code = (int)rintf(__fmul_rn(frac, (float)(1 << eb)));
  code = min(max(code, 0), (1 << eb) - 1);
  float tab = (float)lut_slot<SEG>(rom, tb, code);
  return __fmul_rn(__fmul_rn(tab, pow2_normal(-tb.out_bits)),
                   pow2_normal(-(int)n));
}

__device__ __forceinline__ float table_exp_neg(float t, const int32_t* rom,
                                               const TableArgs& tb) {
  return tb.seg_depth ? exp_neg_slot<true>(t, rom, tb)
                      : exp_neg_slot<false>(t, rom, tb);
}

// 1/s for s > 0: IEEE-754 exponent/mantissa split, the reciprocal table on
// the rounded top mantissa bits, exact power-of-two rescale.
__device__ __forceinline__ float table_recip(float s, const int32_t* rom,
                                             const TableArgs& tb) {
  uint32_t bits = __float_as_uint(s);
  int expo = (int)((bits >> 23) & 255u) - 127;
  uint32_t mant = bits & 0x7FFFFFu;
  int rb = tb.in_bits;
  uint32_t half = 1u << (23 - rb - 1);
  int code = (int)((mant + half) >> (23 - rb));
  code = min(code, (1 << rb) - 1);
  float rtab = (float)lut_rom(rom, tb, code);
  return __fmul_rn(__fmul_rn(rtab, pow2i(-(rb + 1))), pow2i(-expo));
}

// The int32 words a slot takes in shared memory: its rows, and a segmented
// slot's leaf rows after them.
__host__ __device__ __forceinline__ int slot_words(const TableArgs& t) {
  return 3 * t.rows + (t.seg_depth ? 5 * t.n_leaves : 0);
}

// Copy one slot (`slot_words` of it) to shared memory at `s` and re-base `t`
// on the copy; returns the words used. The caller synchronizes before
// reading.
__device__ __forceinline__ int stage_slot(const int32_t* rom, TableArgs& t,
                                          int32_t* s) {
  for (int i = threadIdx.x; i < 3 * t.rows; i += blockDim.x)
    s[i] = rom[3 * t.row0 + i];
  if (t.seg_depth) {
    for (int i = threadIdx.x; i < 5 * t.n_leaves; i += blockDim.x)
      s[3 * t.rows + i] = t.leaf_dp[i];
    t.leaf_dp = s + 3 * t.rows;
  }
  t.row0 = 0;
  return slot_words(t);
}

// Asynchronous copies global -> shared (cp.async, sm_80 on).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 (or 4) bytes global -> shared, asynchronously; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `words` int32 words global -> shared with cp.async: 16 bytes a copy
// where both ends are 16-byte aligned (the last words % 4 one at a time),
// else 4 bytes a copy.
__device__ __forceinline__ void copy_words_async(int32_t* dst,
                                                 const int32_t* src,
                                                 int words) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | smem_addr(dst)) & 15u) == 0) {
    for (int v = threadIdx.x; v < words / 4; v += blockDim.x)
      cp_async16(smem_addr(dst + 4 * v), src + 4 * v, 16);
    done = words & ~3;
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x)
    cp_async4(smem_addr(dst + i), src + i, 4);
}

// Copy one table slot to shared memory with cp.async (as `stage_slot`) and
// re-base `t` on the copy; the caller commits, waits and synchronizes.
// VEC16 copies 16 bytes at a time where the rows are 16-byte aligned.
template <bool VEC16 = false>
__device__ __forceinline__ void stage_slot_async(const int32_t* rom,
                                                 TableArgs& t, int32_t* s) {
  if constexpr (VEC16) {
    copy_words_async(s, rom + 3 * t.row0, 3 * t.rows);
    if (t.seg_depth)
      copy_words_async(s + 3 * t.rows, t.leaf_dp, 5 * t.n_leaves);
  } else {
    for (int i = threadIdx.x; i < 3 * t.rows; i += blockDim.x)
      cp_async4(smem_addr(s + i), rom + 3 * t.row0 + i, 4);
    if (t.seg_depth)
      for (int i = threadIdx.x; i < 5 * t.n_leaves; i += blockDim.x)
        cp_async4(smem_addr(s + 3 * t.rows + i), t.leaf_dp + i, 4);
  }
  if (t.seg_depth) t.leaf_dp = s + 3 * t.rows;
  t.row0 = 0;
}

// Host side: the TableArgs of a slot from the wrapper's 12-int row (row0,
// rows, eval_bits, k, sq_trunc, lin_trunc, degree, in_bits, out_bits,
// seg_depth, n_leaves, leaf_base) and the library's (L, 5) leaf datapath
// rows `dp` (walk_rows()[1]; read only for a segmented slot).
inline TableArgs table_args(const int32_t* m, const int32_t* dp) {
  return TableArgs{m[0], m[1], m[2],  m[3],  m[4],
                   m[5], m[6], m[7],  m[8],  m[9],
                   m[10], dp ? dp + 5 * m[11] : nullptr};
}

// A segmented slot needs its leaf rows, a depth the 32-bit shifts take and a
// segment-index table that fits inside its rows.
__host__ __device__ inline bool table_args_ok(const TableArgs& t) {
  if (!t.seg_depth) return true;
  return t.leaf_dp != nullptr && t.seg_depth > 0 && t.seg_depth < 32 &&
         t.seg_depth <= t.in_bits && t.n_leaves > 0 &&
         t.n_leaves + ((1 << t.seg_depth) + 2) / 3 <= t.rows;
}

// Host side: blocks of `threads` that fill every SM of `device` at full
// residency for `kernel` with `smem` bytes of dynamic shared memory (at most
// `per_sm_max` blocks an SM), capped at the blocks `work` items need (one
// per thread). The occupancy is cached per (kernel, threads, smem, device):
// the query reads the kernel's attributes (ctypes calls run without the
// GIL, hence the lock).
inline cudaError_t grid_for(const void* kernel, int threads, size_t smem,
                            int device, int64_t work, int* blocks,
                            int per_sm_max = 64) {
  struct Entry {
    const void* kernel;
    size_t smem;
    int threads, device, resident;
  };
  static Entry cache[128];
  static int used = 0;
  static std::mutex mu;
  const std::lock_guard<std::mutex> lock(mu);
  int resident = 0;
  for (int i = 0; i < used && !resident; ++i)
    if (cache[i].kernel == kernel && cache[i].smem == smem &&
        cache[i].threads == threads && cache[i].device == device)
      resident = cache[i].resident;
  if (!resident) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm < 1 ? 1 : per_sm < per_sm_max ? per_sm
                                                             : per_sm_max);
    if (used < 128)
      cache[used++] = Entry{kernel, smem, threads, device, resident};
  }
  const int64_t need = (work + threads - 1) / threads;
  *blocks = (int)(need < 1 ? 1 : (need < resident ? need : resident));
  return cudaSuccess;
}

// The runtime's current device is per runtime instance: set it to the one
// the caller's tensors live on before every launch.
inline cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace repro
