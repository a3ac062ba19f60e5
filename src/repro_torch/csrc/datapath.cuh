// The paper's Figure-1 datapath as CUDA device functions, shared by every
// kernel of the port (twin of repro/kernels/interp/kernel.py `poly_tail`,
// `_lut_rom` and repro/kernels/flashattn/kernel.py `_table_exp_neg`,
// `_table_recip`).
//
// Integer semantics follow the reference's int32 datapath: the Horner step
// wraps modulo 2^32 (done in uint32_t, then reinterpreted; signed overflow is
// undefined in C++), region and truncation shifts are logical (uint32_t), the
// final `>> k` is arithmetic on int32_t. The float glue that turns a value
// into a table code uses explicitly rounded operations (__fmul_rn,
// __fsub_rn) so nvcc cannot contract it into an FMA and flip a code at a
// boundary, rintf (round half to even, as jnp.round), and exact powers of
// two (ldexpf).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// One library slot's static datapath: where its rows start in the ROM the
// kernel reads, the (eval_bits, k, sq_trunc, lin_trunc, degree) row, and the
// glue widths.
struct TableArgs {
  int row0;   // first ROM row of the slot (fid * r_max, or 0 for a slot view)
  int rows;   // rows the slot holds (r_max)
  int eval_bits, k, sq_trunc, lin_trunc, degree;
  int in_bits, out_bits;
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

// Table read against a ROM of int32 (a, b, c) rows: region = top bits of the
// code, x = its low eval_bits bits. A region past the slot reads a zero row,
// as the reference's one-hot ROM read does.
__device__ __forceinline__ int32_t lut_rom(const int32_t* rom,
                                           const TableArgs& t, int32_t code) {
  uint32_t u = (uint32_t)code;
  uint32_t r = u >> t.eval_bits;
  uint32_t x = u & ((1u << t.eval_bits) - 1u);
  int32_t a = 0, b = 0, c = 0;
  if (r < (uint32_t)t.rows) {
    const int32_t* row = rom + 3 * (t.row0 + (int)r);
    a = row[0];
    b = row[1];
    c = row[2];
  }
  return poly_tail(a, b, c, x, t.k, t.sq_trunc, t.lin_trunc, t.degree);
}

__device__ __forceinline__ float pow2i(int e) { return ldexpf(1.0f, e); }

// 2^(-t) for t >= 0 through the exp2neg table: 2^-floor(t) * tab(frac(t)).
__device__ __forceinline__ float table_exp_neg(float t, const int32_t* rom,
                                               const TableArgs& tb) {
  t = fminf(t, 126.0f);
  float n = floorf(t);
  float frac = __fsub_rn(t, n);
  int eb = tb.in_bits;
  int code = (int)rintf(__fmul_rn(frac, (float)(1 << eb)));
  code = min(max(code, 0), (1 << eb) - 1);
  float tab = (float)lut_rom(rom, tb, code);
  return __fmul_rn(__fmul_rn(tab, pow2i(-tb.out_bits)), pow2i(-(int)n));
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

// Host side: the TableArgs of a slot from the wrapper's 9-int row
// (row0, rows, eval_bits, k, sq_trunc, lin_trunc, degree, in_bits, out_bits).
inline TableArgs table_args(const int32_t* m) {
  return TableArgs{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8]};
}

// The runtime's current device is per runtime instance: set it to the one
// the caller's tensors live on before every launch.
inline cudaError_t use_device(int device) { return cudaSetDevice(device); }

}  // namespace repro
