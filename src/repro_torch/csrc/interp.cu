// The elementwise table reads of the port: library_eval and library_walk
// (int32 codes -> int32 table outputs, one function id for every element
// or one per element), rom_eval (one slot of the flat ROM), interp_eval
// (one design's own rows) and the fused activation act_lib (x in bf16 or
// f32 -> the activation in x's dtype, the float glue inside the kernel).
//
// library_eval replaces repro/kernels/interp/kernel.py `library_eval_2d` /
// `_library_kernel` (l.241): element i evaluates function fids[i] on
// codes[i] through its (eval_bits, k, sq_trunc, lin_trunc, degree) meta row
// and ROM row fid * r_max + (code >> eval_bits). library_walk replaces
// `library_walk_2d` / `_library_walk_kernel` (l.336): the same over a
// library whose slots may be segmented (ROM v2). Element i reads the walk
// row (in_bits, depth, seg_flag, leaf_base, n_leaves) of fids[i]: a uniform
// slot's datapath row is dp[leaf_base] and its region the top bits of the
// code; a segmented slot resolves cell = code >> (in_bits - depth) to a leaf
// through its packed segment-index table, then reads the leaf's ROM row and
// datapath row dp[leaf_base + leaf]. A malformed walk row (a base or leaf
// count past the dp rows, a segment table that does not fit the slot or a
// depth the shifts cannot take) becomes an empty slot, which reads 0 as an
// out-of-range id or region does. rom_eval replaces `rom_eval_2d` (l.175)
// and interp_eval `interp_eval_2d` (l.366): one slot whose table row the
// host passes (a library slot, uniform or segmented; or one design's
// (2^R, 3) rows). All four run over `datapath.cuh`'s `lut_slot` / `lut_rom`.
//
// act_lib is the served activation, `FusedInterpNumerics._act`: the
// reference computes it as the float glue of `_range_glue` / `_act_tails`
// (repro/numerics/ops.py) around `library_eval_2d` (uniform library) or
// `library_walk_2d`; here glue and table read are one kernel, with the
// glue's rounding: clamp to [lo, f32(hi - 1e-6)], (xc - lo) / f32(hi - lo)
// as an IEEE divide, round half to even times 2^in_bits, clamp to the
// codes, the table output times f32(span / 2^out_bits), and the tails
// compared in x's dtype (the wrapper rounds lo and hi to it). It reads x as
// rows at one stride, so the gate half of a SwiGLU product (a
// `torch.chunk` view) goes in without a copy.
//
// Bound on an H100: bytes. An element reads a 4-byte code (and a 4-byte id
// unless one id serves every element) and writes a 4-byte result; the fused
// activation reads and writes x's 2 or 4 bytes. Against that stand a few
// dozen integer and float instructions per element. Design: 16-byte vector
// loads and stores (8 bf16, or 4 int32 or f32, per thread and step, two
// steps in flight), the scalar tail after them, and the scalar path alone
// where a pointer (or act_lib's row stride) is not 16-byte aligned (a view
// with a storage offset).
// One slot (one id for every element, rom_eval, interp_eval) has one body,
// `read_one_slot`: each thread issues the loads of its first codes, then the
// block stages the slot by cp.async under them (16-byte copies where the
// rows are 16-byte aligned), waits once and reads with the TableArgs in
// registers and the slot's kind a template parameter, so no element
// branches on it. A design's rows past a block's opt-in shared memory are
// read where they lie (interp_eval only). With one id per element the block
// stages the whole ROM, the leaf rows and one TableArgs per function, read
// by reference. act_lib on a large call (16 elements per code, 2^in_bits,
// on a segmented slot, 384 on a uniform one) evaluates the slot once per
// code into a float table of outputs in shared memory, so an element costs
// the glue and one shared load. The grid fills every SM at full residency
// (the occupancy query) and no more.
#include <cuda_bf16.h>

#include <cmath>

#include "datapath.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
// act_lib's table-of-outputs body: one block of 1024 threads per SM, so
// each SM builds the table once
constexpr int kLutThreads = 1024;

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The TableArgs of function f: library_eval's meta row (a uniform slot) or
// library_walk's walk row, with the datapath rows `dp` (global, or staged
// in shared memory) of n_dp rows. A malformed walk row is an empty slot.
template <bool WALK>
__device__ __forceinline__ TableArgs slot_of(int f, int r_max,
                                             const int32_t* rows,
                                             const int32_t* dp, int n_dp) {
  const int32_t* w = rows + 5 * f;
  if constexpr (!WALK) {
    return TableArgs{f * r_max, r_max, w[0], w[1], w[2], w[3],
                     w[4],      0,     0,    0,    0,    nullptr};
  } else {  // w: in_bits, depth, seg_flag, leaf_base, n_leaves
    const int base = w[3], n_rows = w[2] ? w[4] : 1;
    TableArgs t{f * r_max, r_max, 0, 0, 0, 0, 0, w[0], 0, 0, 0, nullptr};
    bool ok = base >= 0 && n_rows > 0 && base + n_rows <= n_dp;
    if (ok && w[2]) {
      t.seg_depth = w[1];
      t.n_leaves = w[4];
      t.leaf_dp = dp + 5 * base;
      ok = table_args_ok(t);
    } else if (ok) {
      const int32_t* m = dp + 5 * base;
      t.eval_bits = m[0];
      t.k = m[1];
      t.sq_trunc = m[2];
      t.lin_trunc = m[3];
      t.degree = m[4];
    }
    if (!ok) t = TableArgs{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, nullptr};
    return t;
  }
}

// out[i] = read(codes[i], fids[i]): 16-byte vectors of 4 codes and 4 ids
// over the first n_vec * 4 elements, two vectors in flight per thread and
// step, then one element at a time.
template <typename Read>
__device__ __forceinline__ void stream_codes(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ fids,
    int32_t* __restrict__ out, int64_t n, int64_t n_vec, Read read) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int4* cv = reinterpret_cast<const int4*>(codes);
  const int4* fv = reinterpret_cast<const int4*>(fids);
  int4* ov = reinterpret_cast<int4*>(out);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int64_t i = tid; i < n_vec; i += 2 * step) {
    const bool two = i + step < n_vec;
    const int4 c0 = __ldg(cv + i);
    const int4 c1 = two ? __ldg(cv + i + step) : zero;
    const int4 f0 = __ldg(fv + i);
    const int4 f1 = two ? __ldg(fv + i + step) : zero;
    ov[i] = make_int4(read(c0.x, f0.x), read(c0.y, f0.y), read(c0.z, f0.z),
                      read(c0.w, f0.w));
    if (two)
      ov[i + step] = make_int4(read(c1.x, f1.x), read(c1.y, f1.y),
                               read(c1.z, f1.z), read(c1.w, f1.w));
  }
  for (int64_t i = n_vec * 4 + tid; i < n; i += step)
    out[i] = read(codes[i], fids[i]);
}

// The codes a thread reads first, loaded before its block stages the slot
// so that the two latencies overlap: its first two 16-byte vectors and its
// first element past the vectors (of the tail, or of every element on the
// scalar path).
struct CodeHead {
  int4 c0, c1;
  int32_t s0;
};

__device__ __forceinline__ int4 code_vec(const int32_t* __restrict__ codes,
                                         int64_t v, int64_t n_vec) {
  return v < n_vec ? __ldg(reinterpret_cast<const int4*>(codes) + v)
                   : make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ int32_t code_at(const int32_t* __restrict__ codes,
                                           int64_t i, int64_t n) {
  return i < n ? __ldg(codes + i) : 0;
}

__device__ __forceinline__ CodeHead code_head(
    const int32_t* __restrict__ codes, int64_t n, int64_t n_vec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  return CodeHead{code_vec(codes, tid, n_vec),
                  code_vec(codes, tid + step, n_vec),
                  code_at(codes, n_vec * 4 + tid, n)};
}

// The one-slot body: out[i] = lut_slot<SEG>(slot, t, codes[i]) after
// `code_head`. With STAGED the block stages the slot in shared memory `s`
// by cp.async under the head's loads (16-byte copies where the rows are
// 16-byte aligned), waits once and reads the copy; without it the slot is
// read where it lies, through the read-only cache. Then 16-byte vectors of
// 4 codes, two per thread and step with the next two in flight, and the
// elements past them one at a time, the next one in flight.
template <bool SEG, bool STAGED>
__device__ __forceinline__ void read_one_slot(
    const int32_t* __restrict__ codes, int32_t* __restrict__ out, int64_t n,
    int64_t n_vec, const int32_t* __restrict__ rom, TableArgs t, int32_t* s,
    CodeHead h) {
  const int32_t* __restrict__ slot = rom;
  if constexpr (STAGED) {
    stage_slot_async<true>(rom, t, s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    slot = s;
  }
  auto read = [&](int32_t c) { return lut_slot<SEG>(slot, t, c); };
  auto read4 = [&](int4 c) {
    return make_int4(read(c.x), read(c.y), read(c.z), read(c.w));
  };
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  int4* ov = reinterpret_cast<int4*>(out);
  for (int64_t i = tid; i < n_vec; i += 2 * step) {
    const int4 c0 = h.c0, c1 = h.c1;
    h.c0 = code_vec(codes, i + 2 * step, n_vec);
    h.c1 = code_vec(codes, i + 3 * step, n_vec);
    ov[i] = read4(c0);
    if (i + step < n_vec) ov[i + step] = read4(c1);
  }
  for (int64_t i = n_vec * 4 + tid; i < n; i += step) {
    const int32_t c = h.s0;
    h.s0 = code_at(codes, i + step, n);
    out[i] = read(c);
  }
}

// library_eval (WALK false: `rows` are the (F, 5) meta rows, no dp) and
// library_walk (WALK true: `rows` are the walk rows, dp the leaf rows),
// with one id fid0 for every element (PER false) or fids[i] (PER true).
template <bool WALK, bool PER>
__global__ void __launch_bounds__(kThreads) table_read_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ fids,
    int fid0, const int32_t* __restrict__ rom,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ dp,
    int n_funcs, int r_max, int n_dp, int32_t* __restrict__ out, int64_t n,
    int64_t n_vec) {
  extern __shared__ __align__(16) unsigned char read_smem[];
  if constexpr (!PER) {
    // one slot: the first codes in flight, its TableArgs in registers, the
    // slot alone staged; its kind picks the body once
    const CodeHead h = code_head(codes, n, n_vec);
    int32_t* s = reinterpret_cast<int32_t*>(read_smem);
    const TableArgs t =
        (unsigned)fid0 < (unsigned)n_funcs
            ? slot_of<WALK>(fid0, r_max, rows, dp, n_dp)
            : TableArgs{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, nullptr};
    if (WALK && t.seg_depth)
      read_one_slot<true, true>(codes, out, n, n_vec, rom, t, s, h);
    else
      read_one_slot<false, true>(codes, out, n, n_vec, rom, t, s, h);
  } else {
    // every slot: the ROM, the leaf rows and one TableArgs per function
    TableArgs* s_args = reinterpret_cast<TableArgs*>(read_smem);
    int32_t* s_rom = reinterpret_cast<int32_t*>(s_args + n_funcs);
    int32_t* s_dp = s_rom + n_funcs * r_max * 3;
    for (int i = threadIdx.x; i < n_funcs * r_max * 3; i += blockDim.x)
      s_rom[i] = rom[i];
    if (WALK)
      for (int i = threadIdx.x; i < 5 * n_dp; i += blockDim.x) s_dp[i] = dp[i];
    __syncthreads();
    for (int f = threadIdx.x; f < n_funcs; f += blockDim.x)
      s_args[f] = slot_of<WALK>(f, r_max, rows, s_dp, n_dp);
    __syncthreads();
    stream_codes(codes, fids, out, n, n_vec, [&](int32_t c, int f) {
      if ((unsigned)f >= (unsigned)n_funcs) return 0;
      const TableArgs& t = s_args[f];
      return WALK ? lut_rom(s_rom, t, c) : lut_slot<false>(s_rom, t, c);
    });
  }
}

// rom_eval and interp_eval: the one-slot body on a slot whose TableArgs the
// host built, its kind (SEG) and its place (STAGED: shared memory, else
// global) template parameters.
template <bool SEG, bool STAGED>
__global__ void __launch_bounds__(kThreads) slot_read_kernel(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ rom,
    TableArgs t, int32_t* __restrict__ out, int64_t n, int64_t n_vec) {
  extern __shared__ __align__(16) unsigned char read_smem[];
  const CodeHead h = code_head(codes, n, n_vec);
  read_one_slot<SEG, STAGED>(codes, out, n, n_vec, rom, t,
                             reinterpret_cast<int32_t*>(read_smem), h);
}

// Blocks of kThreads for `kernel` on n codes, of which n_vec 16-byte
// vectors (0 where a pointer is not 16-byte aligned).
static cudaError_t code_grid(const void* kernel, size_t smem, int device,
                             const int32_t* codes, const int32_t* fids,
                             const int32_t* out, int64_t n, int64_t* n_vec,
                             int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  *n_vec = aligned16(codes) && aligned16(fids) && aligned16(out) ? n / 4 : 0;
  return grid_for(kernel, kThreads, smem, device, *n_vec ? *n_vec : n,
                  blocks);
}

// The C entries of library_eval and library_walk: fids is one id per
// element, or null to evaluate function fid0 everywhere.
template <bool WALK>
static int launch_table_read(const int32_t* codes, const int32_t* fids,
                             int fid0, const int32_t* rom,
                             const int32_t* rows, const int32_t* dp,
                             int n_funcs, int r_max, int n_dp, int32_t* out,
                             int64_t n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const bool per = fids != nullptr;
  const void* kernel =
      per ? (const void*)table_read_kernel<WALK, true>
          : (const void*)table_read_kernel<WALK, false>;
  const size_t smem =
      per ? (size_t)n_funcs * sizeof(TableArgs) +
                (size_t)(n_funcs * r_max * 3 + (WALK ? 5 * n_dp : 0)) * 4
          : (size_t)(3 * r_max + (WALK ? 5 * n_dp : 0)) * 4;
  int64_t n_vec = 0;
  int blocks = 0;
  err = code_grid(kernel, smem, device, codes, fids, out, n, &n_vec, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (per)
    table_read_kernel<WALK, true>
        <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
            codes, fids, fid0, rom, rows, dp, n_funcs, r_max, n_dp, out, n,
            n_vec);
  else
    table_read_kernel<WALK, false>
        <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
            codes, fids, fid0, rom, rows, dp, n_funcs, r_max, n_dp, out, n,
            n_vec);
  return (int)cudaGetLastError();
}

extern "C" int repro_library_eval(const int32_t* codes, const int32_t* fids,
                                  int fid0, const int32_t* rom,
                                  const int32_t* meta, int n_funcs, int r_max,
                                  int32_t* out, int64_t n, int device,
                                  void* stream) {
  return launch_table_read<false>(codes, fids, fid0, rom, meta, nullptr,
                                  n_funcs, r_max, 0, out, n, device, stream);
}

extern "C" int repro_library_walk(const int32_t* codes, const int32_t* fids,
                                  int fid0, const int32_t* rom,
                                  const int32_t* walk, const int32_t* dp,
                                  int n_funcs, int r_max, int n_dp,
                                  int32_t* out, int64_t n, int device,
                                  void* stream) {
  return launch_table_read<true>(codes, fids, fid0, rom, walk, dp, n_funcs,
                                 r_max, n_dp, out, n, device, stream);
}

// The activation's float glue around one slot's table read, as constants
// the host rounds once: the window [lo, hi_clamp], its span, 2^in_bits, the
// output scale span / 2^out_bits, lo and hi rounded to x's dtype for the
// tails, the tails' values (top_is_x: the right tail passes x through) and
// the last code.
struct ActGlue {
  float lo, hi_clamp, span, qscale, scale, lo_cmp, hi_cmp, top, bot;
  int code_max, top_is_x;
};

// The table code of x: clamp, subtract, divide by the span (an IEEE divide,
// as the glue's), times 2^in_bits, round half to even, clamp. fmaxf takes lo
// for a NaN x: code 0, the code the glue's NaN converts to. v >= 0, so only
// the top needs a clamp.
__device__ __forceinline__ int act_code(float x, const ActGlue& g) {
  const float d = __fsub_rn(fminf(fmaxf(x, g.lo), g.hi_clamp), g.lo);
  const float v = __fmul_rn(__fdiv_rn(d, g.span), g.qscale);
  return min(__float2int_rn(v), g.code_max);
}

// The table output of `code` in float: the integer datapath times the scale.
template <bool SEG>
__device__ __forceinline__ float act_table(const int32_t* rom,
                                           const TableArgs& t, int code,
                                           const ActGlue& g) {
  return __fmul_rn(__int2float_rn(lut_slot<SEG>(rom, t, code)), g.scale);
}

// The tails, compared against lo and hi rounded to x's dtype.
__device__ __forceinline__ float act_tails(float x, float y,
                                           const ActGlue& g) {
  const float top = g.top_is_x ? x : g.top;
  return x >= g.hi_cmp ? top : (x <= g.lo_cmp ? g.bot : y);
}

__device__ __forceinline__ float act_load(const float* p) { return *p; }
__device__ __forceinline__ float act_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void act_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void act_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two bf16 of a 32-bit word as floats (exact), and back rounded to nearest
// even (cvt.rn.bf16x2.f32 puts its first operand in the upper half).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// One 16-byte vector of x through f.
template <typename F>
__device__ __forceinline__ uint4 act_vec(uint4 w, float /*tag*/, F f) {
  return make_uint4(__float_as_uint(f(__uint_as_float(w.x))),
                    __float_as_uint(f(__uint_as_float(w.y))),
                    __float_as_uint(f(__uint_as_float(w.z))),
                    __float_as_uint(f(__uint_as_float(w.w))));
}
template <typename F>
__device__ __forceinline__ uint4 act_vec(uint4 w, __nv_bfloat16 /*tag*/,
                                         F f) {
  return make_uint4(bf16x2(f(bf16_lo(w.x)), f(bf16_hi(w.x))),
                    bf16x2(f(bf16_lo(w.y)), f(bf16_hi(w.y))),
                    bf16x2(f(bf16_lo(w.z)), f(bf16_hi(w.z))),
                    bf16x2(f(bf16_lo(w.w)), f(bf16_hi(w.w))));
}

// x as `rows` rows of `cols` elements, row r at x + r * stride (one row for
// a contiguous x; the gate half of a SwiGLU product is a view of stride
// 2 * cols), y contiguous. Each row leads with `vpr` 16-byte vectors and
// ends with `tail` elements; with more than one row, vpr * V == cols or
// vpr == 0 (a layout the vectors cannot take goes element by element).
struct ActRows {
  int64_t rows, cols, stride, vpr, tail;
};

// i / d for i >= 0 and d >= 1, in 32 bits where both fit
__device__ __forceinline__ int64_t row_of(int64_t i, int64_t d) {
  return (uint64_t)(i | d) <= 0xFFFFFFFFull
             ? (int64_t)((uint32_t)i / (uint32_t)d)
             : i / d;
}

// y = f(x) after the block's prologue (staging its tables): the rows' 16-byte
// vectors, two per thread and step, the next two loaded while these are
// computed (and the first two while the prologue runs), then the rows'
// tails one element at a time.
template <typename T, typename P, typename F>
__device__ __forceinline__ void stream_act(const T* __restrict__ x,
                                           T* __restrict__ y, ActRows s,
                                           P prologue, F f) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = s.rows * s.vpr;
  auto load = [&](int64_t v) {
    if (v >= n_vec) return make_uint4(0, 0, 0, 0);
    const int64_t r = row_of(v, s.vpr);
    return __ldg(reinterpret_cast<const uint4*>(x + r * s.stride +
                                                (v - r * s.vpr) * V));
  };
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 w0 = load(tid), w1 = load(tid + step);
  prologue();
  for (int64_t i = tid; i < n_vec; i += 2 * step) {
    const uint4 c0 = w0, c1 = w1;
    w0 = load(i + 2 * step);
    w1 = load(i + 3 * step);
    yv[i] = act_vec(c0, T{}, f);
    if (i + step < n_vec) yv[i + step] = act_vec(c1, T{}, f);
  }
  for (int64_t i = tid; i < s.rows * s.tail; i += step) {
    const int64_t r = row_of(i, s.tail);
    const int64_t c = s.vpr * V + (i - r * s.tail);
    act_store(y + r * s.cols + c, f(act_load(x + r * s.stride + c)));
  }
}

// y = the activation of x through one slot, staged alone; T is x's dtype,
// SEG the slot's kind. With LUT each block first evaluates the slot at
// every code into a float table of outputs in shared memory (2^in_bits
// floats, 16 KB at 12 bits), so an element costs the glue and one shared
// load: the datapath, and a segmented slot's decode, run 2^in_bits times
// per block instead of once per element. Without it every element runs the
// datapath.
template <typename T, bool SEG, bool LUT>
__global__ void __launch_bounds__(LUT ? kLutThreads : kThreads)
    act_lib_kernel(const T* __restrict__ x, T* __restrict__ y, ActRows s,
                   const int32_t* __restrict__ rom, TableArgs t, ActGlue g) {
  extern __shared__ __align__(16) int32_t act_smem[];
  float* outs = reinterpret_cast<float*>(act_smem + slot_words(t));
  auto prologue = [&] {
    stage_slot(rom, t, act_smem);
    __syncthreads();
    if (LUT) {
      for (int c = threadIdx.x; c <= g.code_max; c += blockDim.x)
        outs[c] = act_table<SEG>(act_smem, t, c, g);
      __syncthreads();
    }
  };
  if constexpr (LUT)
    stream_act(x, y, s, prologue, [&](float v) {
      return act_tails(v, outs[act_code(v, g)], g);
    });
  else
    stream_act(x, y, s, prologue, [&](float v) {
      return act_tails(v, act_table<SEG>(act_smem, t, act_code(v, g), g), g);
    });
}

// Where the table of outputs beats the per-element datapath, from both
// bodies timed at the served shapes on an H100 (chip_smoke.py act_phase,
// `body_graph_ms`): a segmented slot's decode costs more an element, so
// its table pays from 16 elements per code on (the datapath wins at 11, the
// two are level at 351), a uniform slot's from 384 (the datapath wins at
// 351, the table at 440). A table past 13 bits (32 KB) is not built.
constexpr int kLutMaxBits = 13;
constexpr int kLutMinPerCodeSeg = 16;
constexpr int kLutMinPerCodeUniform = 384;

template <typename T, bool SEG, bool LUT>
static int launch_act(const void* x, void* y, ActRows s, const int32_t* rom,
                      const TableArgs& t, const ActGlue& g, int device,
                      void* stream) {
  const void* kernel = (const void*)act_lib_kernel<T, SEG, LUT>;
  const int threads = LUT ? kLutThreads : kThreads;
  const size_t smem =
      (size_t)(slot_words(t) + (LUT ? g.code_max + 1 : 0)) * 4;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(y) &&
                   (s.rows == 1 || (s.cols % V == 0 && s.stride % V == 0));
  s.vpr = vec ? s.cols / V : 0;
  s.tail = s.cols - s.vpr * V;
  int blocks = 0;
  err = grid_for(kernel, threads, smem, device,
                 s.rows * (s.vpr ? s.vpr : s.cols), &blocks, LUT ? 1 : 64);
  if (err != cudaSuccess) return (int)err;
  act_lib_kernel<T, SEG, LUT><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s, rom, t, g);
  return (int)cudaGetLastError();
}

template <typename T, bool SEG>
static int launch_act(bool lut, const void* x, void* y, ActRows s,
                      const int32_t* rom, const TableArgs& t,
                      const ActGlue& g, int device, void* stream) {
  return lut ? launch_act<T, SEG, true>(x, y, s, rom, t, g, device, stream)
             : launch_act<T, SEG, false>(x, y, s, rom, t, g, device, stream);
}

// x: rows of cols elements of bf16 (bf16 != 0) or f32, row r at x + r *
// stride elements (the last dim contiguous); y: the rows * cols results,
// contiguous. slot12: the slot's 12-int table row (datapath.cuh
// `table_args`), dp the library's leaf rows; glue: lo, f32(hi - 1e-6),
// f32(hi - lo), f32(span / 2^out_bits), lo and hi rounded to x's dtype, the
// top and bottom tail values; top_is_x: the right tail is x itself. body:
// -1 picks by size (kLutMinPerCode*), 0 the per-element datapath, 1 the
// table of outputs.
extern "C" int repro_act_lib(const void* x, void* y, int64_t rows,
                             int64_t cols, int64_t stride, int bf16,
                             const int32_t* rom, const int32_t* slot12,
                             const int32_t* dp, const float* glue,
                             int top_is_x, int body, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const TableArgs t = table_args(slot12, dp);
  const float span = glue[2];
  if (!table_args_ok(t) || t.in_bits < 1 || t.in_bits > 30 ||
      !(span > 0.0f) || !std::isfinite(span) || rows < 0 || cols < 0 ||
      stride < 0 || body < -1 || body > 1 ||
      (body == 1 && t.in_bits > kLutMaxBits))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  const ActGlue g{glue[0], glue[1], span, ldexpf(1.0f, t.in_bits), glue[3],
                  glue[4], glue[5], glue[6], glue[7], (1 << t.in_bits) - 1,
                  top_is_x};
  const int64_t per_code =
      t.seg_depth ? kLutMinPerCodeSeg : kLutMinPerCodeUniform;
  const bool lut = body == -1 ? t.in_bits <= kLutMaxBits &&
                                    rows * cols >= per_code << t.in_bits
                              : body == 1;
  const ActRows s{rows, cols, stride, 0, 0};
  if (bf16)
    return t.seg_depth ? launch_act<__nv_bfloat16, true>(lut, x, y, s, rom, t,
                                                         g, device, stream)
                       : launch_act<__nv_bfloat16, false>(lut, x, y, s, rom,
                                                          t, g, device, stream);
  return t.seg_depth
             ? launch_act<float, true>(lut, x, y, s, rom, t, g, device, stream)
             : launch_act<float, false>(lut, x, y, s, rom, t, g, device,
                                        stream);
}

template <bool SEG, bool STAGED>
static int launch_slot_read(const int32_t* codes, const int32_t* rom,
                            const TableArgs& t, int32_t* out, int64_t n,
                            int device, void* stream) {
  const void* kernel = (const void*)slot_read_kernel<SEG, STAGED>;
  const size_t smem = STAGED ? (size_t)slot_words(t) * 4 : 0;
  int64_t n_vec = 0;
  int blocks = 0;
  const cudaError_t err =
      code_grid(kernel, smem, device, codes, nullptr, out, n, &n_vec, &blocks);
  if (err != cudaSuccess) return (int)err;
  slot_read_kernel<SEG, STAGED><<<blocks, kThreads, smem,
                                  (cudaStream_t)stream>>>(codes, rom, t, out,
                                                          n, n_vec);
  return (int)cudaGetLastError();
}

// The C entries of rom_eval and interp_eval. The slot is staged while it
// fits a block's opt-in shared memory; past it, interp_eval (global_ok)
// reads the rows where they lie and rom_eval refuses the slot, as it
// refuses a malformed one.
static int slot_read(const int32_t* codes, const int32_t* rom,
                     const TableArgs& t, int32_t* out, int64_t n,
                     bool global_ok, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const bool fits = (size_t)slot_words(t) * 4 <= (size_t)optin;
  if (!table_args_ok(t) || (!fits && !global_ok))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (t.seg_depth)
    return launch_slot_read<true, true>(codes, rom, t, out, n, device, stream);
  return fits ? launch_slot_read<false, true>(codes, rom, t, out, n, device,
                                              stream)
              : launch_slot_read<false, false>(codes, rom, t, out, n, device,
                                               stream);
}

// rom_eval replaces repro/kernels/interp/kernel.py `rom_eval_2d` /
// `_rom_kernel` (l.175), the golden harness of the in-kernel read: one slot
// of the flat (F * r_max, 3) ROM, uniform or segmented, through the
// `lut_slot` the fused kernels inline. slot12: see datapath.cuh
// `table_args`; dp: the library's leaf rows.
extern "C" int repro_rom_eval(const int32_t* codes, const int32_t* rom,
                              const int32_t* slot12, const int32_t* dp,
                              int32_t* out, int64_t n, int device,
                              void* stream) {
  return slot_read(codes, rom, table_args(slot12, dp), out, n, false, device,
                   stream);
}

// interp_eval replaces repro/kernels/interp/kernel.py `interp_eval_2d` /
// `_interp_kernel` (l.366): one design's (2^R, 3) int32 rows, region = code
// >> eval_bits; row12: the design's table row (kernel.py `design_args`, no
// segment table). The reference's (rows % 8, 128) tiling is TPU layout.
extern "C" int repro_interp_eval(const int32_t* codes, const int32_t* coeffs,
                                 const int32_t* row12, int32_t* out,
                                 int64_t n, int device, void* stream) {
  return slot_read(codes, coeffs, table_args(row12, nullptr), out, n, true,
                   device, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
