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
// are the shared datapath of datapath.cuh (`exp_neg_slot`, `table_recip`).
//
// Bound on an H100: bytes at the large calls (read x once, write out once;
// ~40 instructions an element of table glue): (16384, 512) float32 moves
// 67 MB, 20 us at 3.35 TB/s. At the router's decode call (4 rows of 64) it
// is latency: the loads, a reduction across the row, a table read an
// element, a second reduction, one table read, a store, in a chain.
// Design (one templated kernel for both entries and every shape):
// - A row is read once, into registers: each thread holds NV chunks of the
//   row (16-byte vectors of 8 bf16 or 4 f32 on the vector body), and keeps
//   its terms e in registers from the row sum to the output, so the exp
//   table is read once an element. Threads per row (a power of two) and
//   chunks per thread come from the wrapper (`softmax/kernel.py`
//   `launch_shape`): one thread a chunk up to 512 threads, rows of at most
//   16 chunks sharing a warp (sub-warp shuffles), four chunks a thread on
//   calls larger than the card holds at once. A row longer than 8 chunks a
//   thread is read in passes (max, then sum, then output), and only there
//   is e recomputed (the same arithmetic, so the same bits).
// - Both table slots (a segmented slot with its leaf rows, or a design's
//   own 2^R rows) are copied to shared memory by cp.async issued before the
//   first loads of x, and one wait + barrier precedes the first table read.
//   Tables that do not fit one block's shared memory are refused. The grid
//   is sized to the card's residency and each block walks its row groups,
//   so the slots are staged once a block; a thread loads its next rows as
//   soon as its terms are computed, and x and out take the streaming cache
//   path.
// - Large calls (256 elements per code of the exp2neg slot, 1 M elements
//   at 12 bits) build a float table of the slot's outputs in each block
//   (2^in_bits floats, tab * 2^-out_bits as exp_neg_slot multiplies them),
//   so an element costs its code and one shared load; these blocks hold
//   512 threads, two an SM, and prefetch the row group after next into L2.
//   The other calls read the slot through the datapath per element.
// - The exp2neg slot's kind (uniform or segmented) is a template
//   parameter; the reciprocal, read once a row, takes the run-time path.
// - The row sum runs in one fixed order: each thread its elements in index
//   order, a butterfly of warp shuffles (every lane ends with the same
//   bits), then every warp of a row sums the row's warp partials from
//   shared memory in the same order, so all warps agree bitwise with no
//   broadcast. The same launch shape gives the same bits, so softmax_tab on
//   the library's own designs equals softmax_lib (`softmax/ref.py`
//   `kernel_row_sum` is this order in plain PyTorch).
// - Any shape: where D is no multiple of the vector or a pointer is not
//   16-byte aligned (a view at an odd offset) the wrapper picks the masked
//   body of the same kernel, one element per chunk with scalar loads.
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

// VEC elements of T read or written as one access (a 16-byte vector of x on
// the vector body; e_out's chunk is 16 or 32 bytes).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Chunk {
  T v[VEC];
};

// x is read once and out written once: 16-byte chunks take the streaming
// (evict-first) cache path.
template <typename C>
__device__ __forceinline__ C load_stream(const C* p) {
  if constexpr (sizeof(C) == 16) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    return *reinterpret_cast<const C*>(&v);
  } else {
    return *p;
  }
}
template <typename C>
__device__ __forceinline__ void store_stream(C* p, const C& v) {
  if constexpr (sizeof(C) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  else
    *p = v;
}

// e = 2^-t, t = min((m - x) * log2e, 126), through the exp2neg slot
// (`exp_neg_slot`) or, with LUT, through the block's float table of the
// slot's outputs tab(c) * 2^-out_bits (the same products, so the same bits).
template <bool SEG, bool LUT>
__device__ __forceinline__ float exp_term(float m, float x,
                                          const int32_t* s_exp,
                                          const TableArgs& te,
                                          const float* s_tab) {
  const float t = fminf(__fmul_rn(__fsub_rn(m, x), kLog2e), 126.0f);
  if constexpr (!LUT) {
    return exp_neg_slot<SEG>(t, s_exp, te);
  } else {
    const float n = floorf(t);
    const int eb = te.in_bits;
    int code = (int)rintf(__fmul_rn(__fsub_rn(t, n), (float)(1 << eb)));
    code = min(max(code, 0), (1 << eb) - 1);
    return __fmul_rn(s_tab[code], pow2_normal(-(int)n));
  }
}

// Xor butterflies over `width` lanes (a power of two, at most 32); every
// lane ends with the same bits.
__device__ __forceinline__ float butterfly_max(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float butterfly_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Blocks of 2^lg threads per row times blockDim.x >> lg rows, walking row
// groups at the grid's stride; NV chunks of VEC elements per thread and
// pass. T is x's dtype, SEG the exp2neg slot's kind, LUT the float table
// of its outputs (built by each block once, after the slots land and
// while the first rows load; blocks of at most 512 threads, so the
// register budget holds the row without spilling), ONE (table kernels
// only) that a pass holds the row.
template <typename T, int VEC, int NV, bool SEG, bool LUT, bool ONE>
__global__ void __launch_bounds__(NV * VEC >= 32 || LUT ? 512 : 1024)
    softmax_kernel(const T* __restrict__ x, T* __restrict__ out,
                   float* __restrict__ e_out, int64_t rows, int d, int lg,
                   const int32_t* __restrict__ rom_e, TableArgs te,
                   const int32_t* __restrict__ rom_r, TableArgs tr) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ float s_max[32], s_sum[32];
  using XC = Chunk<T, VEC>;
  using EC = Chunk<float, VEC>;
  const int tpr = 1 << lg;
  const int t = threadIdx.x & (tpr - 1), r_blk = threadIdx.x >> lg;
  const int rpb = blockDim.x >> lg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  const int wpr = tpr >> 5;  // warps per row; 0 where rows share a warp
  const int n_chunk = d / VEC;  // VEC divides d (the wrapper's choice)
  const int per_pass = tpr * NV;
  const bool one_pass = LUT ? ONE : n_chunk <= per_pass;
  const int64_t stride = (int64_t)gridDim.x * rpb;
  XC xv[NV];
  float ev[NV][VEC];
  // chunks base + k * tpr + t of `row` (nothing past the rows or the row)
  auto load = [&](int64_t row, int base) {
    if (row >= rows) return;
    const XC* xr = reinterpret_cast<const XC*>(x + row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = base + k * tpr + t;
      if (c < n_chunk) xv[k] = load_stream(xr + c);
    }
  };
  int64_t group = (int64_t)blockIdx.x * rpb;
  int32_t* s_exp = smem;
  int32_t* s_rec = s_exp + slot_words(te);
  float* s_tab = reinterpret_cast<float*>(s_rec + slot_words(tr));
  stage_slot_async(rom_e, te, s_exp);
  stage_slot_async(rom_r, tr, s_rec);
  cp_async_commit();
  load(group + r_blk, 0);  // the first rows load while both slots land
  for (bool first = true; group < rows; group += stride, first = false) {
    const int64_t row = group + r_blk;
    const bool live = row < rows;
    auto in_row = [&](int c) { return live && c < n_chunk; };
    if (first) {  // block-uniform: the slots have landed, the table built
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (LUT) {
        const float scale = pow2_normal(-te.out_bits);
        for (int c = threadIdx.x; c < (1 << te.in_bits); c += blockDim.x)
          s_tab[c] = __fmul_rn((float)lut_slot<SEG>(s_exp, te, c), scale);
        __syncthreads();
      }
    }

    // -- row max ----------------------------------------------------------
    float m = -INFINITY;
    for (int base = 0; base < n_chunk; base += per_pass) {
      if (base) load(row, base);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!in_row(base + k * tpr + t)) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) m = fmaxf(m, to_f(xv[k].v[j]));
      }
    }
    m = butterfly_max(m, width);
    if (wpr > 1) {
      if (lane == 0) s_max[warp] = m;
      __syncthreads();
      m = lane < wpr ? s_max[r_blk * wpr + lane] : -INFINITY;
      m = butterfly_max(m, 32);
    }

    // -- e and the row sum, in index order per thread ----------------------
    float acc = 0.0f;
    auto terms = [&](int base, bool sum) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (!in_row(base + k * tpr + t)) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ev[k][j] = exp_term<SEG, LUT>(m, to_f(xv[k].v[j]), s_exp, te,
                                        s_tab);
          if (sum) acc = __fadd_rn(acc, ev[k][j]);
        }
      }
    };
    for (int base = 0; base < n_chunk; base += per_pass) {
      if (!one_pass) load(row, base);
      terms(base, true);
    }
    if (one_pass) load(row + stride, 0);  // x is spent: the next rows load
    if (LUT && one_pass && row + 2 * stride < rows) {
      // the large calls: the rows after those into L2 (no registers)
      const XC* xr2 = reinterpret_cast<const XC*>(x + (row + 2 * stride) * d);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = k * tpr + t;
        if (c < n_chunk)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(xr2 + c));
      }
    }
    acc = butterfly_sum(acc, width);
    if (wpr > 1) {
      if (lane == 0) s_sum[warp] = acc;
      __syncthreads();
      acc = lane < wpr ? s_sum[r_blk * wpr + lane] : 0.0f;
      acc = butterfly_sum(acc, 32);
    }
    const float r = table_recip(acc, s_rec, tr);

    // -- out = e * (1/s) --------------------------------------------------
    const int64_t off = (live ? row : 0) * d;
    XC* orow = reinterpret_cast<XC*>(out + off);
    EC* erow = e_out ? reinterpret_cast<EC*>(e_out + off) : nullptr;
    for (int base = 0; base < n_chunk; base += per_pass) {
      if (!one_pass) {
        load(row, base);
        terms(base, false);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = base + k * tpr + t;
        if (!in_row(c)) continue;
        XC o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<T>(__fmul_rn(ev[k][j], r));
        store_stream(orow + c, o);
        if (erow) {
          EC eo;
#pragma unroll
          for (int j = 0; j < VEC; ++j) eo.v[j] = ev[k][j];
          erow[c] = eo;
        }
      }
    }
    if (!one_pass) load(row + stride, 0);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct Launch {
  const void* x;
  void* out;
  float* e_out;
  int64_t rows;
  int d, lg, rpb, device;
  const int32_t* rom_e;
  TableArgs te;
  const int32_t* rom_r;
  TableArgs tr;
  size_t smem;  // both slots (and, with the table of outputs, 4 << eb)
};

// The float table of exp2neg outputs is built where a call has this many
// elements per code of the slot (and rows of at most 512 threads): each
// block builds it once, and blocks of 512 threads, at most two an SM, walk
// the rows.
constexpr int kLutMaxBits = 13;
constexpr int64_t kLutMinPerCode = 256;

template <typename T, int VEC, int NV, bool SEG, bool LUT, bool ONE>
int launch(const Launch& a, cudaStream_t s) {
  const auto kern = softmax_kernel<T, VEC, NV, SEG, LUT, ONE>;
  const size_t smem = a.smem + (LUT ? (size_t)4 << a.te.in_bits : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // refused: leave no error for the next launch
      return (int)err;
    }
  }
  const int tpr = 1 << a.lg;
  const int rpb = LUT ? max(1, 512 / tpr) : a.rpb;
  const int threads = tpr * rpb;
  int blocks = 0;
  const cudaError_t err = grid_for(
      (const void*)kern, threads, smem, a.device,
      (a.rows + rpb - 1) / rpb * threads, &blocks, LUT ? 2 : 64);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.out), a.e_out, a.rows,
      a.d, a.lg, a.rom_e, a.te, a.rom_r, a.tr);
  return (int)cudaGetLastError();
}

// A row takes more than one pass only with 8 chunks a thread (the
// wrapper's nv is the least that holds the row); the datapath kernels
// test it at run time.
template <typename T, int VEC, bool SEG, bool LUT>
int launch_nv(int nv, bool one, const Launch& a, cudaStream_t s) {
  switch (nv) {
    case 1: return launch<T, VEC, 1, SEG, LUT, true>(a, s);
    case 2: return launch<T, VEC, 2, SEG, LUT, true>(a, s);
    case 4: return launch<T, VEC, 4, SEG, LUT, true>(a, s);
    default:
      if constexpr (LUT)
        if (!one) return launch<T, VEC, 8, SEG, LUT, false>(a, s);
      return launch<T, VEC, 8, SEG, LUT, true>(a, s);
  }
}

template <typename T, int VEC>
int launch_kind(bool lut, int nv, bool one, const Launch& a,
                cudaStream_t s) {
  if (a.te.seg_depth)
    return lut ? launch_nv<T, VEC, true, true>(nv, one, a, s)
               : launch_nv<T, VEC, true, false>(nv, one, a, s);
  return lut ? launch_nv<T, VEC, false, true>(nv, one, a, s)
             : launch_nv<T, VEC, false, false>(nv, one, a, s);
}

template <typename T>
int launch_body(int vector, bool lut, int nv, bool one, const Launch& a,
                cudaStream_t s) {
  return vector ? launch_kind<T, 16 / sizeof(T)>(lut, nv, one, a, s)
                : launch_kind<T, 1>(lut, nv, one, a, s);
}

// Both entry points: check the tables and the launch shape, then launch on
// x's dtype (0 = float32, 1 = bfloat16). shape5: body (1 vector, 0
// masked), threads per row, chunks per thread, rows per block (kernel.py
// `launch_shape`), and the float table of exp2neg outputs (-1 where the
// call has kLutMinPerCode elements per code, 0 never, 1 always). Tables
// whose staged words do not fit one block's shared memory are refused.
int run(const void* x, void* out, float* e_out, int64_t rows, int d,
        int dtype, const int32_t* rom_e, const TableArgs& te,
        const int32_t* rom_r, const TableArgs& tr, const int32_t* shape5,
        int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int vector = shape5[0], tpr = shape5[1], nv = shape5[2],
            rpb = shape5[3], lut_mode = shape5[4];
  const int vec = vector ? (dtype == 0 ? 4 : 8) : 1;
  const int threads = tpr * rpb;
  const bool tpr_ok = tpr > 0 && tpr <= 1024 && (tpr & (tpr - 1)) == 0;
  if (!table_args_ok(te) || !table_args_ok(tr) || dtype < 0 || dtype > 1 ||
      vector < 0 || vector > 1 || !tpr_ok || rpb < 1 || threads % 32 ||
      threads > (nv * vec >= 32 ? 512 : 1024) ||
      (nv != 1 && nv != 2 && nv != 4 && nv != 8) || rows < 0 || d < 1 ||
      lut_mode < -1 || lut_mode > 1 ||
      (lut_mode == 1 && (te.in_bits > kLutMaxBits || tpr > 512)) ||
      (nv != 8 && d / vec > tpr * nv) ||
      (vector && (d % vec || !aligned16(x) || !aligned16(out) ||
                  !aligned16(e_out))))
    return (int)cudaErrorInvalidValue;
  const bool lut = lut_mode == -1
                       ? te.in_bits <= kLutMaxBits && tpr <= 512 &&
                             rows * d >= kLutMinPerCode << te.in_bits
                       : lut_mode == 1;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(slot_words(te) + slot_words(tr)) * 4;
  if ((int64_t)smem + (lut ? 4 << te.in_bits : 0) + 64 * 4 > limit)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Launch a{x, out, e_out, rows, d, __builtin_ctz(tpr), rpb, device,
                 rom_e, te, rom_r, tr, smem};
  const bool one = d / vec <= tpr * nv;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_body<float>(vector, lut, nv, one, a, s)
                    : launch_body<__nv_bfloat16>(vector, lut, nv, one, a, s);
}

}  // namespace

// x, out: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16; e_out:
// (rows, d) float32 or null. exp12 / recip12: the two slots' rows and dp the
// library's leaf rows, see datapath.cuh `table_args`; shape5: see `run`.
extern "C" int repro_softmax_lib(const void* x, void* out, float* e_out,
                                 int64_t rows, int d, int dtype,
                                 const int32_t* rom, const int32_t* dp,
                                 const int32_t* exp12,
                                 const int32_t* recip12,
                                 const int32_t* shape5, int device,
                                 void* stream) {
  return run(x, out, e_out, rows, d, dtype, rom, table_args(exp12, dp), rom,
             table_args(recip12, dp), shape5, device, stream);
}

// The per-table entry: exp_coeffs and recip_coeffs are two designs' own
// (2^R, 3) int32 rows, exp12 / recip12 their rows (row0 0, rows 2^R, no
// segment table), see datapath.cuh `table_args`.
extern "C" int repro_softmax_tab(const void* x, void* out, float* e_out,
                                 int64_t rows, int d, int dtype,
                                 const int32_t* exp_coeffs,
                                 const int32_t* exp12,
                                 const int32_t* recip_coeffs,
                                 const int32_t* recip12,
                                 const int32_t* shape5, int device,
                                 void* stream) {
  return run(x, out, e_out, rows, d, dtype, exp_coeffs,
             table_args(exp12, nullptr), recip_coeffs,
             table_args(recip12, nullptr), shape5, device, stream);
}
