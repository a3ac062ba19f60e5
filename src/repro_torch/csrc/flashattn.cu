// flash_attn_lib and flash_attn_tab: online-softmax attention with the
// table-backed exp and reciprocal.
//
// Replaces repro/kernels/flashattn/kernel.py `flash_attention_lib` /
// `_flash_lib_kernel` (absolute-position masks, grouped KV heads, both
// tables in one library ROM) and `flash_attention` / `_flash_kernel`
// (positions by index, one KV head per query head, each table from its own
// design's (2^R, 3) rows), both over `_flash_loop`, `_table_exp_neg`,
// `_table_recip`. One body serves both: null position pointers mean
// positions = index (so causal is top-left aligned when Sq != Sk, and the
// per-block tile liveness skips exactly the key tiles strictly above the
// block's diagonal, the reference's B1), and each table is a (rom,
// TableArgs) pair (the library entry passes its ROM twice). It reproduces
// `_flash_loop`: q in f32 times scale; scores masked to
// NEG = -1e30 where kv_pos < 0, where causal and q_pos < kv_pos, or outside
// the sliding window; m = max(m, max(s), M_FLOOR = -1e20); p and the running
// correction from the exp2neg table (t clamped at 126); l = l * corr +
// sum(p); p cast to V's dtype before P.V; a K tile skipped when it is dead
// for every query row of the block (empty, causal future, outside the
// window); the epilogue 1 / max(l, 1e-30) from the reciprocal table.
//
// Bound on an H100: by bytes, decode (one query per slot against the
// cache) needs the K/V of the live cache rows, causal prefill at Sq = 512
// its q/k/v/out (the live causal half of Yi-6B's is 2.15 GFLOP, 2.2 us at
// the bf16 tensor-core rate). Measured, the body is bound by instruction
// issue: each score takes ~40 instructions of table glue (code, Horner
// step, powers of two) with dependent shared loads, on one or two warps
// per scheduler.
//
// Design (bf16, head dims <= 128: the serving path): one block of 4 warps
// per (batch, KV head, query tile, key split) serves all g = H / KVH query
// heads of the group (M = g * tq <= 64 rows), so each K/V tile is read once
// per group (GQA index b*H + h -> KV stripe b*KVH + h / g).
// - Both products on the tensor cores (mma.sync m16n8k16 bf16 -> f32, from
//   ldmatrix of padded shared rows, no bank conflicts). The reference scales
//   q in f32 before the product; here f32 q*scale is split into bf16 hi + lo
//   planes (the residual of hi is exact in f32, so hi + lo keeps 16 of its
//   bits) and Q.K^T is two products into one f32 accumulator; K is exact in
//   bf16. Scores stay in registers in the FlashAttention-2 fragment layout:
//   a thread holds two rows, the row max and sum come from quad shuffles,
//   the exp2neg glue runs on the fragments (branch-free table reads, so a
//   thread's reads interleave; none for rows past M), and p, rounded to
//   bf16, feeds the P.V product from registers.
// - Warps: groups of 16 query rows; where the rows fit fewer warps than 4
//   (decode: M = g or 1), the warps of a group split each key tile and
//   share its row max and sum through shared memory, and their parts of
//   acc are summed in a fixed order at the end.
// - K/V (and the tile's kv positions) arrive by cp.async into a two-stage
//   ring of 64-key tiles: tile k+1 loads while tile k is computed. The live
//   tiles of the block's key range are listed once, up front, so the ring
//   only ever holds live tiles; tables and q arrive by cp.async meanwhile.
// - Key splits (flash-decoding): with few blocks (decode: one query tile
//   per (batch, KV head)), `kv_splits` cuts the key tiles into ranges; each
//   split block writes its (m, l, acc) to an f32 workspace and
//   `flash_attn_combine` rescales them with the exp2neg table (c_s =
//   exp2neg((m - m_s) * LOG2E), l = sum l_s c_s, acc = sum acc_s c_s, in
//   split order) and applies the reciprocal table. A split whose tiles are
//   all dead keeps m = M_FLOOR, l = 0, acc = 0 and adds exactly 0.
// - Late query tiles launch first: under a causal mask they hold the most
//   live key tiles.
// float32 inputs, and bf16 with head dims above 128, take the CUDA-core
// body (`flash_attn_kernel<T>`: the products as f32 FMAs from shared
// memory, synchronous tile loads) with the same splits and workspace.
// Tensors are read and written in place through their strides, so the
// caller's (B, S, H, D) layout and the cache's (B, KVH, S, D) layout need no
// copies.
#include <climits>

#include <cuda_bf16.h>

#include "datapath.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;  // CUDA-core body
constexpr int kBK = 64;        // keys per tile
constexpr int kMaxAcc = 32;    // accumulators per thread: rows * Dv <= 8192
constexpr int kRows = 64;      // query rows per block
constexpr int kTcThreads = 128;  // tensor-core body: 4 warps x 16 rows
constexpr int kTcMaxD = 128;     // head dims the tensor-core body takes
constexpr int kQPlanes = 2;      // bf16 planes of f32 q * scale (hi, lo)
constexpr float kNeg = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int epw = 1;  // elements per 32-bit word
  __device__ static float get(const float* a, int64_t i) { return a[i]; }
  __device__ static void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w);
  }
  __device__ static float round(float p) { return p; }
  __device__ static float put(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int epw = 2;
  __device__ static float get(const __nv_bfloat16* a, int64_t i) {
    return __bfloat162float(a[i]);
  }
  __device__ static void unpack(uint32_t w, float* o) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    float2 f = __bfloat1622float2(h);
    o[0] = f.x;
    o[1] = f.y;
  }
  __device__ static float round(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  __device__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int32_t* q_pos;   // (B, Sq), -1 = padded query row; null: index
  const int32_t* kv_pos;  // (B, Sk), -1 = dead cache slot; null: index
  const int32_t* rom_e;   // the exp2neg table's rows (library ROM or design)
  const int32_t* rom_r;   // the recip table's rows
  float* ws_ml;           // (splits, B, H, Sq, 2) f32 m, l; splits > 1 only
  float* ws_acc;          // (splits, B, H, Sq, Dv) f32 acc; splits > 1 only
  // element strides of (batch, head, position); the last dim is contiguous
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int B, H, KVH, Sq, Sk, D, Dv, g, tq;
  int n_qt, splits, per;  // query tiles; key splits; key tiles per split
  int causal, window;     // window < 0: no sliding window
  int vec16;              // q/K/V rows 16-byte aligned (tensor-core body)
  float scale;
  TableArgs te, tr;
};

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// This block's query tile (late tiles first) and key split; its key tiles
// are [t0, t1).
struct BlockTiles {
  int qt, sp, t0, t1;
};
__device__ __forceinline__ BlockTiles block_tiles(const FlashParams& p) {
  BlockTiles t;
  t.qt = p.n_qt - 1 - (int)blockIdx.x / p.splits;
  t.sp = (int)blockIdx.x % p.splits;
  const int n_kt = (p.Sk + kBK - 1) / kBK;
  t.t0 = t.sp * p.per;
  t.t1 = min(t.t0 + p.per, n_kt);
  return t;
}

// The reference's chunk_live for key tile kt, evaluated by one whole warp
// from the block's query-position range (qmax over all rows, qmin over the
// live ones).
__device__ __forceinline__ bool tile_live(const FlashParams& p, int b, int kt,
                                          int qmax, int qmin) {
  const int lane = threadIdx.x & 31;
  const int k0 = kt * kBK, jn = min(kBK, p.Sk - k0);
  int any = 0, kmin = INT_MAX, kmax = INT_MIN;
  for (int j = lane; j < jn; j += 32) {
    const int kp = p.kv_pos ? p.kv_pos[(int64_t)b * p.Sk + k0 + j] : k0 + j;
    any |= kp >= 0;
    if (kp >= 0) kmin = min(kmin, kp);
    kmax = max(kmax, kp);
  }
  any = __any_sync(~0u, any);
  kmin = warp_min_i(kmin);
  kmax = warp_max_i(kmax);
  bool need = any != 0;
  if (p.causal) need = need && kmin <= qmax;
  if (p.window >= 0) need = need && (int64_t)kmax > (int64_t)qmin - p.window;
  return need;
}

// Workspace row of (split, batch, query head, query position).
__device__ __forceinline__ int64_t ws_row(const FlashParams& p, int sp, int b,
                                          int h, int qi) {
  return (((int64_t)sp * p.B + b) * p.H + h) * p.Sq + qi;
}

// ---------------------------------------------------------------------------
// CUDA-core body: float32, and bf16 with head dims above 128.

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const FlashParams p) {
  using E = Elem<T>;
  constexpr int EPW = E::epw;
  extern __shared__ uint32_t smem[];
  const int M = p.g * p.tq;  // query rows of this block
  const BlockTiles bt = block_tiles(p);
  const int qt = bt.qt, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wq = p.D / EPW;                 // 32-bit words per q/k row
  const int ks = wq + ((wq & 1) ? 0 : 1);   // odd K row stride: no conflicts
  const int wv = p.Dv / EPW;
  const int ss = kBK + 1;
  float* s_q = reinterpret_cast<float*>(smem);       // M x D (scaled, f32)
  uint32_t* s_k = smem + M * p.D;                     // kBK x ks words
  uint32_t* s_v = s_k + kBK * ks;                     // kBK x wv words
  float* s_s = reinterpret_cast<float*>(s_v + kBK * wv);  // M x ss
  float* s_m = s_s + M * ss;
  float* s_l = s_m + M;
  float* s_corr = s_l + M;
  int* s_qp = reinterpret_cast<int*>(s_corr + M);
  int* s_kp = s_qp + M;
  int32_t* s_exp = s_kp + kBK;
  int32_t* s_rec = s_exp + slot_words(p.te);
  int* s_flag = s_rec + slot_words(p.tr);

  // stage the exp2neg and recip slots; address them from shared memory
  TableArgs te = p.te, tr = p.tr;
  stage_slot(p.rom_e, te, s_exp);
  stage_slot(p.rom_r, tr, s_rec);

  // row r serves query head kvh * g + r / tq at position qt * tq + r % tq
  const T* qbase = static_cast<const T*>(p.q) + (int64_t)b * p.q_sb;
  for (int e = tid; e < M * p.D; e += kThreads) {
    const int r = e / p.D, d = e % p.D;
    const int qi = qt * p.tq + r % p.tq;
    float val = 0.0f;
    if (qi < p.Sq) {
      const int h = kvh * p.g + r / p.tq;
      val = __fmul_rn(E::get(qbase, h * p.q_sh + (int64_t)qi * p.q_ss + d),
                      p.scale);
    }
    s_q[e] = val;
  }
  for (int r = tid; r < M; r += kThreads) {
    const int qi = qt * p.tq + r % p.tq;
    s_qp[r] = qi >= p.Sq ? -1
              : p.q_pos ? p.q_pos[(int64_t)b * p.Sq + qi] : qi;
    s_m[r] = kMFloor;
    s_l[r] = 0.0f;
  }
  __syncthreads();
  if (warp == 0) {  // the block's query-position range, for tile liveness
    int qmax = INT_MIN, qmin = INT_MAX;
    for (int r = lane; r < M; r += 32) {
      const int qp = s_qp[r];
      qmax = max(qmax, qp);
      if (qp >= 0) qmin = min(qmin, qp);
    }
    qmax = warp_max_i(qmax);
    qmin = warp_min_i(qmin);
    if (lane == 0) {
      s_flag[0] = qmax;
      s_flag[1] = qmin;
    }
  }

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.0f;
  const int n_acc = (M * p.Dv + kThreads - 1) / kThreads;
  const T* kbase = static_cast<const T*>(p.k) + (int64_t)b * p.k_sb +
                   (int64_t)kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + (int64_t)b * p.v_sb +
                   (int64_t)kvh * p.v_sh;

  for (int kt = bt.t0; kt < bt.t1; ++kt) {
    const int k0 = kt * kBK;
    const int jn = min(kBK, p.Sk - k0);  // keys of this tile
    for (int j = tid; j < kBK; j += kThreads)
      s_kp[j] = j >= jn ? -1
                : p.kv_pos ? p.kv_pos[(int64_t)b * p.Sk + k0 + j] : k0 + j;
    __syncthreads();
    if (warp == 0) {
      const bool need = tile_live(p, b, kt, s_flag[0], s_flag[1]);
      if (lane == 0) s_flag[2] = need;
    }
    __syncthreads();
    if (!s_flag[2]) continue;

    for (int w = tid; w < kBK * wq; w += kThreads) {
      const int j = w / wq, c = w % wq;
      uint32_t val = 0u;
      if (j < jn)
        val = reinterpret_cast<const uint32_t*>(
            kbase + (int64_t)(k0 + j) * p.k_ss)[c];
      s_k[j * ks + c] = val;
    }
    for (int w = tid; w < kBK * wv; w += kThreads) {
      const int j = w / wv, c = w % wv;
      uint32_t val = 0u;
      if (j < jn)
        val = reinterpret_cast<const uint32_t*>(
            vbase + (int64_t)(k0 + j) * p.v_ss)[c];
      s_v[j * wv + c] = val;
    }
    __syncthreads();

    // masked scores
    for (int e = tid; e < M * kBK; e += kThreads) {
      const int r = e / kBK, j = e % kBK;
      float sc = kNeg;
      if (j < jn) {
        const int kp = s_kp[j], qp = s_qp[r];
        bool ok = kp >= 0;
        if (p.causal) ok = ok && qp >= kp;
        if (p.window >= 0) ok = ok && (int64_t)qp - kp < p.window;
        if (ok) {
          const float* qr = s_q + r * p.D;
          const uint32_t* kr = s_k + j * ks;
          float dot = 0.0f;
          for (int c = 0; c < wq; ++c) {
            float kf[EPW];
            E::unpack(kr[c], kf);
#pragma unroll
            for (int u = 0; u < EPW; ++u) dot = fmaf(qr[c * EPW + u], kf[u], dot);
          }
          sc = dot;
        }
      }
      s_s[r * ss + j] = sc;
    }
    __syncthreads();

    // running max, table exponentials, row sums, correction
    for (int r = warp; r < M; r += kThreads / 32) {
      float* srow = s_s + r * ss;
      float mx = kNeg;
      for (int j = lane; j < jn; j += 32) mx = fmaxf(mx, srow[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
      const float m_old = s_m[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), kMFloor);
      float psum = 0.0f;
      for (int j = lane; j < kBK; j += 32) {
        float pj = 0.0f;
        if (j < jn) {
          pj = table_exp_neg(__fmul_rn(__fsub_rn(m_new, srow[j]), kLog2e),
                             s_exp, te);
          psum = __fadd_rn(psum, pj);
        }
        srow[j] = E::round(pj);  // P.V takes p in V's dtype
      }
      for (int o = 16; o > 0; o >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(~0u, psum, o));
      if (lane == 0) {
        const float corr = table_exp_neg(
            __fmul_rn(__fsub_rn(m_new, m_old), kLog2e), s_exp, te);
        s_l[r] = __fadd_rn(__fmul_rn(s_l[r], corr), psum);
        s_m[r] = m_new;
        s_corr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V
    const T* sv = reinterpret_cast<const T*>(s_v);
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (i < n_acc && e < M * p.Dv) {
        const int r = e / p.Dv, d = e % p.Dv;
        const float* prow = s_s + r * ss;
        float pv = 0.0f;
        for (int j = 0; j < jn; ++j)
          pv = fmaf(prow[j], E::get(sv, (int64_t)j * p.Dv + d), pv);
        acc[i] = __fadd_rn(__fmul_rn(acc[i], s_corr[r]), pv);
      }
    }
    __syncthreads();
  }

  // epilogue: out = acc * recip(max(l, 1e-30)), or this split's (m, l, acc)
  const bool split = p.splits > 1;
  for (int r = tid; r < M; r += kThreads) {
    const int qi = qt * p.tq + r % p.tq;
    if (split) {
      if (qi < p.Sq) {
        const int64_t w = ws_row(p, bt.sp, b, kvh * p.g + r / p.tq, qi);
        p.ws_ml[2 * w] = s_m[r];
        p.ws_ml[2 * w + 1] = s_l[r];
      }
    } else {
      s_corr[r] = table_recip(fmaxf(s_l[r], 1e-30f), s_rec, tr);
    }
  }
  __syncthreads();
  T* obase = static_cast<T*>(p.out) + (int64_t)b * p.o_sb;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (i < n_acc && e < M * p.Dv) {
      const int r = e / p.Dv, d = e % p.Dv;
      const int qi = qt * p.tq + r % p.tq;
      if (qi < p.Sq) {
        const int h = kvh * p.g + r / p.tq;
        if (split)
          p.ws_acc[ws_row(p, bt.sp, b, h, qi) * p.Dv + d] = acc[i];
        else
          obase[h * p.o_sh + (int64_t)qi * p.o_ss + d] =
              E::put(__fmul_rn(acc[i], s_corr[r]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16, D and Dv <= 128).

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared-memory rows: head dims padded to 16, plus 8 elements so that the
// 8 rows one ldmatrix reads start 16 bytes apart modulo 128 (no conflicts).
__host__ __device__ __forceinline__ int tc_stride(int d) {
  return ((d + 15) & ~15) + 8;
}

// Calls body(row, chunk) once for every row < rows and chunk < cpr across
// the block. Where cpr divides the block, a thread keeps one chunk column
// and steps by whole rows: no division per chunk.
template <typename F>
__device__ __forceinline__ void for_chunks(int rows, int cpr, F&& body) {
  const int tid = threadIdx.x;
  if (kTcThreads % cpr == 0) {
    const int c = tid % cpr, step = kTcThreads / cpr;
    for (int r = tid / cpr; r < rows; r += step) body(r, c);
  } else {
    for (int i = tid; i < rows * cpr; i += kTcThreads) body(i / cpr, i % cpr);
  }
}

// The exp2neg glue of `_flash_loop` on one warp's score fragment
// (FlashAttention-2 layout: this thread holds rows r0 and r0 + 8 at the
// columns 2 * (lane % 4) + {0, 1} of each 8-key tile; the warp's nn tiles
// start at key `key0` of the tile), for a slot whose kind is known at
// compile time: p = exp2neg((m_new - s) LOG2E) in place of s, 0 past the
// tile's jn keys and on rows past the block's (valid0 / valid1 false);
// returns the thread's partial row sums. Straight-line code per row, so the
// table reads of a thread interleave.
template <bool SEG>
__device__ __forceinline__ void exp_tile(float (&s)[kBK / 8][4], int nn,
                                         int key0, int jn, float mn0,
                                         float mn1, bool valid0, bool valid1,
                                         const int32_t* rom,
                                         const TableArgs& te, float* ps) {
  const int lane = threadIdx.x & 31;
  ps[0] = ps[1] = 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float mn = half ? mn1 : mn0;
    if (half ? valid1 : valid0) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        if (n < nn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = key0 + n * 8 + (lane & 3) * 2 + e < jn;
            const float pv = exp_neg_slot<SEG>(
                __fmul_rn(__fsub_rn(mn, s[n][2 * half + e]), kLog2e), rom, te);
            s[n][2 * half + e] = in ? pv : 0.0f;
            ps[half] = __fadd_rn(ps[half], s[n][2 * half + e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        s[n][2 * half] = s[n][2 * half + 1] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
flash_attn_kernel_tc(const FlashParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int M = p.g * p.tq;
  const BlockTiles bt = block_tiles(p);
  const int qt = bt.qt, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dp = (p.D + 15) & ~15, dvp = (p.Dv + 15) & ~15;
  const int qs = tc_stride(p.D), vs = tc_stride(p.Dv);
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);  // kQPlanes x kRows x qs
  bf16* s_k = s_q + kQPlanes * kRows * qs;       // 2 stages x kBK x qs
  bf16* s_v = s_k + 2 * kBK * qs;                // 2 stages x kBK x vs
  int* s_kp = reinterpret_cast<int*>(s_v + 2 * kBK * vs);  // 2 x kBK
  int* s_qp = s_kp + 2 * kBK;                               // kRows
  float* s_red = reinterpret_cast<float*>(s_qp + kRows);    // 2 x 4 x 16
  int* s_list = reinterpret_cast<int*>(s_red + 2 * 4 * 16);  // live tiles
  int* s_n = s_list + p.per;
  int32_t* s_exp = s_n + 4;
  int32_t* s_rec = s_exp + slot_words(p.te);
  bf16* s_qraw = s_k + kBK * qs;  // q as read, in K's second stage (free now)
  const int ew = p.vec16 ? 8 : 2;  // K/V/q elements per copy

  // -- prologue: tables and q by cp.async; query positions; tile liveness
  TableArgs te = p.te, tr = p.tr;
  stage_slot_async(p.rom_e, te, s_exp);
  stage_slot_async(p.rom_r, tr, s_rec);
  // row r serves query head kvh * g + r / tq at position qt * tq + r % tq
  // (only the rows of the row groups in use: 16 at decode)
  const int rg = (M + 15) >> 4, rows_used = rg * 16;
  const bf16* qbase = static_cast<const bf16*>(p.q) + (int64_t)b * p.q_sb;
  for_chunks(rows_used, p.D / ew, [&](int r, int c) {
    const int w = c * ew, qi = qt * p.tq + r % p.tq;
    const bool in = r < M && qi < p.Sq;
    const bf16* src = in ? qbase + (kvh * p.g + r / p.tq) * p.q_sh +
                               (int64_t)qi * p.q_ss + w
                         : qbase;
    const uint32_t dst = smem_addr(s_qraw + r * qs + w);
    if (p.vec16) cp_async16(dst, src, in ? 16 : 0);
    else cp_async4(dst, src, in ? 4 : 0);
  });
  cp_async_commit();
  for (int r = tid; r < kRows; r += kTcThreads) {
    int qp = -1;
    const int qi = qt * p.tq + r % p.tq;
    if (r < M && qi < p.Sq) qp = p.q_pos ? p.q_pos[(int64_t)b * p.Sq + qi] : qi;
    s_qp[r] = qp;
  }
  // the pad columns of the K/V stages (cp.async never writes them)
  for (int e = tid; e < 2 * kBK * (dp - p.D); e += kTcThreads)
    s_k[(e / (dp - p.D)) * qs + p.D + e % (dp - p.D)] = __float2bfloat16_rn(0.f);
  for (int e = tid; e < 2 * kBK * (dvp - p.Dv); e += kTcThreads)
    s_v[(e / (dvp - p.Dv)) * vs + p.Dv + e % (dvp - p.Dv)] =
        __float2bfloat16_rn(0.f);
  __syncthreads();
  {  // the live key tiles of this split (the reference's chunk_live over
     // the block's query-position range), while the copies land
    int qmax = INT_MIN, qmin = INT_MAX;
    for (int r = lane; r < kRows; r += 32) {
      const int qp = s_qp[r];
      qmax = max(qmax, qp);
      if (qp >= 0) qmin = min(qmin, qp);
    }
    qmax = warp_max_i(qmax);
    qmin = warp_min_i(qmin);
    for (int i = warp; i < bt.t1 - bt.t0; i += kTcThreads / 32) {
      const bool need = tile_live(p, b, bt.t0 + i, qmax, qmin);
      if (lane == 0) s_list[i] = need;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // q * scale in f32 (the reference's order), as bf16 hi + lo planes (the
  // residual of each plane is exact in f32)
  for_chunks(rows_used, dp / 8, [&](int r, int c) {  // 8 columns a chunk
    const int d0 = c * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(s_qraw + r * qs + d0);
    const bf16* qv = reinterpret_cast<const bf16*>(&raw);
    uint32_t part[kQPlanes][4];
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      float x0 = d0 + u < p.D ? __fmul_rn(__bfloat162float(qv[u]), p.scale)
                              : 0.0f;
      float x1 = d0 + u + 1 < p.D
                     ? __fmul_rn(__bfloat162float(qv[u + 1]), p.scale)
                     : 0.0f;
#pragma unroll
      for (int pl = 0; pl < kQPlanes; ++pl) {
        const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
        part[pl][u / 2] = pack_bf16(h0, h1);
        x0 = __fsub_rn(x0, h0);
        x1 = __fsub_rn(x1, h1);
      }
    }
#pragma unroll
    for (int pl = 0; pl < kQPlanes; ++pl)
      *reinterpret_cast<uint4*>(s_q + (pl * kRows + r) * qs + d0) =
          make_uint4(part[pl][0], part[pl][1], part[pl][2], part[pl][3]);
  });
  if (warp == 0) {  // compact the liveness flags into tile indices, in order
    int cnt = 0;
    for (int base = 0; base < bt.t1 - bt.t0; base += 32) {
      const int i = base + lane;
      const bool live = i < bt.t1 - bt.t0 && s_list[i];
      const unsigned bal = __ballot_sync(~0u, live);
      if (live) s_list[cnt + __popc(bal & ((1u << lane) - 1u))] = bt.t0 + i;
      cnt += __popc(bal);
    }
    if (lane == 0) s_n[0] = cnt;
  }
  __syncthreads();  // q planes, the list, and s_qraw free for K/V again
  const int n_live = s_n[0];

  const bf16* kbase = static_cast<const bf16*>(p.k) + (int64_t)b * p.k_sb +
                      (int64_t)kvh * p.k_sh;
  const bf16* vbase = static_cast<const bf16*>(p.v) + (int64_t)b * p.v_sb +
                      (int64_t)kvh * p.v_sh;
  // one tile's K, V and kv positions into ring stage st; rows past Sk zero
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * kBK, jn = min(kBK, p.Sk - k0);
    const bf16* kt_base = kbase + (int64_t)k0 * p.k_ss;
    const bf16* vt_base = vbase + (int64_t)k0 * p.v_ss;
    bf16* sk = s_k + st * kBK * qs;
    bf16* sv = s_v + st * kBK * vs;
    for_chunks(kBK, p.D / ew, [&](int j, int c) {
      const bf16* src = kt_base + (int64_t)(j < jn ? j : 0) * p.k_ss + c * ew;
      const uint32_t dst = smem_addr(sk + j * qs + c * ew);
      if (p.vec16) cp_async16(dst, src, j < jn ? 16 : 0);
      else cp_async4(dst, src, j < jn ? 4 : 0);
    });
    for_chunks(kBK, p.Dv / ew, [&](int j, int c) {
      const bf16* src = vt_base + (int64_t)(j < jn ? j : 0) * p.v_ss + c * ew;
      const uint32_t dst = smem_addr(sv + j * vs + c * ew);
      if (p.vec16) cp_async16(dst, src, j < jn ? 16 : 0);
      else cp_async4(dst, src, j < jn ? 4 : 0);
    });
    if (p.kv_pos && tid < kBK)
      cp_async4(smem_addr(s_kp + st * kBK + tid),
                p.kv_pos + (int64_t)b * p.Sk + k0 + (tid < jn ? tid : 0),
                tid < jn ? 4 : 0);
    cp_async_commit();
  };

  // Warps: rg groups of 16 query rows, each served by kg warps that split
  // a key tile between them (kg = 4 at decode, where the rows fit one
  // group; 1 from 33 rows on). Warp (wr, wk) holds rows 16 wr.. of its
  // group (a thread: rows r0 and r0 + 8) and keys key0.. of each tile
  // (nn 8-key tiles); the row max and sum of a tile are shared through
  // shared memory, and each warp keeps its keys' part of acc until the end.
  const int kg = rg == 1 ? 4 : rg == 2 ? 2 : 1;
  const int wr = warp / kg, wk = warp % kg;
  const int nn = (kBK / 8) / kg, key0 = wk * nn * 8;
  const bool active = wr < rg;
  const int r0 = wr * 16 + (lane >> 2);
  const bool valid0 = r0 < M, valid1 = r0 + 8 < M;
  const int qp0 = s_qp[r0], qp1 = s_qp[r0 + 8];
  const bool has_pos = p.kv_pos != nullptr, causal = p.causal != 0;
  const bool windowed = p.window >= 0;
  const int nd = dp / 16, nv = dvp / 8;
  float acc[kTcMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kTcMaxD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_r[2] = {kMFloor, kMFloor}, l_r[2] = {0.0f, 0.0f};

  if (n_live > 0) load_tile(s_list[0], 0);
  for (int it = 0; it < n_live; ++it) {
    const int st = it & 1;
    if (it + 1 < n_live) {
      load_tile(s_list[it + 1], st ^ 1);  // overlaps this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {  // kg > 1 only where every warp is active
      const int k0 = s_list[it] * kBK, jn = min(kBK, p.Sk - k0);
      const bf16* sk = s_k + st * kBK * qs;
      const bf16* sv = s_v + st * kBK * vs;

      // S = (q hi + q lo) K^T: 16 rows x this warp's keys, in registers
      float s[kBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTcMaxD / 16; ++kk) {
        if (kk < nd) {
          uint32_t a[kQPlanes][4];
#pragma unroll
          for (int pl = 0; pl < kQPlanes; ++pl)
            ldsm_x4(smem_addr(s_q + (pl * kRows + wr * 16 + (lane & 15)) * qs +
                              kk * 16 + (lane >> 4) * 8),
                    a[pl]);
#pragma unroll
          for (int n2 = 0; n2 < kBK / 16; ++n2) {
            if (2 * n2 < nn) {
              uint32_t kb[4];
              ldsm_x4(smem_addr(sk + (key0 + n2 * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * qs +
                                kk * 16 + ((lane >> 3) & 1) * 8),
                      kb);
#pragma unroll
              for (int pl = 0; pl < kQPlanes; ++pl) {
                mma_bf16(s[2 * n2], a[pl], kb[0], kb[1]);
                mma_bf16(s[2 * n2 + 1], a[pl], kb[2], kb[3]);
              }
            }
          }
        }
      }

      // the masks of `_flash_loop` (dead slot, causal future, window) and
      // the row max over the tile's keys
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        if (n < nn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = key0 + n * 8 + (lane & 3) * 2 + e;
            const int kp = has_pos ? s_kp[st * kBK + j] : k0 + j;
            const bool ok0 = kp >= 0 && (!causal || qp0 >= kp) &&
                             (!windowed || (int64_t)qp0 - kp < p.window);
            const bool ok1 = kp >= 0 && (!causal || qp1 >= kp) &&
                             (!windowed || (int64_t)qp1 - kp < p.window);
            s[n][e] = ok0 ? s[n][e] : kNeg;
            s[n][2 + e] = ok1 ? s[n][2 + e] : kNeg;
            mx0 = fmaxf(mx0, j < jn ? s[n][e] : kNeg);
            mx1 = fmaxf(mx1, j < jn ? s[n][2 + e] : kNeg);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, o));
      }
      const int rl = lane >> 2;  // the thread's row within its group
      if (kg > 1) {
        if ((lane & 3) == 0) {
          s_red[warp * 16 + rl] = mx0;
          s_red[warp * 16 + rl + 8] = mx1;
        }
        __syncthreads();
        for (int i = 0; i < kg; ++i) {
          mx0 = fmaxf(mx0, s_red[(wr * kg + i) * 16 + rl]);
          mx1 = fmaxf(mx1, s_red[(wr * kg + i) * 16 + rl + 8]);
        }
      }
      const float mn0 = fmaxf(fmaxf(m_r[0], mx0), kMFloor);
      const float mn1 = fmaxf(fmaxf(m_r[1], mx1), kMFloor);
      float ps[2];
      if (te.seg_depth)
        exp_tile<true>(s, nn, key0, jn, mn0, mn1, valid0, valid1, s_exp, te,
                       ps);
      else
        exp_tile<false>(s, nn, key0, jn, mn0, mn1, valid0, valid1, s_exp, te,
                        ps);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ps[0] = __fadd_rn(ps[0], __shfl_xor_sync(~0u, ps[0], o));
        ps[1] = __fadd_rn(ps[1], __shfl_xor_sync(~0u, ps[1], o));
      }
      if (kg > 1) {  // the row sums over the key groups, in group order
        float* s_sum = s_red + 4 * 16;
        if ((lane & 3) == 0) {
          s_sum[warp * 16 + rl] = ps[0];
          s_sum[warp * 16 + rl + 8] = ps[1];
        }
        __syncthreads();
        ps[0] = s_sum[wr * kg * 16 + rl];
        ps[1] = s_sum[wr * kg * 16 + rl + 8];
        for (int i = 1; i < kg; ++i) {
          ps[0] = __fadd_rn(ps[0], s_sum[(wr * kg + i) * 16 + rl]);
          ps[1] = __fadd_rn(ps[1], s_sum[(wr * kg + i) * 16 + rl + 8]);
        }
      }
      float corr[2];
      corr[0] = table_exp_neg(__fmul_rn(__fsub_rn(mn0, m_r[0]), kLog2e),
                              s_exp, te);
      corr[1] = table_exp_neg(__fmul_rn(__fsub_rn(mn1, m_r[1]), kLog2e),
                              s_exp, te);
      l_r[0] = __fadd_rn(__fmul_rn(l_r[0], corr[0]), ps[0]);
      l_r[1] = __fadd_rn(__fmul_rn(l_r[1], corr[1]), ps[1]);
      m_r[0] = mn0;
      m_r[1] = mn1;
#pragma unroll
      for (int j = 0; j < kTcMaxD / 8; ++j) {
        if (j < nv) {
          acc[j][0] = __fmul_rn(acc[j][0], corr[0]);
          acc[j][1] = __fmul_rn(acc[j][1], corr[0]);
          acc[j][2] = __fmul_rn(acc[j][2], corr[1]);
          acc[j][3] = __fmul_rn(acc[j][3], corr[1]);
        }
      }

      // acc += P V over this warp's keys: p rounded to bf16 (V's dtype)
      // straight from registers
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        if (2 * kc < nn) {
          uint32_t a[4];
          a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
          a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
          a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
          for (int j2 = 0; j2 < kTcMaxD / 16; ++j2) {
            if (2 * j2 < nv) {
              uint32_t vb[4];
              ldsm_x4_t(smem_addr(sv + (key0 + kc * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * vs +
                                  j2 * 16 + (lane >> 4) * 8),
                        vb);
              mma_bf16(acc[2 * j2], a, vb[0], vb[1]);
              mma_bf16(acc[2 * j2 + 1], a, vb[2], vb[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled next iteration
  }

  // the key groups' parts of acc, summed in group order by group 0
  if (kg > 1) {
    float* s_acc = reinterpret_cast<float*>(s_k);  // 4 x 16 x dvp, K/V free
#pragma unroll
    for (int j = 0; j < kTcMaxD / 8; ++j) {
      if (j < nv) {
        const int col = j * 8 + (lane & 3) * 2;
        float* row = s_acc + (warp * 16 + (lane >> 2)) * dvp + col;
        *reinterpret_cast<float2*>(row) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(row + 8 * dvp) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int j = 0; j < kTcMaxD / 8; ++j) {
      if (j < nv) {
        const int col = j * 8 + (lane & 3) * 2;
        const float* row = s_acc + (warp * 16 + (lane >> 2)) * dvp + col;
        for (int i = 1; i < kg; ++i) {
          const float* other = row + i * 16 * dvp;
          acc[j][0] = __fadd_rn(acc[j][0], other[0]);
          acc[j][1] = __fadd_rn(acc[j][1], other[1]);
          acc[j][2] = __fadd_rn(acc[j][2], other[8 * dvp]);
          acc[j][3] = __fadd_rn(acc[j][3], other[8 * dvp + 1]);
        }
      }
    }
  }

  // epilogue: out = acc * recip(max(l, 1e-30)), or this split's (m, l, acc)
  if (!active) return;
  const bool split = p.splits > 1;
  bf16* obase = static_cast<bf16*>(p.out) + (int64_t)b * p.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const int qi = qt * p.tq + r % p.tq;
    if (r >= M || qi >= p.Sq) continue;
    const int h = kvh * p.g + r / p.tq;
    if (split) {
      const int64_t w = ws_row(p, bt.sp, b, h, qi);
      if ((lane & 3) == 0) {
        p.ws_ml[2 * w] = m_r[half];
        p.ws_ml[2 * w + 1] = l_r[half];
      }
#pragma unroll
      for (int j = 0; j < kTcMaxD / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (j < nv && col < p.Dv)
          *reinterpret_cast<float2*>(p.ws_acc + w * p.Dv + col) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      }
    } else {
      const float rc = table_recip(fmaxf(l_r[half], 1e-30f), s_rec, tr);
      bf16* orow = obase + h * p.o_sh + (int64_t)qi * p.o_ss;
#pragma unroll
      for (int j = 0; j < kTcMaxD / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (j < nv && col < p.Dv)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(__fmul_rn(acc[j][2 * half], rc),
                        __fmul_rn(acc[j][2 * half + 1], rc));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The splits' combine: one block per (batch, query head, query position).
// m = max_s m_s; c_s = exp2neg((m - m_s) * LOG2E); l = sum_s l_s c_s and
// acc = sum_s acc_s c_s in split order; out = acc * recip(max(l, 1e-30)).
// The c_s and l_s c_s are formed in parallel, the sums in order.

constexpr int kMaxSplits = 512;

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
flash_attn_combine(const FlashParams p) {
  using E = Elem<T>;
  __shared__ float s_c[kMaxSplits], s_lc[kMaxSplits];
  __shared__ float s_m, s_rc;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int qi = row % p.Sq, h = (row / p.Sq) % p.H, b = row / (p.Sq * p.H);
  const int64_t rows = (int64_t)p.B * p.H * p.Sq;
  const int64_t w0 = ((int64_t)b * p.H + h) * p.Sq + qi;
  if (tid < 32) {
    float m = kMFloor;  // every m_s >= M_FLOOR
    for (int s = tid; s < p.splits; s += 32)
      m = fmaxf(m, p.ws_ml[2 * (s * rows + w0)]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    if (tid == 0) s_m = m;
  }
  __syncthreads();
  for (int s = tid; s < p.splits; s += blockDim.x) {
    const int64_t w = s * rows + w0;
    const float c = table_exp_neg(
        __fmul_rn(__fsub_rn(s_m, p.ws_ml[2 * w]), kLog2e), p.rom_e, p.te);
    s_c[s] = c;
    s_lc[s] = __fmul_rn(p.ws_ml[2 * w + 1], c);
  }
  __syncthreads();
  if (tid == 0) {
    float l = 0.0f;
    for (int s = 0; s < p.splits; ++s) l = __fadd_rn(l, s_lc[s]);
    s_rc = table_recip(fmaxf(l, 1e-30f), p.rom_r, p.tr);
  }
  __syncthreads();
  T* orow = static_cast<T*>(p.out) + (int64_t)b * p.o_sb + h * p.o_sh +
            (int64_t)qi * p.o_ss;
  for (int d = tid; d < p.Dv; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < p.splits; ++s)
      acc = __fadd_rn(acc, __fmul_rn(p.ws_acc[(s * rows + w0) * p.Dv + d],
                                     s_c[s]));
    orow[d] = E::put(__fmul_rn(acc, s_rc));
  }
}

// ---------------------------------------------------------------------------
// Host side.

template <typename T>
size_t smem_bytes(const FlashParams& p) {
  const int epw = Elem<T>::epw;
  const int M = p.g * p.tq, wq = p.D / epw, ks = wq + ((wq & 1) ? 0 : 1);
  const size_t words = (size_t)M * p.D + (size_t)kBK * ks +
                       (size_t)kBK * (p.Dv / epw) + (size_t)M * (kBK + 1) +
                       4 * (size_t)M + kBK + (size_t)slot_words(p.te) +
                       (size_t)slot_words(p.tr) + 4;
  return words * 4;
}

size_t smem_bytes_tc(const FlashParams& p) {
  const size_t elems = (size_t)kQPlanes * kRows * tc_stride(p.D) +
                       2 * (size_t)kBK * (tc_stride(p.D) + tc_stride(p.Dv));
  const size_t words = 2 * (size_t)kBK + kRows + 2 * 4 * 16 +
                       (size_t)p.per + 4 + (size_t)slot_words(p.te) +
                       (size_t)slot_words(p.tr);
  return elems * 2 + words * 4;
}

template <typename K>
int launch_body(K kernel, int threads, size_t smem, const FlashParams& p,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {  // past a block's limit: refuse the launch
    cudaGetLastError();       // and leave no error for the next launch
    return (int)err;
  }
  dim3 grid(p.n_qt * p.splits, p.KVH, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const FlashParams& p, bool tc, cudaStream_t stream) {
  int rc = tc ? launch_body(flash_attn_kernel_tc, kTcThreads,
                            smem_bytes_tc(p), p, stream)
              : launch_body(flash_attn_kernel<T>, kThreads, smem_bytes<T>(p),
                            p, stream);
  if (rc != 0 || p.splits == 1) return rc;
  flash_attn_combine<T><<<p.B * p.H * p.Sq, kTcThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fill the shape and stride fields, check the tables and the workspace,
// launch on the dtype (0 = float32, 1 = bfloat16; q, k, v and out share it).
int run(FlashParams& p, const int64_t* strides12, const int32_t* dims10,
        int dtype, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  p.q_sb = strides12[0]; p.q_sh = strides12[1]; p.q_ss = strides12[2];
  p.k_sb = strides12[3]; p.k_sh = strides12[4]; p.k_ss = strides12[5];
  p.v_sb = strides12[6]; p.v_sh = strides12[7]; p.v_ss = strides12[8];
  p.o_sb = strides12[9]; p.o_sh = strides12[10]; p.o_ss = strides12[11];
  p.B = dims10[0]; p.H = dims10[1]; p.KVH = dims10[2]; p.Sq = dims10[3];
  p.Sk = dims10[4]; p.D = dims10[5]; p.Dv = dims10[6]; p.tq = dims10[7];
  p.splits = dims10[8];
  p.g = p.H / p.KVH;
  if (!table_args_ok(p.te) || !table_args_ok(p.tr))
    return (int)cudaErrorInvalidValue;
  if (p.B == 0 || p.Sq == 0) return 0;
  const int n_kt = (p.Sk + kBK - 1) / kBK;
  if (p.splits < 1 || p.splits > kMaxSplits || p.g * p.tq > kRows ||
      (p.splits > 1 && (p.ws_ml == nullptr || p.ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  p.n_qt = (p.Sq + p.tq - 1) / p.tq;
  p.per = n_kt > 0 ? (n_kt + p.splits - 1) / p.splits : 0;
  if (p.splits > 1 && (int64_t)(p.splits - 1) * p.per >= n_kt)
    return (int)cudaErrorInvalidValue;  // an empty split
  const bool a16 = p.D % 8 == 0 && p.Dv % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.v) & 15) == 0;
  bool s16 = true;  // q, k and v rows 16-byte aligned: 16-byte copies
  for (int i = 0; i < 9; ++i) s16 = s16 && strides12[i] % 8 == 0;
  p.vec16 = a16 && s16;
  if (dtype == 0) return launch<float>(p, false, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, p.D <= kTcMaxD && p.Dv <= kTcMaxD,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides12: (b, h, s) element strides of q, k, v, out; dims10: B, H, KVH,
// Sq, Sk, D, Dv, tq, kv splits, 0; ws_ml / ws_acc: the (splits, B, H, Sq,
// 2) and (splits, B, H, Sq, Dv) float32 workspace when splits > 1 (else
// null); exp12 / rec12, dp: see datapath.cuh `table_args`; dtype: 0 =
// float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int repro_flash_attn_lib(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int32_t* q_pos,
                                    const int32_t* kv_pos,
                                    const int32_t* rom, const int32_t* dp,
                                    const int32_t* exp12,
                                    const int32_t* rec12, void* ws_ml,
                                    void* ws_acc,
                                    const int64_t* strides12,
                                    const int32_t* dims10, int causal,
                                    int window, float scale, int dtype,
                                    int device, void* stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_pos = q_pos; p.kv_pos = kv_pos; p.rom_e = rom; p.rom_r = rom;
  p.ws_ml = static_cast<float*>(ws_ml);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.causal = causal; p.window = window; p.scale = scale;
  p.te = table_args(exp12, dp);
  p.tr = table_args(rec12, dp);
  return run(p, strides12, dims10, dtype, device, stream);
}

// The per-table entry: positions by index (causal: query row i sees keys
// j <= i), no window, H == KVH and D == Dv in dims10; exp_coeffs and
// rec_coeffs are two designs' own (2^R, 3) int32 rows, exp12 / rec12 their
// rows (row0 0, rows 2^R, no segment table).
extern "C" int repro_flash_attn_tab(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int32_t* exp_coeffs,
                                    const int32_t* exp12,
                                    const int32_t* rec_coeffs,
                                    const int32_t* rec12, void* ws_ml,
                                    void* ws_acc,
                                    const int64_t* strides12,
                                    const int32_t* dims10, int causal,
                                    float scale, int dtype, int device,
                                    void* stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_pos = nullptr; p.kv_pos = nullptr;
  p.rom_e = exp_coeffs; p.rom_r = rec_coeffs;
  p.ws_ml = static_cast<float*>(ws_ml);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.causal = causal; p.window = -1; p.scale = scale;
  p.te = table_args(exp12, nullptr);
  p.tr = table_args(rec12, nullptr);
  return run(p, strides12, dims10, dtype, device, stream);
}
