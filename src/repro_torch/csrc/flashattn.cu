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
// Bound on an H100: decode (one query per slot against the cache) is bound
// by the K/V bytes of the live cache rows; causal prefill at Sq = 512 by its
// q/k/v/out bytes and, far below the bf16 tensor-core rate, by the f32 FMA
// work this first version does. Design: one block per (batch, KV head,
// query tile) serves all g = H / KVH query heads of the group, so each K/V
// tile is read once per group, not once per query head (GQA index
// b*H + h -> KV stripe b*KVH + h / g). K/V stream through shared memory in
// 64-key tiles (the reference kept the whole stripe resident in VMEM); the
// score product and P.V are f32 FMAs on CUDA cores; the two table slots
// (with a segmented slot's packed segment table and leaf datapath rows) are
// staged in shared memory and read with indexed loads.
// Tensors are read and written in place through their strides, so the
// caller's (B, S, H, D) layout and the cache's (B, KVH, S, D) layout need no
// copies.
#include <climits>

#include <cuda_bf16.h>

#include "datapath.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;       // keys per tile
constexpr int kMaxAcc = 32;   // accumulators per thread: rows * Dv <= 8192
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
  // element strides of (batch, head, position); the last dim is contiguous
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int B, H, KVH, Sq, Sk, D, Dv, g, tq;
  int causal, window;  // window < 0: no sliding window
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const FlashParams p) {
  using E = Elem<T>;
  constexpr int EPW = E::epw;
  extern __shared__ uint32_t smem[];
  const int M = p.g * p.tq;  // query rows of this block
  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
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
  const int n_kt = (p.Sk + kBK - 1) / kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int jn = min(kBK, p.Sk - k0);  // keys of this tile
    for (int j = tid; j < kBK; j += kThreads)
      s_kp[j] = j >= jn ? -1
                : p.kv_pos ? p.kv_pos[(int64_t)b * p.Sk + k0 + j] : k0 + j;
    __syncthreads();
    if (warp == 0) {  // tile liveness, as the reference's chunk_live
      int any = 0, kmin = INT_MAX, kmax = INT_MIN;
      for (int j = lane; j < jn; j += 32) {
        const int kp = s_kp[j];
        any |= kp >= 0;
        if (kp >= 0) kmin = min(kmin, kp);
        kmax = max(kmax, kp);
      }
      any = __any_sync(~0u, any);
      kmin = warp_min_i(kmin);
      kmax = warp_max_i(kmax);
      if (lane == 0) {
        bool need = any != 0;
        if (p.causal) need = need && kmin <= s_flag[0];
        if (p.window >= 0)
          need = need && (int64_t)kmax > (int64_t)s_flag[1] - p.window;
        s_flag[2] = need;
      }
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

  // epilogue: out = acc * recip(max(l, 1e-30))
  for (int r = tid; r < M; r += kThreads)
    s_corr[r] = table_recip(fmaxf(s_l[r], 1e-30f), s_rec, tr);
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
        obase[h * p.o_sh + (int64_t)qi * p.o_ss + d] =
            E::put(__fmul_rn(acc[i], s_corr[r]));
      }
    }
  }
}

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

template <typename T>
int launch(const FlashParams& p, int n_qt, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_qt, p.KVH, p.B);
  flash_attn_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fill the shape and stride fields, check the tables, launch on the dtype
// (0 = float32, 1 = bfloat16; q, k, v and out share it).
int run(FlashParams& p, const int64_t* strides12, const int32_t* dims8,
        int dtype, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  p.q_sb = strides12[0]; p.q_sh = strides12[1]; p.q_ss = strides12[2];
  p.k_sb = strides12[3]; p.k_sh = strides12[4]; p.k_ss = strides12[5];
  p.v_sb = strides12[6]; p.v_sh = strides12[7]; p.v_ss = strides12[8];
  p.o_sb = strides12[9]; p.o_sh = strides12[10]; p.o_ss = strides12[11];
  p.B = dims8[0]; p.H = dims8[1]; p.KVH = dims8[2]; p.Sq = dims8[3];
  p.Sk = dims8[4]; p.D = dims8[5]; p.Dv = dims8[6]; p.tq = dims8[7];
  p.g = p.H / p.KVH;
  if (!table_args_ok(p.te) || !table_args_ok(p.tr))
    return (int)cudaErrorInvalidValue;
  if (p.B == 0 || p.Sq == 0) return 0;
  const int n_qt = (p.Sq + p.tq - 1) / p.tq;
  if (dtype == 0) return launch<float>(p, n_qt, (cudaStream_t)stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, n_qt, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides12: (b, h, s) element strides of q, k, v, out; dims8: B, H, KVH,
// Sq, Sk, D, Dv, tq; exp12 / rec12, dp: see datapath.cuh `table_args`;
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int repro_flash_attn_lib(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int32_t* q_pos,
                                    const int32_t* kv_pos,
                                    const int32_t* rom, const int32_t* dp,
                                    const int32_t* exp12,
                                    const int32_t* rec12,
                                    const int64_t* strides12,
                                    const int32_t* dims8, int causal,
                                    int window, float scale, int dtype,
                                    int device, void* stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_pos = q_pos; p.kv_pos = kv_pos; p.rom_e = rom; p.rom_r = rom;
  p.causal = causal; p.window = window; p.scale = scale;
  p.te = table_args(exp12, dp);
  p.tr = table_args(rec12, dp);
  return run(p, strides12, dims8, dtype, device, stream);
}

// The per-table entry: positions by index (causal: query row i sees keys
// j <= i), no window, H == KVH and D == Dv in dims8; exp_coeffs and
// rec_coeffs are two designs' own (2^R, 3) int32 rows, exp12 / rec12 their
// rows (row0 0, rows 2^R, no segment table).
extern "C" int repro_flash_attn_tab(const void* q, const void* k,
                                    const void* v, void* out,
                                    const int32_t* exp_coeffs,
                                    const int32_t* exp12,
                                    const int32_t* rec_coeffs,
                                    const int32_t* rec12,
                                    const int64_t* strides12,
                                    const int32_t* dims8, int causal,
                                    float scale, int dtype, int device,
                                    void* stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_pos = nullptr; p.kv_pos = nullptr;
  p.rom_e = exp_coeffs; p.rom_r = rec_coeffs;
  p.causal = causal; p.window = -1; p.scale = scale;
  p.te = table_args(exp12, nullptr);
  p.tr = table_args(rec12, nullptr);
  return run(p, strides12, dims8, dtype, device, stream);
}
