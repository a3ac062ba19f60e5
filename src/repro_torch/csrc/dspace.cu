// The paper's §II envelope computation for the design-space generator.
//
// envelopes_parity replaces repro/kernels/dspace/kernel.py
// `envelopes_parity` (l.99), `envelopes_parity_fleet` (l.123) and
// `envelopes_parity_batched` (l.150), which all run `_parity_reduce`
// (l.33): per row of integer bounds L, U of width n and per center j,
//
//   m_even[j] = min_{e>=1} (U[j+e]+1-L[j-e]) / (2e)     (t = 2j)
//   M_even[j] = max_{e>=1} (L[j+e]-U[j-e]-1) / (2e)
//   m_odd[j]  = min_{e>=0} (U[j+1+e]+1-L[j-e]) / (2e+1) (t = 2j+1)
//   M_odd[j]  = max_{e>=0} (L[j+1+e]-U[j-e]-1) / (2e+1)
//
// in float32, with +-3.4e38 where no pair exists. The three TPU entry
// points differ only in their grid; here one kernel takes any number of
// (rows, n) rows, and the three Python wrappers launch it.
//
// dd_max_rows is the Eqns 7-8 a-interval reduction of
// repro/kernels/dspace/ops.py `_dd_max_rows` (l.79): per row,
// max_{x<y} (g[y]-h[x])/(y-x). In the reference it is jnp glue inside the
// same jitted program (no Pallas kernel); in eager PyTorch its loop over
// ~2n deltas would launch a few kernels per delta, so it is a kernel here.
// The reference runs it twice per region batch, a_lo = dd(M, m) and
// a_hi = -dd(-m, -M); since RN(-m[y] - (-M[x])) = RN(M[x] - m[y]) exactly,
// one launch of the two-sided instance computes both from the same rows.
//
// Bound on an H100: operations. The envelope kernel does, per (center,
// offset) step, two pairs of divided differences against a few bytes per
// row; dd_max_rows one subtraction and one max per (x, delta) pair and side
// (the max issues on the ALU pipe, at half the FP32 rate).
//
// Envelope design. The (center, offset) work of a row is a triangle: the
// center j has min(j, n-1-j) offsets. A block takes a tile of 32 centers
// (one per lane) and one group of the offset range; its 8 warps split the
// group into equal chunks, so no thread walks more than kChain offsets for
// rows up to n = 16384 (8 groups of kWarps * kChain offsets; wider rows take
// longer chains). The windows a block stages grow with its group, not with
// n: rows up to kStagedN = 2^16 stage them in shared memory; wider rows
// (none the generator makes) read L and U through the read-only cache and
// divide with __fdiv_rn, the reciprocal table no longer fitting. Up to 8
// groups of one tile form a thread block cluster, and the
// cluster's first block merges the others' partial minima and maxima
// through distributed shared memory (min and max do not depend on order):
// one launch, no atomics, no output fill. Each block stages only the two
// windows of L and U its tile reads (cp.async), and the odd pair's high
// operands at offset e are carried in registers into the even pair at e+1
// (four shared loads per step, not six).
//
// No IEEE divide per pair. Each quotient q = RN(N / d), d = 2e or 2e+1,
// comes from r = RN(1/d), which depends on the offset only: a table of
// (r_even, r_odd, d_even, d_odd) per offset, computed once per block with
// __frcp_rn, gives it to every lane in one broadcast load. Then
//
//   q0 = RN(N * r),  rem = RN(N - d * q0) (FMA),  q = RN(q0 + rem * r) (FMA)
//
// and q = RN(N / d), bit for bit the IEEE quotient, for every float32 N
// with 2^-100 <= |N| < 2^100 (or N = 0) and every integer d in [1, 2^22).
// Proof. Signs are symmetric and powers of two scale every step exactly,
// so take x = N/d in [1, 2), u = 2^-24 (ulp(x) = 2u).
//  1. r = (1/d)(1 + a) with |a| <= u (round to nearest), so N * r =
//     x(1 + a) lies within 2u of x, and q0 within 3u of x (half an ulp of
//     rounding more, at most u in [1, 2), less below 1).
//  2. rem is exact: N is a multiple of ulp(N) >= ulp(x) (N = x d with
//     d >= 1), d q0 a multiple of ulp(q0) >= u, so N - d q0 = k u with
//     |k| <= d |x - q0| / u < 3d < 2^24: a float, and the FMA returns it.
//  3. q0 + rem * r = q0 + d (x - q0)(1 + a)/d = x + (x - q0) a, within
//     3u * u = 3u^2 of x, and the last FMA rounds that sum once.
//  4. x is no midpoint of two floats: x = (2k+1) u would need
//     N = (2k+1) d u, whose odd part (2k+1) * odd(d) >= 2^24 + 1 does not
//     fit 24 bits. And x lies at least u/d from every midpoint m: N and
//     m d are multiples of u, so N - m d != 0 is at least u. Since
//     u/d > 3u^2 for d < 2^24/3, no midpoint lies between x and
//     x + (x - q0) a, so q = RN(x + (x - q0) a) = RN(x). (x = 1 exactly:
//     3u^2 is far below the half ulps u/2 and u around 1.)
//  The range keeps every quantity normal (N integer-valued, as the
//  generator's bounds are, satisfies it); staged rows have d <= 2^16.
// The minimum and maximum of these quotients are then those of the IEEE
// quotients, in any order: bitwise the plain version and the reference.
//
// dd_max_rows design. For a fixed delta > 0, division by delta is
// monotone and so is rounding: max_x RN(RN(g[x+delta] - h[x]) / delta) =
// RN(max_x RN(g[x+delta] - h[x]) / delta). So the kernel takes the max of
// the float32 numerators over x and divides once per (thread, delta).
// Each lane owns D = 8 consecutive deltas over a contiguous run of x (an
// odd run length, so the lanes' shared loads fall in distinct banks) and
// keeps the 8 values g[x+delta] (and h[x+delta]) in a register window:
// each step loads 4 words for 16 (two-sided) pairs. A warp takes a delta
// block and its mirror (lengths t - delta and delta: t in all), and the
// warps of a row's blocks share its blocks. The C entry fills the outputs
// with the reference's empty-loop values (a_lo -3.4e38, a_hi 3.4e38), and
// each block merges its result into them with order-free float atomics.
// Every block of a row does the same work, so the blocks a row get take
// the busiest SM's block count into account. Past the row the staged rows
// read -inf (g) and +inf (h), so such pairs are -inf and lose every max.
#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "datapath.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kMaxCluster = 8;  // the portable thread block cluster size
constexpr int kMaxSplit = 16;   // dd_max_rows blocks a row, at most
// dynamic shared memory a block may stage (H100: 227 KiB per block)
constexpr size_t kMaxStage = 200 * 1024;

// Order-free float max / min through integer atomics: a float whose sign
// bit is clear orders like its int bits, one whose sign bit is set
// inversely like its unsigned bits (-0 below +0).
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// ---------------------------------------------------------------- envelope

constexpr int kTile = 32;   // centers of a block, one per lane
constexpr int kWarps = 8;   // warps of an envelope block
constexpr int kChain = 128; // offsets a thread walks (n <= 16384), at most
constexpr int kStagedN = 1 << 16;  // widest row staged (and divided by r)

struct Recip {
  float r_even, r_odd, d_even, d_odd;  // RN(1/2e), RN(1/(2e+1)), 2e, 2e+1
};

// RN(num / d) for an integer d in [1, 2^22) from r = RN(1/d): the proof is
// in the header. Rows wider than kStagedN have no table: the IEEE divide.
template <bool STAGED>
__device__ __forceinline__ float div_by(float num, float d, float r) {
  if (!STAGED) return __fdiv_rn(num, d);
  const float q0 = __fmul_rn(num, r);
  const float rem = __fmaf_rn(-d, q0, num);
  return __fmaf_rn(rem, r, q0);
}

// A bound from a staged window, or through the read-only cache.
template <bool STAGED>
__device__ __forceinline__ float bound(const float* p) {
  return STAGED ? *p : __ldg(p);
}

// Where one block's shared memory goes, for `group` offsets a block: the
// partial results, then (staged) the reciprocal table and four windows.
struct EnvLayout {
  int group, win;  // offsets a block; words of each staged window
  __host__ __device__ explicit EnvLayout(int g)
      : group(g), win(kTile + g + 1) {}
  __host__ __device__ size_t bytes(bool staged) const {
    const size_t merge = (4 * kWarps * kTile + 4 * kTile) * sizeof(float);
    if (!staged) return merge;
    return merge + (size_t)group * sizeof(Recip) +
           (size_t)4 * win * sizeof(float);
  }
};

// One (center, offset) step; EVEN / ODD say which pairs exist at e.
template <bool EVEN, bool ODD, bool STAGED>
__device__ __forceinline__ void env_step(
    int e, int j, const Recip* tab, const float* llo, const float* ulo,
    const float* lhi, const float* uhi, float& ue1, float& le, float& m_e,
    float& m_o, float& b_e, float& b_o) {
  const float de = 2.0f * (float)e;
  const Recip rc = STAGED ? tab[e] : Recip{0.0f, 0.0f, de, de + 1.0f};
  const float l_lo = bound<STAGED>(llo + j - e);
  const float u_lo = bound<STAGED>(ulo + j - e);
  if (EVEN) {  // (j-e, j+e): U[j+e]+1 and L[j+e] carried from step e-1
    m_e = fminf(m_e, div_by<STAGED>(__fsub_rn(ue1, l_lo), rc.d_even,
                                    rc.r_even));
    b_e = fmaxf(b_e, div_by<STAGED>(__fsub_rn(__fsub_rn(le, u_lo), 1.0f),
                                    rc.d_even, rc.r_even));
  }
  if (ODD) {  // (j-e, j+1+e)
    const float l1 = bound<STAGED>(lhi + j + 1 + e);
    const float u1 = __fadd_rn(bound<STAGED>(uhi + j + 1 + e), 1.0f);
    m_o = fminf(m_o, div_by<STAGED>(__fsub_rn(u1, l_lo), rc.d_odd,
                                    rc.r_odd));
    b_o = fmaxf(b_o, div_by<STAGED>(__fsub_rn(__fsub_rn(l1, u_lo), 1.0f),
                                    rc.d_odd, rc.r_odd));
    ue1 = u1;
    le = l1;
  }
}

// grid: (tiles * rows, 1, groups), clusters of (1, 1, groups); `group`
// offsets a block. STAGED: the windows and the reciprocal table in shared
// memory (n <= kStagedN).
template <bool STAGED>
__global__ void __launch_bounds__(kTile* kWarps)
    envelopes_parity_kernel(const float* __restrict__ L,
                            const float* __restrict__ U, int n, int tiles,
                            int group, float* __restrict__ me,
                            float* __restrict__ mo, float* __restrict__ be,
                            float* __restrict__ bo) {
  extern __shared__ float4 s_env[];
  const EnvLayout lay(group);
  float* part = reinterpret_cast<float*>(s_env);  // [4][kWarps][kTile]
  float* red = part + 4 * kWarps * kTile;         // [4][kTile]
  Recip* tab = reinterpret_cast<Recip*>(red + 4 * kTile);
  float* w_l = reinterpret_cast<float*>(tab + group);  // low window: L, U
  float* w_u = w_l + lay.win;
  float* w_lh = w_u + lay.win;  // high window: L, U
  float* w_uh = w_lh + lay.win;

  const int64_t row = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const int j_last = min(n, j0 + kTile) - 1;
  // the tile's offsets are e in [0, e_top]; this group's are [gb, ge)
  const int e_top = min(min(j_last, n - 1 - j0), (n - 1) / 2);
  const int gb = blockIdx.z * group;
  const int ge = max(gb, min(e_top + 1, gb + group));
  const float* lr = L + row * n;
  const float* ur = U + row * n;

  // low window: j - e for j in the tile, e in [gb, ge); high window:
  // j + e and j + 1 + e. Only indices inside the row are staged (and read).
  const int lo0 = j0 - ge + 1, hi0 = j0 + gb;
  if (STAGED) {
    const int lo_a = max(0, lo0), lo_b = min(n, j_last - gb + 1);
    const int hi_a = hi0, hi_b = min(n, j_last + ge + 1);
    for (int i = lo_a + (int)threadIdx.x; i < lo_b; i += blockDim.x) {
      cp_async4(smem_addr(w_l + i - lo0), lr + i, 4);
      cp_async4(smem_addr(w_u + i - lo0), ur + i, 4);
    }
    for (int i = hi_a + (int)threadIdx.x; i < hi_b; i += blockDim.x) {
      cp_async4(smem_addr(w_lh + i - hi0), lr + i, 4);
      cp_async4(smem_addr(w_uh + i - hi0), ur + i, 4);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < ge - gb; i += blockDim.x) {
      const int e = gb + i;
      const float de = 2.0f * (float)e, dodd = de + 1.0f;
      tab[i] = Recip{e > 0 ? __frcp_rn(de) : 0.0f, __frcp_rn(dodd), de, dodd};
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  const int lane = threadIdx.x % kTile, warp = threadIdx.x / kTile;
  const int j = j0 + lane;
  float m_e = kBig, m_o = kBig, b_e = -kBig, b_o = -kBig;
  const int chunk = (ge - gb + kWarps - 1) / kWarps;
  const int ea = gb + warp * chunk;
  const int e_ev = min(j, n - 1 - j);   // even pairs: 1 <= e <= e_ev
  const int e_od = min(j, n - 2 - j);   // odd pairs: 0 <= e <= e_od
  const int eb = min(min(ge, ea + chunk), e_ev + 1);
  if (j < n && ea < eb) {
    // windows re-based so that index j - e (low) and j + e (high) read
    // them; unstaged, the row itself
    const float* llo = STAGED ? w_l - lo0 : lr;
    const float* ulo = STAGED ? w_u - lo0 : ur;
    const float* lhi = STAGED ? w_lh - hi0 : lr;
    const float* uhi = STAGED ? w_uh - hi0 : ur;
    const Recip* te = tab - gb;
    float ue1 = __fadd_rn(bound<STAGED>(uhi + j + ea), 1.0f);
    float le = bound<STAGED>(lhi + j + ea);
    int e = ea;
    if (e == 0) {  // no even pair at e = 0
      if (e_od >= 0)
        env_step<false, true, STAGED>(0, j, te, llo, ulo, lhi, uhi, ue1, le,
                                      m_e, m_o, b_e, b_o);
      e = 1;
    }
    const int both = min(eb, e_od + 1);
#pragma unroll 4
    for (; e < both; ++e)
      env_step<true, true, STAGED>(e, j, te, llo, ulo, lhi, uhi, ue1, le,
                                   m_e, m_o, b_e, b_o);
    if (e < eb)  // e = e_ev = e_od + 1: the even pair alone
      env_step<true, false, STAGED>(e, j, te, llo, ulo, lhi, uhi, ue1, le,
                                    m_e, m_o, b_e, b_o);
  }
  part[(0 * kWarps + warp) * kTile + lane] = m_e;
  part[(1 * kWarps + warp) * kTile + lane] = m_o;
  part[(2 * kWarps + warp) * kTile + lane] = b_e;
  part[(3 * kWarps + warp) * kTile + lane] = b_o;
  __syncthreads();
  // threads 0..127: one (output, center) each, over the block's warps
  const int dir = threadIdx.x / kTile;
  float v = 0.0f;
  if (dir < 4) {
    v = part[dir * kWarps * kTile + lane];
    for (int w = 1; w < kWarps; ++w) {
      const float p = part[(dir * kWarps + w) * kTile + lane];
      v = dir < 2 ? fminf(v, p) : fmaxf(v, p);
    }
  }
  const int groups = gridDim.z;
  if (groups > 1) {  // merge the cluster's groups in its first block
    cg::cluster_group cluster = cg::this_cluster();
    if (dir < 4) red[dir * kTile + lane] = v;
    cluster.sync();
    if (cluster.block_rank() == 0 && dir < 4)
      for (int r = 1; r < groups; ++r) {
        const float p = *cluster.map_shared_rank(red + dir * kTile + lane, r);
        v = dir < 2 ? fminf(v, p) : fmaxf(v, p);
      }
    cluster.sync();  // the other blocks' shared memory stays until read
    if (cluster.block_rank() != 0) return;
  }
  if (dir < 4 && j < n) {
    float* out = dir == 0 ? me : dir == 1 ? mo : dir == 2 ? be : bo;
    out[row * n + j] = v;
  }
}

// ------------------------------------------------------------- dd_max_rows

constexpr int kDeltas = 8;  // deltas a lane owns
constexpr int kDdWarps = 8;

// The two rows a dd_max_rows block reads: staged in shared memory (with
// kDeltas pad words past the row) or read through the read-only cache;
// past the row g reads -inf and h +inf.
template <bool STAGED>
struct DdRows {
  const float* g;
  const float* h;
  int t;
  __device__ __forceinline__ float gv(int i) const {
    if (STAGED) return g[i];
    return i < t ? __ldg(g + i) : -INFINITY;
  }
  __device__ __forceinline__ float hv(int i) const {
    if (STAGED) return h[i];
    return i < t ? __ldg(h + i) : INFINITY;
  }
};

// One lane's run: deltas [d0, d0 + kDeltas), x in [xa, xb); max of the
// numerators per delta, then one divide per delta into lo (and hi).
template <bool TWO, bool STAGED>
__device__ __forceinline__ void dd_run(const DdRows<STAGED>& rows, int d0,
                                       int xa, int xb, float& lo, float& hi) {
  float acc_lo[kDeltas], acc_hi[kDeltas], wg[kDeltas], wh[kDeltas];
#pragma unroll
  for (int i = 0; i < kDeltas; ++i) {
    acc_lo[i] = -INFINITY;
    acc_hi[i] = -INFINITY;
    wg[i] = rows.gv(xa + d0 + i);  // window slot i: x + d0 + i at x = xa
    if (TWO) wh[i] = rows.hv(xa + d0 + i);
  }
  int x = xa;
  for (; x + kDeltas <= xb; x += kDeltas) {
#pragma unroll
    for (int s = 0; s < kDeltas; ++s) {
      // at x + s the window element for delta d0 + i sits in slot (s+i)%D
      const float hx = rows.hv(x + s);
      const float gx = TWO ? rows.gv(x + s) : 0.0f;
#pragma unroll
      for (int i = 0; i < kDeltas; ++i) {
        const int slot = (s + i) % kDeltas;
        acc_lo[i] = fmaxf(acc_lo[i], __fsub_rn(wg[slot], hx));
        if (TWO) acc_hi[i] = fmaxf(acc_hi[i], __fsub_rn(gx, wh[slot]));
      }
      // slot s moves on to the window's last element at x + s + 1
      wg[s] = rows.gv(x + s + d0 + kDeltas);
      if (TWO) wh[s] = rows.hv(x + s + d0 + kDeltas);
    }
  }
  for (; x < xb; ++x) {  // the run's last < kDeltas steps, without a window
    const float hx = rows.hv(x);
    const float gx = TWO ? rows.gv(x) : 0.0f;
#pragma unroll
    for (int i = 0; i < kDeltas; ++i) {
      acc_lo[i] = fmaxf(acc_lo[i], __fsub_rn(rows.gv(x + d0 + i), hx));
      if (TWO)
        acc_hi[i] = fmaxf(acc_hi[i], __fsub_rn(gx, rows.hv(x + d0 + i)));
    }
  }
#pragma unroll
  for (int i = 0; i < kDeltas; ++i) {
    const float d = (float)(d0 + i);
    lo = fmaxf(lo, __fdiv_rn(acc_lo[i], d));
    if (TWO) hi = fmaxf(hi, __fdiv_rn(acc_hi[i], d));
  }
}

// grid: (rows * per_row); a_lo[row] = max_{x<y} RN(g[y]-h[x])/(y-x) and,
// TWO, a_hi[row] = -max RN(g[x]-h[y])/(y-x), merged into a_lo filled with
// -3.4e38 and a_hi with 3.4e38 (dd_fill_kernel).
template <bool TWO, bool STAGED>
__global__ void __launch_bounds__(32 * kDdWarps)
    dd_max_rows_kernel(const float* __restrict__ g,
                       const float* __restrict__ h, int t, int per_row,
                       float* a_lo, float* a_hi) {
  extern __shared__ float s_dd[];
  __shared__ float s_warp[2][kDdWarps];
  const int64_t row = blockIdx.x / per_row;
  const int rank = blockIdx.x % per_row;
  DdRows<STAGED> rows{g + row * t, h + row * t, t};
  if (STAGED) {
    float* sg = s_dd;
    float* sh = s_dd + t + kDeltas;
    copy_words_async(reinterpret_cast<int32_t*>(sg),
                     reinterpret_cast<const int32_t*>(rows.g), t);
    copy_words_async(reinterpret_cast<int32_t*>(sh),
                     reinterpret_cast<const int32_t*>(rows.h), t);
    cp_async_commit();
    for (int i = threadIdx.x; i < kDeltas; i += blockDim.x) {
      sg[t + i] = -INFINITY;
      sh[t + i] = INFINITY;
    }
    cp_async_wait<0>();
    __syncthreads();
    rows.g = sg;
    rows.h = sh;
  }
  float lo = -kBig, hi = -kBig;
  const int lane = threadIdx.x % 32;
  const int blocks = (t - 1 + kDeltas - 1) / kDeltas;  // delta blocks
  const int pairs = (blocks + 1) / 2;  // block b with its mirror
  const int warps = per_row * kDdWarps;
  for (int p = rank * kDdWarps + (int)threadIdx.x / 32; p < pairs;
       p += warps) {
    for (int side = 0; side < 2; ++side) {
      const int b = side ? blocks - 1 - p : p;
      if (side && b == p) break;
      const int d0 = 1 + b * kDeltas;
      const int len = t - d0;  // x run of the block's smallest delta
      const int run = ((len + 31) / 32) | 1;
      const int xa = lane * run, xb = min(len, xa + run);
      if (xa < xb) dd_run<TWO>(rows, d0, xa, xb, lo, hi);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = fmaxf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    if (TWO) hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    s_warp[0][warp] = lo;
    s_warp[1][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kDdWarps; ++w) {
    lo = fmaxf(lo, s_warp[0][w]);
    hi = fmaxf(hi, s_warp[1][w]);
  }
  atomic_max_float(a_lo + row, lo);
  if (TWO) atomic_min_float(a_hi + row, -hi);
}

// The reference's empty-loop values, which the blocks merge into.
__global__ void dd_fill_kernel(float* a_lo, float* a_hi, int64_t rows) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows) return;
  a_lo[i] = -kBig;
  if (a_hi) a_hi[i] = kBig;
}

__global__ void quotient_kernel(const float* __restrict__ num,
                                const float* __restrict__ d, int64_t count,
                                float* __restrict__ q) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < count) q[i] = div_by<true>(num[i], d[i], __frcp_rn(d[i]));
}

// Let `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kernel` in clusters of (cx, 1, cz) blocks.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads,
                            size_t smem, int cx, int cz, void* stream,
                            Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t sm_count(int device, int* sms) {
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <bool TWO>
cudaError_t launch_dd(const float* g, const float* h, int64_t rows, int t,
                      float* a_lo, float* a_hi, int device, void* stream) {
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  dd_fill_kernel<<<(unsigned)((rows + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(a_lo, TWO ? a_hi : nullptr, rows);
  // blocks of a row, p: every block does the same work, so the busiest SM
  // runs ceil(rows p / sms) blocks of 1/p of a row each; take the p (at
  // most kMaxSplit, at least a delta-block pair a warp) that minimises
  // ceil(rows p / sms) / p, the largest of equals (more warps an SM)
  const int64_t pairs = ((t - 1 + kDeltas - 1) / kDeltas + 1) / 2;
  const int64_t p_max = (pairs + kDdWarps - 1) / kDdWarps;
  int64_t per_row = 1, waves = (rows + sms - 1) / sms;
  for (int64_t p = 2; p <= kMaxSplit && p <= p_max; ++p) {
    const int64_t w = (rows * p + sms - 1) / sms;
    if (w * per_row <= waves * p) {
      per_row = p;
      waves = w;
    }
  }
  size_t smem = (size_t)2 * (t + kDeltas) * sizeof(float);
  auto kernel = dd_max_rows_kernel<TWO, true>;
  if (smem > kMaxStage) {  // read through the read-only cache instead
    kernel = dd_max_rows_kernel<TWO, false>;
    smem = 0;
  }
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(rows * per_row), 32 * kDdWarps, smem,
           (cudaStream_t)stream>>>(g, h, t, (int)per_row, a_lo, a_hi);
  return cudaGetLastError();
}

}  // namespace

// L, U: (rows, n) float32, contiguous, integer-valued; me, mo, be, bo:
// (rows, n) float32.
extern "C" int repro_envelopes_parity(const float* L, const float* U,
                                      int64_t rows, int n, float* me,
                                      float* mo, float* be, float* bo,
                                      int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || n == 0) return 0;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  const int offsets = (n - 1) / 2 + 1;  // the widest tile's
  // groups of a tile: chains of at most kChain offsets, and enough blocks
  // for every SM, at most a portable cluster
  const int64_t by_work = (offsets + kWarps * kChain - 1) / (kWarps * kChain);
  const int64_t by_sms = (sms + tiles * rows - 1) / (tiles * rows);
  int64_t groups = by_work > by_sms ? by_work : by_sms;
  groups = groups > kMaxCluster ? kMaxCluster : groups;
  groups = groups > offsets ? offsets : groups;
  const int group = (int)((offsets + groups - 1) / groups);
  const bool staged = n <= kStagedN;
  const size_t smem = EnvLayout(group).bytes(staged);
  return (int)launch_clusters(
      staged ? envelopes_parity_kernel<true> : envelopes_parity_kernel<false>,
      dim3((unsigned)(tiles * rows), 1, (unsigned)groups), kTile * kWarps,
      smem, 1, (int)groups, stream, L, U, n, tiles, group, me, mo, be, bo);
}

// g, h: (rows, t) float32, contiguous, t >= 2; out: (rows,) float32,
// max_{x<y} (g[y]-h[x])/(y-x) per row.
extern "C" int repro_dd_max_rows(const float* g, const float* h, int64_t rows,
                                 int t, float* out, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || t < 2) return 0;
  return (int)launch_dd<false>(g, h, rows, t, out, nullptr, device, stream);
}

// The a-interval of Eqns 7-8 in one launch: M, m: (rows, t) float32,
// contiguous, t >= 2; a_lo = max_{x<y} (M[y]-m[x])/(y-x) and
// a_hi = -max_{x<y} (M[x]-m[y])/(y-x) (= min (m[y]-M[x])/(y-x)), (rows,).
extern "C" int repro_dd_max_rows2(const float* M, const float* m,
                                  int64_t rows, int t, float* a_lo,
                                  float* a_hi, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || t < 2) return 0;
  return (int)launch_dd<true>(M, m, rows, t, a_lo, a_hi, device, stream);
}

// The envelope kernel's quotient of num[i] by the integer d[i] in
// [1, 2^22), elementwise into q: for the tests, which hold it against the
// IEEE divide on the cases its proof turns on.
extern "C" int repro_envelope_quotient(const float* num, const float* d,
                                       int64_t count, float* q, int device,
                                       void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return 0;
  quotient_kernel<<<(unsigned)((count + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(num, d, count, q);
  return (int)cudaGetLastError();
}
