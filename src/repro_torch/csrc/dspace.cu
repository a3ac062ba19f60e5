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
// repro/kernels/dspace/ops.py `_dd_max_rows` (l.76): per row,
// max_{x<y} (g[y]-h[x])/(y-x). In the reference it is jnp glue inside the
// same jitted program (no Pallas kernel); in eager PyTorch its loop over
// ~2n deltas would launch a few kernels per delta, so it is a kernel here.
//
// Bound on an H100: operations. Each (center, offset) step of the envelope
// kernel does four IEEE float32 divides against a few bytes of input per
// row, and each (x, delta) pair of dd_max_rows one; a divide runs one
// MUFU reciprocal plus its Newton and rounding fix-up, so the divides set
// the time. Design: one block per (row, tile of centers), one thread per
// center, a loop over the offset that stops where the pair leaves the row
// (the reference's 3n zero padding, TILE and +-2^30 pad lanes are TPU
// layout: a pair that leaves the row contributes nothing, which is what
// those pads achieve). The row's L and U are staged in shared memory while
// they fit, else read through the read-only cache. dd_max_rows spreads a
// row's deltas over several blocks, reduces within the block and merges
// blocks with an atomic float max (max is order-independent, so the result
// does not depend on the merge order).
//
// Bit parity with the reference: every operation is an IEEE add, subtract
// or divide of small integers held in float32, in the reference's order,
// with explicitly rounded intrinsics so nvcc cannot contract or replace a
// divide by a reciprocal multiply; min and max are order-independent.
#include <cstdint>
#include <cuda_runtime.h>

#include "datapath.cuh"

using namespace repro;

namespace {

constexpr float kBig = 3.4e38f;
// dynamic shared memory a block may stage (H100: 227 KiB per block)
constexpr size_t kMaxStage = 160 * 1024;

__global__ void envelopes_parity_kernel(const float* __restrict__ L,
                                        const float* __restrict__ U, int n,
                                        int staged, float* __restrict__ me,
                                        float* __restrict__ mo,
                                        float* __restrict__ be,
                                        float* __restrict__ bo) {
  extern __shared__ float s_row[];
  const int64_t row = blockIdx.x;
  const float* lr = L + row * n;
  const float* ur = U + row * n;
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_row[i] = __ldg(lr + i);
      s_row[n + i] = __ldg(ur + i);
    }
    __syncthreads();
    lr = s_row;
    ur = s_row + n;
  }
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float m_e = kBig, m_o = kBig, b_e = -kBig, b_o = -kBig;
  const int e_even = min(j, n - 1 - j);  // even pairs: e in [1, e_even]
  const int e_odd = min(j, n - 2 - j);   // odd pairs: e in [0, e_odd]
  for (int e = 0; e <= e_even; ++e) {
    const float l_lo = lr[j - e];
    const float u_lo = ur[j - e];
    if (e >= 1) {
      const float d = 2.0f * (float)e;
      const float up =
          __fdiv_rn(__fsub_rn(__fadd_rn(ur[j + e], 1.0f), l_lo), d);
      const float dn =
          __fdiv_rn(__fsub_rn(__fsub_rn(lr[j + e], u_lo), 1.0f), d);
      m_e = fminf(m_e, up);
      b_e = fmaxf(b_e, dn);
    }
    if (e <= e_odd) {
      const float d = __fadd_rn(2.0f * (float)e, 1.0f);
      const float up =
          __fdiv_rn(__fsub_rn(__fadd_rn(ur[j + 1 + e], 1.0f), l_lo), d);
      const float dn =
          __fdiv_rn(__fsub_rn(__fsub_rn(lr[j + 1 + e], u_lo), 1.0f), d);
      m_o = fminf(m_o, up);
      b_o = fmaxf(b_o, dn);
    }
  }
  const int64_t o = row * n + j;
  me[o] = m_e;
  mo[o] = m_o;
  be[o] = b_e;
  bo[o] = b_o;
}

// Float max through integer atomics: a non-negative float orders like its
// int bits, a negative one inversely like its unsigned bits.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void dd_max_rows_kernel(const float* __restrict__ g,
                                   const float* __restrict__ h, int t,
                                   int staged, float* __restrict__ out) {
  extern __shared__ float s_gh[];
  __shared__ float s_warp[32];
  const int64_t row = blockIdx.x;
  const float* gr = g + row * t;
  const float* hr = h + row * t;
  if (staged) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      s_gh[i] = __ldg(gr + i);
      s_gh[t + i] = __ldg(hr + i);
    }
    __syncthreads();
    gr = s_gh;
    hr = s_gh + t;
  }
  float best = -kBig;
  for (int delta = 1 + blockIdx.y; delta < t; delta += gridDim.y) {
    const float d = (float)delta;
    for (int x = threadIdx.x; x < t - delta; x += blockDim.x)
      best = fmaxf(best, __fdiv_rn(__fsub_rn(gr[x + delta], hr[x]), d));
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    best = lane < n_warps ? s_warp[lane] : -kBig;
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) atomic_max_float(out + row, best);
  }
}

// Stage `bytes` of a row in dynamic shared memory if they fit; returns the
// dynamic shared memory to launch with (0: read from global memory).
template <typename Kernel>
cudaError_t stage_bytes(Kernel kernel, size_t bytes, size_t* smem) {
  *smem = 0;
  if (bytes > kMaxStage) return cudaSuccess;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  *smem = bytes;
  return cudaSuccess;
}

}  // namespace

// L, U: (rows, n) float32, contiguous; me, mo, be, bo: (rows, n) float32.
extern "C" int repro_envelopes_parity(const float* L, const float* U,
                                      int64_t rows, int n, float* me,
                                      float* mo, float* be, float* bo,
                                      int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || n == 0) return 0;
  size_t smem = 0;
  err = stage_bytes(envelopes_parity_kernel, (size_t)2 * n * sizeof(float),
                    &smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  const dim3 grid((unsigned)rows, (unsigned)((n + threads - 1) / threads));
  envelopes_parity_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      L, U, n, smem > 0, me, mo, be, bo);
  return (int)cudaGetLastError();
}

// g, h: (rows, t) float32, contiguous; out: (rows,) float32, which the
// caller fills with -3.4e38 before the launch (blocks merge into it).
extern "C" int repro_dd_max_rows(const float* g, const float* h, int64_t rows,
                                 int t, float* out, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || t < 2) return 0;
  size_t smem = 0;
  err = stage_bytes(dd_max_rows_kernel, (size_t)2 * t * sizeof(float), &smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // enough blocks for four per SM, each a strided share of the deltas
  int64_t splits = ((int64_t)4 * sms + rows - 1) / rows;
  if (splits > t - 1) splits = t - 1;
  if (splits > 65535) splits = 65535;
  const int threads = t >= 256 ? 256 : ((t + 31) / 32) * 32;
  const dim3 grid((unsigned)rows, (unsigned)splits);
  dd_max_rows_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      g, h, t, smem > 0, out);
  return (int)cudaGetLastError();
}
