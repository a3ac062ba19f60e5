// library_eval: fused multi-function Figure-1 evaluation.
//
// Replaces repro/kernels/interp/kernel.py `library_eval_2d` /
// `_library_kernel`: element i evaluates function fids[i] on codes[i] by
// reading its (eval_bits, k, sq_trunc, lin_trunc, degree) meta row and ROM
// row fid * r_max + (code >> eval_bits).
//
// Bound on an H100: bytes. Each element reads a 4-byte code (and a 4-byte
// function id, unless one id is passed for every element) and writes a
// 4-byte result, against a handful of integer operations. Design: the whole ROM
// (F * r_max * 3 int32, 6 KiB for the default library) and the meta rows are
// staged once per block in shared memory and read with indexed loads; a
// grid-stride loop with coalesced 4-byte accesses streams the elements.
#include "datapath.cuh"

using namespace repro;

__global__ void library_eval_kernel(const int32_t* __restrict__ codes,
                                    const int32_t* __restrict__ fids,
                                    int fid0,
                                    const int32_t* __restrict__ rom,
                                    const int32_t* __restrict__ meta,
                                    int n_funcs, int r_max,
                                    int32_t* __restrict__ out, int64_t n) {
  extern __shared__ int32_t smem[];
  const int rom_n = n_funcs * r_max * 3;
  int32_t* s_rom = smem;
  int32_t* s_meta = smem + rom_n;
  for (int i = threadIdx.x; i < rom_n; i += blockDim.x) s_rom[i] = rom[i];
  for (int i = threadIdx.x; i < n_funcs * 5; i += blockDim.x)
    s_meta[i] = meta[i];
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int f = fids ? fids[i] : fid0;
    int32_t y = 0;
    if ((unsigned)f < (unsigned)n_funcs) {
      const int32_t* m = s_meta + 5 * f;
      TableArgs t{f * r_max, r_max, m[0], m[1], m[2], m[3], m[4], 0, 0};
      y = lut_rom(s_rom, t, codes[i]);
    }
    out[i] = y;
  }
}

// fids: one id per element, or null to evaluate function fid0 everywhere.
extern "C" int repro_library_eval(const int32_t* codes, const int32_t* fids,
                                  int fid0, const int32_t* rom,
                                  const int32_t* meta, int n_funcs, int r_max,
                                  int32_t* out, int64_t n, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const size_t smem = (size_t)(n_funcs * r_max * 3 + n_funcs * 5) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(library_eval_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  library_eval_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
      codes, fids, fid0, rom, meta, n_funcs, r_max, out, n);
  return (int)cudaGetLastError();
}

// interp_eval: one design's Figure-1 evaluation.
//
// Replaces repro/kernels/interp/kernel.py `interp_eval_2d` / `_interp_kernel`
// (l.366): out[i] = ((a*xs^2 + b*xl + c) >> k) on the design's (2^R, 3)
// int32 coefficients, region = code >> eval_bits. Bound on an H100: bytes
// (a 4-byte code in, a 4-byte result out, a handful of integer operations).
// Design: the coefficients are staged in shared memory while they fit
// (2^R * 12 bytes; read through the cache beyond), a grid-stride loop takes
// any code count; the reference's (rows % 8, 128) tiling is TPU layout.
__global__ void interp_eval_kernel(const int32_t* __restrict__ codes,
                                   const int32_t* __restrict__ coeffs,
                                   TableArgs t, int staged,
                                   int32_t* __restrict__ out, int64_t n) {
  extern __shared__ int32_t smem[];
  const int32_t* rom = coeffs;
  if (staged) {
    for (int i = threadIdx.x; i < t.rows * 3; i += blockDim.x)
      smem[i] = coeffs[i];
    __syncthreads();
    rom = smem;
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = lut_rom(rom, t, codes[i]);
}

extern "C" int repro_interp_eval(const int32_t* codes, const int32_t* coeffs,
                                 int rows, int eval_bits, int k, int sq_trunc,
                                 int lin_trunc, int degree, int32_t* out,
                                 int64_t n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  size_t smem = (size_t)rows * 3 * 4;
  if (smem > 96 * 1024) {
    smem = 0;  // too large to stage: read the coefficients from global
  } else if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(interp_eval_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  const TableArgs t{0, rows, eval_bits, k, sq_trunc, lin_trunc, degree, 0, 0};
  interp_eval_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
      codes, coeffs, t, smem > 0, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
